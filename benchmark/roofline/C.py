"""Kernel C (``csrc/householder_direct.cu``, the Householder fit straight
from the planes and the reconstruction): in, the raw normals, positions
and accumulated colour; out, the image and the weights. Per cell of the
jittered margins grid the Householder reflections (per reflection and
row, sigma 2 and, for each trailing column, the dot 2 and the update 3)
and ~40 operations of features, rescale and noise, per image pixel 60 of
the reconstruction (``chip_smoke.py``'s count)."""

TRACE_NAME = "fit_direct_kernel"


def count(s, config):
    px = s.image_width * s.image_height
    cells = s.n_blocks * s.block_pixels
    planes = 3 * 3 * 4 * px
    out = 3 * 4 * px + s.n_blocks * s.feature_count * 3 * 4
    reflections = cells * sum(2 + 5 * (s.buffer_count - 1 - c)
                              for c in range(s.feature_count))
    return planes + out, reflections + 40 * cells + 60 * px
