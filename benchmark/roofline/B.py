"""Kernel B (``csrc/fitter_chol.cu``, the fused Cholesky fit and
reconstruction): in, the raw normals, positions and accumulated colour;
out, the image and the weights. Per cell of the jittered margins grid
~30 operations of features and 170 of the 85 Gram and right-hand-side
sums, per image pixel 60 of the reconstruction (``chip_smoke.py``'s
count)."""

TRACE_NAME = "fit_chol_kernel"


def count(s, config):
    px = s.image_width * s.image_height
    cells = s.n_blocks * s.block_pixels
    planes = 3 * 3 * 4 * px
    out = 3 * 4 * px + s.n_blocks * 30 * 4
    return planes + out, 200 * cells + 60 * px
