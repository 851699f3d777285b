"""Kernel D (``csrc/householder_blocks.cu``, the block fitter): in, the
feature blocks; out, the weights and the blocks' min/max. The
Householder reflections (per reflection and block row, sigma 2 and, for
each trailing column, the dot 2 and the update 3) and ~10 operations a
value of the rescale and the noise (``chip_smoke.py``'s count)."""

TRACE_NAME = "fit_blocks_"


def count(s, config):
    F, B = s.feature_count, s.buffer_count
    tmp = s.n_blocks * B * s.block_pixels
    weights = s.n_blocks * F * 3
    mins_maxs = s.n_blocks * s.features_scaled_count * 2
    reflections = s.n_blocks * s.block_pixels * sum(
        2 + 5 * (B - 1 - c) for c in range(F))
    return 4 * (tmp + weights + mins_maxs), reflections + 10 * tmp
