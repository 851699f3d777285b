"""Block geometry: per-frame jitter offsets and mirrored addressing.

A copy of :mod:`bmfr_tpu.geometry` (which cannot be imported without
JAX): ``BLOCK_OFFSETS``, ``BLOCK_OFFSETS_COUNT``, ``mirror`` and
``frame_offset``. The constants are the reference's device table
(``opencl/bmfr.cl:267-285``); ``mirror`` is ``opencl/bmfr.cl:209-216``.
"""

from __future__ import annotations

import numpy as np

#: Per-frame block-grid jitter offsets (x, y), indexed by ``frame % 16``
#: (opencl/bmfr.cl:267-285, applied at :314-316 and inverted at :718-722).
BLOCK_OFFSETS = np.array(
    [
        [-14, -14],
        [4, -6],
        [-8, 14],
        [8, 0],
        [-10, -8],
        [2, 12],
        [12, -12],
        [-10, 0],
        [12, 14],
        [-8, -16],
        [6, 6],
        [-2, -2],
        [6, -14],
        [-16, 12],
        [14, -4],
        [-6, 4],
    ],
    dtype=np.int32,
)

BLOCK_OFFSETS_COUNT = len(BLOCK_OFFSETS)  # 16


def mirror(index, size):
    """Mirror an out-of-bounds index back into [0, size).

    ``-1 -> 0, -2 -> 1, size -> size-1`` ("symmetric" reflection including
    the edge sample). Only valid when the index is less than one full
    ``size`` out of bounds, like the reference. Works on numpy arrays and
    python ints.
    """
    index = np.asarray(index)
    neg = np.abs(index) - 1
    over = 2 * size - index - 1
    out = np.where(index < 0, neg, np.where(index >= size, over, index))
    return out if out.ndim else out.item()


def frame_offset(frame: int) -> np.ndarray:
    """Block jitter offset (x, y) for a frame (opencl/bmfr.cl:315); the
    kernels and the blockify views read the same table through
    :func:`~bmfr_tpu_torch.ops.blockify.jitter_offset`."""
    return BLOCK_OFFSETS[frame % BLOCK_OFFSETS_COUNT]
