"""Bilinear tap helpers for the temporal stages (port of
:mod:`bmfr_tpu.ops.gather`; opencl/bmfr.cl:356-381)."""

from __future__ import annotations

import torch

#: Tap offsets (dx, dy) in reference order; the accept bitmask assigns
#: bit ``i`` to ``TAP_OFFSETS[i]`` (opencl/bmfr.cl:359-363, :801-832).
TAP_OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1))


def floor_int(x):
    """convert_int2_rtn: round toward negative infinity (opencl/bmfr.cl:356)."""
    return torch.floor(x).to(torch.int32)


def in_bounds(yi, xi, H, W):
    """Screen-bounds validity of a tap (opencl/bmfr.cl:380-381)."""
    return (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)


def bilinear_weights(fx, fy):
    """The four bilinear weights in reference tap order
    (opencl/bmfr.cl:366-370)."""
    return (
        (1.0 - fx) * (1.0 - fy),
        fx * (1.0 - fy),
        (1.0 - fx) * fy,
        fx * fy,
    )
