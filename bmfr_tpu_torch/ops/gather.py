"""Bilinear tap helpers for the temporal stages (port of
:mod:`bmfr_tpu.ops.gather`; opencl/bmfr.cl:356-381)."""

from __future__ import annotations

import torch

#: Tap offsets (dx, dy) in reference order; the accept bitmask assigns
#: bit ``i`` to ``TAP_OFFSETS[i]`` (opencl/bmfr.cl:359-363, :801-832).
TAP_OFFSETS = ((0, 0), (1, 0), (0, 1), (1, 1))

_INT32_MAX = 2**31 - 1
#: the largest float32 below 2**31
_F32_BELOW_2_31 = 2147483520.0


def floor_int(x):
    """convert_int2_rtn: round toward negative infinity (opencl/bmfr.cl:356),
    with XLA's f32 -> s32 conversion at the edges, on every device: NaN
    -> 0, values at or beyond +-2**31 (+-inf included) saturate to the
    int32 limits. (A bare ``.to(torch.int32)`` maps all of these to
    ``INT_MIN`` on the CPU and saturates on CUDA.)"""
    f = torch.floor(x)
    f = torch.where(torch.isnan(f), 0.0, f)
    i = f.clamp(-(2.0**31), _F32_BELOW_2_31).to(torch.int32)
    return torch.where(f >= 2.0**31, _INT32_MAX, i)


def gather_planes(planes, yi, xi):
    """Gather ``planes[..., yi, xi]`` with clipped indices
    (``gather.py:23-33``). planes: ``[C, H, W]`` (or ``[H, W]``); yi/xi:
    int32 ``[H, W]`` index maps. Out-of-range indices are clipped; mask
    separately with :func:`in_bounds`."""
    H, W = planes.shape[-2:]
    yc = yi.clamp(0, H - 1).long()
    xc = xi.clamp(0, W - 1).long()
    return planes[..., yc, xc]


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
