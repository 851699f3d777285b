"""Bilinear tap engine: the bf16 packs of the recurrent state, the four
gather modes of :func:`gather_taps`, and the clipped row-pair gather
(kernel E) with its plain PyTorch version.

Port of :mod:`bmfr_tpu.ops.warp`. Word ``k`` of a channel-pair pack
holds channel ``2k`` in its low 16 bits and channel ``2k+1`` in its high
16 bits; word ``(y, x)`` of an x-pair pack holds ``S[y, x]`` low and
``S[y, x+1]`` high (the edge value twice at ``x = W-1``), each rounded
to bf16 (nearest-even). The port builds and reads the words through a
bf16 view of the int32 buffer (little-endian: the low half of a word is
the even bf16 element), so no integer shift ever runs on a sign bit.

:func:`warp_rows` replaces the TPU's ``_warp_kernel``
(``bmfr_tpu/ops/warp_pallas.py``, entry ``warp_rows_pallas``). The GPU
has a hardware gather, so the TPU kernel's window plan, fix-up and
whole-frame fallback have no counterpart: kernel E gathers both rows
directly and equals :func:`warp_rows_reference` on every pixel, not only
on the in-bounds taps the JAX kernel promises.
"""

from __future__ import annotations

import torch

from . import _lib
from .gather import TAP_OFFSETS, gather_planes


def _halves(packed):
    """i32 ``[P, ...]`` -> bf16 ``[P, ..., 2]`` view (lo, hi) of the words."""
    return packed.view(torch.bfloat16).view(*packed.shape, 2)


def add_wrap(i, d: int):
    """``i + d`` for int32 ``i`` with two's-complement wrap-around, as
    XLA adds (``INT_MAX + 1 -> INT_MIN``), on every device."""
    return (i.to(torch.int64) + d).to(torch.int32)


def pack_pairs_bf16(planes, out=None):
    """[C, H, W] f32 -> [ceil(C/2), H, W] i32, two bf16 per word.

    ``planes`` may also be a sequence of f32 ``[H, W]`` planes, and
    ``out`` a contiguous i32 ``[ceil(C/2), H, W]`` tensor to write into:
    the pipeline packs the next state in place, channel by channel, with
    no stacked copy."""
    C = len(planes)
    P = (C + 1) // 2
    if out is None:
        out = torch.empty((P,) + tuple(planes[0].shape), dtype=torch.int32,
                          device=planes[0].device)
    halves = _halves(out)
    for k in range(P):
        halves[k, ..., 0].copy_(planes[2 * k])
        if 2 * k + 1 < C:
            halves[k, ..., 1].copy_(planes[2 * k + 1])
        else:
            halves[k, ..., 1].zero_()
    return out


def unpack_pairs_bf16(packed, C):
    """i32 [P, ...] -> f32 [2P (trimmed to C), ...]."""
    halves = _halves(packed.contiguous())
    return halves.movedim(-1, 1).reshape(
        (-1,) + tuple(packed.shape[1:]))[:C].float()


def pack_x_pairs_bf16(planes):
    """[C, H, W] f32 -> [C, H, W] i32 where word (y, x) holds
    (bf16(S[y, x]), bf16(S[y, x+1])), the edge value twice at x = W-1
    (``warp.py:52-62``): one gather fetches both horizontal taps."""
    out = torch.empty(planes.shape, dtype=torch.int32, device=planes.device)
    halves = _halves(out)
    halves[..., 0].copy_(planes)
    halves[..., :-1, 1].copy_(planes[..., 1:])
    halves[..., -1, 1].copy_(planes[..., -1])
    return out


def _lo(words):
    return _halves(words)[..., 0].float()


def _hi(words):
    return _halves(words)[..., 1].float()


def warp_rows_reference(src, iy, ix):
    """Plain PyTorch version of :func:`warp_rows`: the two clipped
    gathers of warp mode ``packed_x_bf16``."""
    return gather_planes(src, iy, ix), gather_planes(src, add_wrap(iy, 1), ix)


def warp_rows(src, iy, ix):
    """Clipped row-pair gather of an x-pair-packed source: ``(row0,
    row1)``, i32 ``[C, H, W]`` each, ``row0 = src[:, clip(iy), clip(ix)]``
    and ``row1 = src[:, clip(iy + 1), clip(ix)]`` (``iy + 1`` wrapping at
    ``INT_MAX`` as XLA's does). ``src``: i32 ``[C, H, W]``; iy/ix: i32
    ``[H, W]``.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`warp_rows_reference`. Any other device raises.
    """
    dev = src.device
    if dev.type == "cpu":
        return warp_rows_reference(src, iy, ix)
    if dev.type != "cuda":
        raise ValueError(f"warp_rows: unsupported device {dev}")
    C, H, W = src.shape
    _lib.check_tensor(src, "src", torch.int32, (C, H, W), dev)
    _lib.check_tensor(iy, "iy", torch.int32, (H, W), dev)
    _lib.check_tensor(ix, "ix", torch.int32, (H, W), dev)
    row0 = torch.empty_like(src)
    row1 = torch.empty_like(src)
    _lib.launch("bmfr_warp_rows", src.data_ptr(), iy.data_ptr(),
                ix.data_ptr(), row0.data_ptr(), row1.data_ptr(), C, H, W)
    _lib.count_launch(warp_rows)
    return row0, row1


#: kernel launches since the count was last set to 0
warp_rows.launches = 0


def gather_taps(planes, iy, ix, mode="float32"):
    """All four bilinear taps of ``planes`` at integer coords (iy, ix)
    (``warp.py:65-118``).

    planes: f32 ``[C, H, W]``; iy/ix: i32 ``[H, W]`` (floor of the
    reprojected position). Returns f32 ``[4, C, H, W]`` in reference tap
    order ((0,0),(1,0),(0,1),(1,1)). Indices are clipped; validity must be
    masked by the caller. Modes: ``float32`` (exact), ``packed_bf16``
    (two channels per word), ``packed_x_bf16`` (two horizontal taps per
    word, two gathers for all four taps) and ``pallas`` (the same words
    through kernel E, :func:`warp_rows`).
    """
    C = planes.shape[0]
    if mode in ("packed_x_bf16", "pallas"):
        src = pack_x_pairs_bf16(planes)
        if mode == "pallas":
            row0, row1 = warp_rows(src, iy, ix)
        else:
            row0, row1 = warp_rows_reference(src, iy, ix)
        # at x == W-1 the pair duplicates the edge value, but tap (1, dy)
        # there is out of bounds and masked by the caller; at ix < 0 the
        # gather clips to x = 0, whose *lo* half is the in-bounds dx = 1
        # tap (x = 0): select accordingly (warp.py:101-108)
        neg = (ix < 0)[None]
        tap10 = torch.where(neg, _lo(row0), _hi(row0))
        tap11 = torch.where(neg, _lo(row1), _hi(row1))
        return torch.stack([_lo(row0), tap10, _lo(row1), tap11])
    if mode == "packed_bf16":
        src = pack_pairs_bf16(planes)
        return torch.stack([
            unpack_pairs_bf16(gather_planes(src, add_wrap(iy, dy),
                                            add_wrap(ix, dx)), C)
            for dx, dy in TAP_OFFSETS])
    if mode != "float32":
        raise ValueError(f"bad warp mode: {mode}")
    return torch.stack([gather_planes(planes, add_wrap(iy, dy),
                                      add_wrap(ix, dx))
                        for dx, dy in TAP_OFFSETS])
