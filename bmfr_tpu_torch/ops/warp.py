"""The bf16 channel-pair pack of the recurrent state (port of
:func:`bmfr_tpu.ops.warp.pack_pairs_bf16` / ``unpack_pairs_bf16``).

Word ``k`` of a pack holds channel ``2k`` in its low 16 bits and channel
``2k+1`` in its high 16 bits, each rounded to bf16 (nearest-even). The
port builds and reads the words through a bf16 view of the int32 buffer
(little-endian: the low half of a word is the even bf16 element), so no
integer shift ever runs on a sign bit.
"""

from __future__ import annotations

import torch


def _halves(packed):
    """i32 ``[P, ...]`` -> bf16 ``[P, ..., 2]`` view (lo, hi) of the words."""
    return packed.view(torch.bfloat16).view(*packed.shape, 2)


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
