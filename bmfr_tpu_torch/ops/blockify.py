"""Jittered, mirrored margins-grid addressing as index arithmetic.

Port of the addressing of :mod:`bmfr_tpu.ops.blockify`
(``blockify.py:52-67, :93-108``): margins-grid cell ``(gy, gx)`` reads
image pixel ``(mirror(gy - half + oy, H), mirror(gx - half + ox, W))``
with ``(ox, oy) = BLOCK_OFFSETS[frame % 16]`` (opencl/bmfr.cl:314-316).
JAX builds that view with a symmetric pad and a dynamic slice; torch's
``F.pad`` has no symmetric mode, and the fitter kernel needs no padded
copy at all, so here the view is a gather by mirrored indices.
"""

from __future__ import annotations

import torch

from ..geometry import BLOCK_OFFSETS


def jitter_offset(frame: int):
    """Block jitter ``(ox, oy)`` of a frame (opencl/bmfr.cl:315)."""
    ox, oy = BLOCK_OFFSETS[int(frame) % len(BLOCK_OFFSETS)]
    return int(ox), int(oy)


def mirror_index(index, size: int):
    """Symmetric reflection of integer ``index`` into ``[0, size)``:
    ``-1 -> 0, -2 -> 1, size -> size-1``, and periodic with period
    ``2*size`` beyond one reflection — the addressing of
    ``jnp.pad(mode="symmetric")``. Equal to :func:`geometry.mirror`
    wherever that is valid. The fitter kernel uses the same formula."""
    m = torch.remainder(index, 2 * size)
    return torch.where(m < size, m, 2 * size - 1 - m)


def jittered_view(cfg, planes, frame: int):
    """``[C, H, W]`` planes -> the jittered margins-grid view
    ``[C, mh, mw]`` (``blockify_view`` without the pad copy)."""
    H, W = planes.shape[-2:]
    half = cfg.block_edge // 2
    ox, oy = jitter_offset(frame)
    dev = planes.device
    rows = mirror_index(torch.arange(cfg.workset_with_margins_height,
                                     device=dev) - half + oy, H)
    cols = mirror_index(torch.arange(cfg.workset_with_margins_width,
                                     device=dev) - half + ox, W)
    return planes[:, rows[:, None], cols[None, :]]
