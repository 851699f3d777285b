"""Jittered, mirrored margins-grid addressing and the block layout.

Port of :mod:`bmfr_tpu.ops.blockify`: margins-grid cell ``(gy, gx)``
reads image pixel ``(mirror(gy - half + oy, H), mirror(gx - half + ox,
W))`` with ``(ox, oy)`` the frame's block jitter (opencl/bmfr.cl:314-316),
and block ``b = gy//be * blocks_x + gx//be`` holds element ``e = gx%be +
(gy%be)*be`` (opencl/bmfr.cl:455-464). JAX builds the view with a
symmetric pad and a dynamic slice; torch's ``F.pad`` has no symmetric
mode, and the fitter kernels need no padded copy at all, so here the
view is a gather by mirrored indices.

:func:`build_feature_blocks` (kernel J, ``csrc/feature_blocks.cu``)
replaces what XLA fuses on the TPU out of ``build_feature_blocks``
(``bmfr_tpu/ops/blockify.py:181``): the features, the store contract and
the jittered block layout in one pass, with no planes or view copy.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from ..features import evaluate_features
from ..geometry import BLOCK_OFFSETS
from . import _lib
from .frame import frame_tensor

#: torch dtype of each ``tmp_data_dtype``
STORAGE_DTYPES = {"float32": torch.float32, "float16": torch.float16,
                  "bfloat16": torch.bfloat16}


def storage_dtype(cfg):
    """The torch dtype the blocks are stored in (``cfg.tmp_data_dtype``)."""
    return STORAGE_DTYPES[cfg.tmp_data_dtype]


#: the jitter table on each device it was asked for, by (device,
#: block_edge): built once (in an eager step, before any capture), then
#: read by index on the device. Built under a lock: a captured graph reads
#: the table's memory without holding the tensor, so a second table made
#: by a racing thread would free the one a graph captured
_TABLES = {}
_TABLES_LOCK = threading.Lock()


def jitter_offset(frame, block_edge: int = 32):
    """Block jitter ``(ox, oy)`` of a frame (opencl/bmfr.cl:315). For
    ``block_edge != 32`` the reference's table is scaled by
    ``block_edge / 32`` (floor), as ``blockify._scaled_offsets`` does, so
    the jitter keeps inside the one-block margin.

    ``frame``: a host int (returns ints) or a 0-d integer tensor (returns
    0-d int64 tensors on its device, read from the table there without a
    host round trip)."""
    table = (BLOCK_OFFSETS if block_edge == 32
             else (BLOCK_OFFSETS * block_edge) // 32)
    if isinstance(frame, torch.Tensor):
        key = (frame.device, block_edge)
        with _TABLES_LOCK:
            tab = _TABLES.get(key)
            if tab is None:
                tab = _TABLES[key] = torch.as_tensor(
                    table, dtype=torch.int64, device=frame.device)
        # index_select, not [tensor]: indexing by a 0-d tensor reads it on
        # the host
        k = torch.remainder(frame.to(torch.int64), len(table)).reshape(1)
        off = tab.index_select(0, k)[0]
        return off[0], off[1]
    ox, oy = table[int(frame) % len(table)]
    return int(ox), int(oy)


def _window(start, size: int, device):
    """Indices ``start + arange(size)`` (``start`` an int or a 0-d
    tensor)."""
    return torch.arange(size, device=device) + start


def mirror_index(index, size: int):
    """Symmetric reflection of integer ``index`` into ``[0, size)``:
    ``-1 -> 0, -2 -> 1, size -> size-1``, and periodic with period
    ``2*size`` beyond one reflection — the addressing of
    ``jnp.pad(mode="symmetric")``. Equal to :func:`geometry.mirror`
    wherever that is valid. The fitter kernels use the same formula."""
    m = torch.remainder(index, 2 * size)
    return torch.where(m < size, m, 2 * size - 1 - m)


def jittered_view(cfg, planes, frame):
    """``[C, H, W]`` planes -> the jittered margins-grid view
    ``[C, mh, mw]`` (``blockify_view`` without the pad copy). ``frame``:
    a host int or a 0-d integer tensor (:func:`jitter_offset`)."""
    H, W = planes.shape[-2:]
    half = cfg.block_edge // 2
    ox, oy = jitter_offset(frame, cfg.block_edge)
    dev = planes.device
    rows = mirror_index(_window(oy - half, cfg.workset_with_margins_height,
                                dev), H)
    cols = mirror_index(_window(ox - half, cfg.workset_with_margins_width,
                                dev), W)
    return planes[:, rows[:, None], cols[None, :]]


def view_to_blocks(cfg, view):
    """Margins-grid view ``[C, mh, mw]`` -> ``[n_blocks, C,
    block_pixels]``."""
    C = view.shape[0]
    be = cfg.block_edge
    blocks = view.reshape(C, cfg.blocks_y, be, cfg.blocks_x, be)
    return blocks.permute(1, 3, 0, 2, 4).reshape(cfg.n_blocks, C,
                                                 cfg.block_pixels)


def blockify_planes(cfg, planes, frame):
    """``[C, H, W]`` planes -> ``[n_blocks, C, block_pixels]`` jittered
    blocks (``blockify.py:146-158``)."""
    return view_to_blocks(cfg, jittered_view(cfg, planes, frame))


def unblockify_planes(cfg, blocks, frame):
    """Inverse of :func:`blockify_planes` restricted to the image window
    (``blockify.py:161-178``): ``[n_blocks, C, block_pixels]`` ->
    ``[C, H, W]``, where image pixel ``p`` reads margins-grid cell ``p +
    half - offset``, the per-pixel inverse jitter of the reconstruction
    (opencl/bmfr.cl:718-722)."""
    C = blocks.shape[1]
    be = cfg.block_edge
    half = be // 2
    view = blocks.reshape(cfg.blocks_y, cfg.blocks_x, C, be, be)
    view = view.permute(2, 0, 3, 1, 4).reshape(
        C, cfg.workset_with_margins_height, cfg.workset_with_margins_width)
    # a gather, not a slice: the window's origin may be a tensor
    ox, oy = jitter_offset(frame, be)
    rows = _window(half - oy, cfg.image_height, view.device)
    cols = _window(half - ox, cfg.image_width, view.device)
    return view[:, rows[:, None], cols[None, :]]


def _feature_planes(cfg, normals, positions, accum_color):
    """The K1 feature store before blocking (opencl/bmfr.cl:447-476):
    features + accumulated colour, NaN -> 0, clamped to +-65504 under
    f16 storage (opencl/bmfr.cl:471-473)."""
    feats = evaluate_features(cfg.all_features, normals, positions)
    planes = torch.cat([feats, accum_color], dim=0)
    planes = torch.where(torch.isnan(planes), 0.0, planes)
    if cfg.tmp_data_dtype == "float16":
        planes = planes.clamp(-65504.0, 65504.0)
    return planes


def build_feature_blocks_reference(cfg, normals, positions, accum_color,
                                   frame):
    """Plain PyTorch version of :func:`build_feature_blocks`."""
    blocks = blockify_planes(
        cfg, _feature_planes(cfg, normals, positions, accum_color), frame)
    return blocks.to(storage_dtype(cfg))


def build_feature_blocks(cfg, normals, positions, accum_color, frame):
    """Feature-vector build + block store of K1 (``blockify.py:181-197``):
    ``[n_blocks, buffer_count, block_pixels]`` in the storage dtype, from
    the normals, positions and accumulated colour (f32 ``[3, H, W]``) at
    frame ``frame`` (a host int or a 0-d int32 tensor on their card).

    On a CUDA tensor this launches kernel J (``csrc/feature_blocks.cu``),
    which reads the frame and its jitter on the card and computes the
    built-in features itself (:func:`~bmfr_tpu_torch.ops.fitter_direct.
    feature_table`); on a CPU tensor it runs
    :func:`build_feature_blocks_reference`. Any other device raises.
    """
    from .fitter_direct import feature_table
    from .fitter_pallas import MODE

    dev = normals.device
    if dev.type == "cpu":
        return build_feature_blocks_reference(cfg, normals, positions,
                                              accum_color, frame)
    if dev.type != "cuda":
        raise ValueError(f"build_feature_blocks: unsupported device {dev}")
    H, W = cfg.image_height, cfg.image_width
    for t, label in ((normals, "normals"), (positions, "positions"),
                     (accum_color, "accum_color")):
        _lib.check_tensor(t, label, torch.float32, (3, H, W), dev)
    ft = frame_tensor(frame, dev)
    extra, planes, ops = feature_table(cfg, normals, positions, accum_color)
    out = torch.empty((cfg.n_blocks, cfg.buffer_count, cfg.block_pixels),
                      dtype=storage_dtype(cfg), device=dev)
    _lib.launch("bmfr_feature_blocks", ctypes.addressof(planes),
                ctypes.addressof(ops), cfg.feature_count,
                accum_color.data_ptr(), out.data_ptr(), ft.data_ptr(), H, W,
                cfg.block_edge, cfg.blocks_x, cfg.n_blocks,
                MODE[cfg.tmp_data_dtype])
    _lib.count_launch(build_feature_blocks)
    # the extra planes' memory is reused only after the kernel, in stream
    # order
    del extra
    return out


#: kernel launches since the count was last set to 0
build_feature_blocks.launches = 0


def build_feature_view(cfg, normals, positions, accum_color, frame):
    """Like :func:`build_feature_blocks` but stopping at the jittered
    image-layout view, rounded through the storage dtype and returned in
    f32 (``blockify.py:200-213``)."""
    view = jittered_view(
        cfg, _feature_planes(cfg, normals, positions, accum_color), frame)
    return view.to(storage_dtype(cfg)).float()
