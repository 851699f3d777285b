"""Stage K1 — temporal reprojection + first accumulation of noisy colour.

Port of :mod:`bmfr_tpu.ops.reproject` (opencl/bmfr.cl:290-485) for the
fused-warp path: the bilinear taps arrive pre-blended from the warp
kernel (:func:`bmfr_tpu_torch.ops.warp_blend.warp_blend`), so only the
reprojection and the tail that consumes the blend planes are here.

On the TPU, XLA fuses both into the jitted step. On the card each is a
kernel of its own beside its plain PyTorch version:
:func:`reproject_coords` (kernel H, ``csrc/reproject.cu``) and
:func:`noisy_tail` (kernel G, ``csrc/noisy_tail.cu``: the K1 tail and the
next state's words 0:5, or its raw positions, normals, noisy and spp).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib
from .frame import has_history
from .warp import pack_pairs_bf16
from ..profiling import stage


def _own_coordinates(H, W, device):
    """Each pixel's own coordinates ``f32[2, H, W]`` (x, y): the map
    frame 0 records (opencl/bmfr.cl:324-325)."""
    own_x = torch.arange(W, dtype=torch.float32, device=device)
    own_y = torch.arange(H, dtype=torch.float32, device=device)
    return torch.stack([own_x[None, :].expand(H, W),
                        own_y[:, None].expand(H, W)])


def reproject_coords_reference(cfg, positions, prev_cam, pixel_offset,
                               history="always"):
    """Plain PyTorch version of :func:`reproject_coords`."""
    H, W = cfg.image_height, cfg.image_width
    if not has_history(None, history):
        return _own_coordinates(H, W, positions.device)
    wp = positions

    def cam_dot(col):
        return (prev_cam[0, col] * wp[0] + prev_cam[1, col] * wp[1]
                + prev_cam[2, col] * wp[2] + prev_cam[3, col])

    u = cam_dot(0)
    v = cam_dot(1)
    w = cam_dot(3)
    pfx = (u / w + 1.0) * 0.5 * W - pixel_offset[0]
    pfy = (v / w + 1.0) * 0.5 * H - (1.0 - pixel_offset[1])
    return torch.stack([pfx, pfy])


def reproject_coords(cfg, positions, prev_cam, pixel_offset,
                     history="always"):
    """Reprojected previous-frame coordinates for every pixel
    (opencl/bmfr.cl:338-356) as ``prev_pixels`` f32 ``[2, H, W]``, whose
    two planes are pfx and pfy (``pfx, pfy = reproject_coords(...)``
    unpacks them). ``positions``: f32 ``[3, H, W]``; ``prev_cam``: f32
    ``[4, 4]`` stored so its columns project; ``pixel_offset``: f32
    ``[2]``, both read on the card. ``history="never"`` (frame 0, which
    reprojects nothing) gives each pixel's own coordinates, the map K1
    records then.

    On a CUDA tensor this launches kernel H, bit-equal to
    :func:`reproject_coords_reference` (kernel A's accept bits compare
    pfx/pfy against limits); on a CPU tensor it runs that plain version.
    Any other device raises."""
    dev = positions.device
    if dev.type == "cpu":
        return reproject_coords_reference(cfg, positions, prev_cam,
                                          pixel_offset, history)
    if dev.type != "cuda":
        raise ValueError(f"reproject_coords: unsupported device {dev}")
    hist = has_history(None, history)
    H, W = cfg.image_height, cfg.image_width
    _lib.check_tensor(positions, "positions", torch.float32, (3, H, W), dev)
    _lib.check_tensor(prev_cam, "prev_cam", torch.float32, (4, 4), dev)
    _lib.check_tensor(pixel_offset, "pixel_offset", torch.float32, (2,), dev)
    out = torch.empty((2, H, W), dtype=torch.float32, device=dev)
    _lib.launch("bmfr_reproject", positions.data_ptr(), prev_cam.data_ptr(),
                pixel_offset.data_ptr(), out.data_ptr(), H, W, int(hist))
    _lib.count_launch(reproject_coords)
    return out


#: kernel launches since the count was last set to 0
reproject_coords.launches = 0


def accumulate_noisy_data(cfg, noisy, pfx, pfy, planes, frame,
                          history=None):
    """First temporal accumulation from the warp's blend planes
    (``reproject.py:71-77, :116-147``).

    noisy: current f32 ``[3, H, W]``; pfx/pfy: :func:`reproject_coords`;
    planes: the 13 blend planes (all zero at frame 0, which has no
    history). ``frame``/``history``: whether the frame reads history
    (:func:`~bmfr_tpu_torch.ops.frame.has_history`). Returns dict with
    ``accum f32[3,H,W]``, ``spp u8[H,W]``, ``prev_pixels f32[2,H,W]``,
    ``accept u8[H,W]``.
    """
    H, W = noisy.shape[-2:]
    dev = noisy.device
    prev_color = planes[0:3]
    sample_spp = planes[3]
    total_weight = planes[4]
    not_first = has_history(frame, history)

    has_prev = (total_weight > 0.0) & not_first
    safe_tw = torch.where(total_weight > 0.0, total_weight, 1.0)
    prev_color = prev_color / safe_tw[None]
    sample_spp = sample_spp / safe_tw

    # blend_alpha = max(1/(spp+1), BLEND_ALPHA), 1 when no history
    # (opencl/bmfr.cl:421-429)
    blend_alpha = torch.where(
        has_prev,
        torch.clamp_min(1.0 / (sample_spp + 1.0),
                        float(np.float32(cfg.blend_alpha))),
        1.0)

    # new spp, saturating uint8 round-half-even (opencl/bmfr.cl:432-442)
    rounded = torch.clamp(torch.round(sample_spp), 0.0, 254.0).to(
        torch.int32) + 1
    capped = torch.where(sample_spp > 254.0, 255, rounded)
    new_spp = torch.where(has_prev, capped, 1).to(torch.uint8)

    accum = blend_alpha[None] * noisy + (1.0 - blend_alpha)[None] * prev_color

    # prev-pixel map: own coordinates when there is no previous frame
    # (opencl/bmfr.cl:324-325)
    if not_first:
        prev_pixels = torch.stack([pfx, pfy])
        accept = planes[5].to(torch.uint8)
    else:
        own_x = torch.arange(W, dtype=torch.float32, device=dev)
        own_y = torch.arange(H, dtype=torch.float32, device=dev)
        prev_pixels = torch.stack([own_x[None, :].expand(H, W),
                                   own_y[:, None].expand(H, W)])
        accept = torch.zeros((H, W), dtype=torch.uint8, device=dev)
    return dict(accum=accum, spp=new_spp, prev_pixels=prev_pixels,
                accept=accept)


def noisy_tail_reference(cfg, noisy, prev_pixels, planes, positions,
                         normals, frame, history=None, pack=None, into=None):
    """Plain PyTorch version of :func:`noisy_tail`: the K1 tail
    (:func:`accumulate_noisy_data`, which rebuilds ``prev_pixels`` from
    its planes) and, with ``pack``, words 0:5 of the state or, with
    ``into``, its positions, normals, noisy and spp."""
    H, W = noisy.shape[-2:]
    _lib.check_destinations(pack, into, H, W, noisy.device)
    k1 = accumulate_noisy_data(cfg, noisy, prev_pixels[0], prev_pixels[1],
                               planes, frame, history)
    if pack is not None:
        with stage("state_pack"):
            pack_pairs_bf16([*positions, *normals], out=pack[0:3])
            pack_pairs_bf16([*k1["accum"], k1["spp"].float()],
                            out=pack[3:5])
    if into is not None:
        with stage("state_pack"):
            into.positions.copy_(positions)
            into.normals.copy_(normals)
            into.noisy.copy_(k1["accum"])
            into.spp.copy_(k1["spp"])
        k1 = dict(k1, accum=into.noisy, spp=into.spp)
    return k1


def noisy_tail(cfg, noisy, prev_pixels, planes, positions, normals, frame,
               history=None, pack=None, into=None):
    """The K1 tail and the next state's geometry and accum/spp:
    :func:`accumulate_noisy_data`'s dict (``accum f32[3,H,W]``, ``spp
    u8[H,W]``, ``prev_pixels f32[2,H,W]``, ``accept u8[H,W]``) and, with
    ``pack`` (a :class:`~bmfr_tpu_torch.pipeline.denoise.PackedState`'s
    i32 ``[8, H, W]``), words 0:3 (positions and normals) and 3:5
    (``accum`` and ``spp``) written in place as bf16 pairs; words 5:8 are
    left alone. With ``into`` (a :class:`~bmfr_tpu_torch.pipeline.state.
    TemporalState` of six distinct contiguous tensors, never with
    ``pack``), ``accum`` and ``spp`` are written into ``into.noisy`` and
    ``into.spp`` (the dict holds those tensors) and this frame's
    ``positions`` and ``normals`` into ``into.positions`` and
    ``into.normals``; ``into.out`` and ``into.result`` are left alone.

    ``prev_pixels``: :func:`reproject_coords`'s map, passed through (at
    frame 0 it holds the pixels' own coordinates); ``planes``: the warp's
    13 blend planes (K1 reads 0:6, plane 5 the accept bits 0..15);
    ``positions``/``normals``: this frame's, read only for ``pack`` or
    ``into``; ``frame``/``history`` as :func:`accumulate_noisy_data`
    takes them.

    On a CUDA tensor this launches kernel G, bit-equal to
    :func:`noisy_tail_reference`; on a CPU tensor it runs that plain
    version. Any other device raises. Launch it after the warp has read
    the previous state in ``pack`` or ``into`` (stream order keeps one
    buffer set sound)."""
    dev = noisy.device
    if dev.type == "cpu":
        return noisy_tail_reference(cfg, noisy, prev_pixels, planes,
                                    positions, normals, frame, history, pack,
                                    into)
    if dev.type != "cuda":
        raise ValueError(f"noisy_tail: unsupported device {dev}")
    H, W = noisy.shape[-2:]
    _lib.check_destinations(pack, into, H, W, dev)
    _lib.check_tensor(noisy, "noisy", torch.float32, (3, H, W), dev)
    _lib.check_tensor(prev_pixels, "prev_pixels", torch.float32, (2, H, W),
                      dev)
    _lib.check_tensor(planes, "planes", torch.float32, (13, H, W), dev)
    if pack is not None or into is not None:
        _lib.check_tensor(positions, "positions", torch.float32, (3, H, W),
                          dev)
        _lib.check_tensor(normals, "normals", torch.float32, (3, H, W), dev)
    if pack is not None:
        _lib.check_tensor(pack, "pack", torch.int32, (8, H, W), dev)
    if into is None:
        accum = torch.empty((3, H, W), dtype=torch.float32, device=dev)
        spp = torch.empty((H, W), dtype=torch.uint8, device=dev)
    else:
        accum, spp = into.noisy, into.spp
    accept = torch.empty((H, W), dtype=torch.uint8, device=dev)
    _lib.launch("bmfr_noisy_tail", planes.data_ptr(), noisy.data_ptr(),
                positions.data_ptr(), normals.data_ptr(), accum.data_ptr(),
                spp.data_ptr(), accept.data_ptr(),
                None if pack is None else pack.data_ptr(),
                None if into is None else into.positions.data_ptr(),
                None if into is None else into.normals.data_ptr(), H, W,
                float(np.float32(cfg.blend_alpha)),
                int(has_history(frame, history)))
    _lib.count_launch(noisy_tail)
    return dict(accum=accum, spp=spp, prev_pixels=prev_pixels, accept=accept)


#: kernel launches since the count was last set to 0
noisy_tail.launches = 0
