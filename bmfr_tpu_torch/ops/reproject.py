"""Stage K1 — temporal reprojection + first accumulation of noisy colour.

Port of :mod:`bmfr_tpu.ops.reproject` (opencl/bmfr.cl:290-485) for the
fused-warp path: the bilinear taps arrive pre-blended from the warp
kernel (:func:`bmfr_tpu_torch.ops.warp_blend.warp_blend`), so only the
reprojection and the tail that consumes the blend planes are here.
"""

from __future__ import annotations

import numpy as np
import torch


def reproject_coords(cfg, positions, prev_cam, pixel_offset):
    """Reprojected previous-frame coordinates for every pixel
    (opencl/bmfr.cl:338-356). ``prev_cam``: f32 ``[4, 4]`` stored so its
    columns project; ``pixel_offset``: f32 ``[2]``. Returns (pfx, pfy)
    f32 ``[H, W]``."""
    H, W = cfg.image_height, cfg.image_width
    wp = positions

    def cam_dot(col):
        return (prev_cam[0, col] * wp[0] + prev_cam[1, col] * wp[1]
                + prev_cam[2, col] * wp[2] + prev_cam[3, col])

    u = cam_dot(0)
    v = cam_dot(1)
    w = cam_dot(3)
    pfx = (u / w + 1.0) * 0.5 * W - pixel_offset[0]
    pfy = (v / w + 1.0) * 0.5 * H - (1.0 - pixel_offset[1])
    return pfx, pfy


def accumulate_noisy_data(cfg, noisy, pfx, pfy, planes, frame: int):
    """First temporal accumulation from the warp's blend planes
    (``reproject.py:71-77, :116-147``).

    noisy: current f32 ``[3, H, W]``; pfx/pfy: :func:`reproject_coords`;
    planes: the 13 blend planes (all zero at frame 0, which has no
    history). Returns dict with ``accum f32[3,H,W]``, ``spp u8[H,W]``,
    ``prev_pixels f32[2,H,W]``, ``accept u8[H,W]``.
    """
    H, W = noisy.shape[-2:]
    dev = noisy.device
    prev_color = planes[0:3]
    sample_spp = planes[3]
    total_weight = planes[4]
    not_first = frame > 0

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
