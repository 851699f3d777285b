"""Stage K5 — temporal anti-aliasing with a YCoCg neighbourhood clamp
(port of the pre-blended branch of :func:`bmfr_tpu.ops.taa.taa`,
opencl/bmfr.cl:860-974)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..color import rgb_to_ycocg, ycocg_to_rgb
from .frame import has_history
from .gather import floor_int


def _max3x3(x, kernel):
    """Max over a 3x3 (or 3x1 / 1x3) neighbourhood, out-of-image samples
    ignored (max-pooling pads with -inf): an exact op, so it equals the
    JAX package's shifted-slice min/max in any dtype."""
    pad = (kernel[0] // 2, kernel[1] // 2)
    return F.max_pool2d(x[None], kernel, stride=1, padding=pad)[0]


def taa(cfg, prev_pixels, new_frame, planes, frame, history=None):
    """new_frame: tone-mapped K4 output ``f32[3,H,W]``; prev_pixels: K1's
    reprojection map ``f32[2,H,W]``; planes: the warp's blend planes (K5
    reads the border-masked result sum 9:12 and its weight 12);
    ``frame``/``history``: whether the frame reads history
    (:func:`~bmfr_tpu_torch.ops.frame.has_history`). Returns
    ``f32[3,H,W]``."""
    # early-out: first frame (opencl/bmfr.cl:884-890) or the bypass
    if not has_history(frame, history) or cfg.skip_taa:
        return new_frame
    H, W = new_frame.shape[-2:]

    # 3x3 YCoCg AABB (opencl/bmfr.cl:893-920); with residual_dtype=
    # "bfloat16" the neighbourhood scan runs on bf16 values
    rd = torch.bfloat16 if cfg.residual_dtype == "bfloat16" else torch.float32
    yccr = rgb_to_ycocg(new_frame).to(rd)
    mx_box = _max3x3(yccr, (3, 3)).float()
    mn_box = (-_max3x3(-yccr, (3, 3))).float()
    mx_cross = torch.maximum(_max3x3(yccr, (3, 1)),
                             _max3x3(yccr, (1, 3))).float()
    mn_cross = (-torch.maximum(_max3x3(-yccr, (3, 1)),
                               _max3x3(-yccr, (1, 3)))).float()

    # the bilinear sample of the previous result, pre-blended by the warp
    prev_color = planes[9:12]
    total_weight = planes[12]
    safe_tw = torch.where(total_weight > 0.0, total_weight, 1.0)
    prev_color = prev_color / safe_tw[None]

    clamped = torch.clamp(rgb_to_ycocg(prev_color),
                          (mn_box + mn_cross) * 0.5,
                          (mx_box + mx_cross) * 0.5)
    prev_rgb = ycocg_to_rgb(clamped)

    alpha = np.float32(cfg.taa_blend_alpha)
    blended = (float(alpha) * new_frame
               + float(np.float32(1.0) - alpha) * prev_rgb)

    # early-out: reprojection fully off screen (opencl/bmfr.cl:884-890)
    ix = floor_int(prev_pixels[0])
    iy = floor_int(prev_pixels[1])
    off_screen = (ix < -1) | (iy < -1) | (ix >= W) | (iy >= H)
    return torch.where(off_screen[None], new_frame, blended)
