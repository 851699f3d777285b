"""Stage K4 — second temporal accumulation + albedo remodulation + tone
map (port of the pre-blended branch of
:func:`bmfr_tpu.ops.accumulate.accumulate_filtered_data`,
opencl/bmfr.cl:761-857)."""

from __future__ import annotations

import numpy as np
import torch

from .frame import has_history


def accumulate_filtered_data(cfg, filtered, planes, albedo, spp, frame,
                             history=None):
    """Returns (accumulated ``f32[3,H,W]``, tone_mapped ``f32[3,H,W]``).

    filtered: the fitter output; planes: the warp's 13 blend planes
    (K4 reads the accept-gated out sum 6:9 and the total weight 4);
    spp: K1's new ``u8[H,W]``; ``frame``/``history``: whether the frame
    reads history (:func:`~bmfr_tpu_torch.ops.frame.has_history`)."""
    prev_color = planes[6:9]
    total_weight = planes[4]

    enabled = has_history(frame, history) and not cfg.skip_second_accum
    has_prev = (total_weight > 0.0) & enabled
    safe_tw = torch.where(total_weight > 0.0, total_weight, 1.0)
    prev_color = prev_color / safe_tw[None]

    # blend_alpha = max(1/spp, SECOND_BLEND_ALPHA) (opencl/bmfr.cl:836-839)
    blend_alpha = torch.where(
        has_prev,
        torch.clamp_min(1.0 / spp.float(),
                        float(np.float32(cfg.second_blend_alpha))),
        1.0)
    prev_color = torch.where(has_prev, prev_color, 0.0)

    accumulated = (blend_alpha[None] * filtered
                   + (1.0 - blend_alpha)[None] * prev_color)

    # albedo remodulation + gamma 1/2.2 + clamp (opencl/bmfr.cl:852-856)
    tone = torch.clamp(
        torch.pow(torch.clamp_min(albedo * accumulated, 0.0),
                  float(np.float32(0.454545))),
        0.0, 1.0)
    return accumulated, tone
