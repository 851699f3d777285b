"""YCoCg conversions used by the TAA neighbourhood clamp
(``RGB_to_YCoCg`` / ``YCoCg_to_RGB``, opencl/bmfr.cl:184-198), on
channels-first ``[3, ...]`` tensors. Port of :mod:`bmfr_tpu.color`."""

from __future__ import annotations

import torch


def rgb_to_ycocg(rgb):
    """[3, ...] RGB -> [3, ...] YCoCg (unnormalized, as in the reference)."""
    r, g, b = rgb[0], rgb[1], rgb[2]
    return torch.stack([r + 2.0 * g + b, 2.0 * r - 2.0 * b, -r + 2.0 * g - b])


def ycocg_to_rgb(ycocg):
    """[3, ...] YCoCg -> [3, ...] RGB. Inverse with the 0.25 scaling."""
    y, co, cg = ycocg[0], ycocg[1], ycocg[2]
    return torch.stack([
        0.25 * y + 0.25 * co - 0.25 * cg,
        0.25 * y + 0.25 * cg,
        0.25 * y - 0.25 * co - 0.25 * cg,
    ])
