"""Kernel F (``csrc/filtered_tail.cu``, K4 + K5 and the state's out and
result): in, the filtered image, blend planes 4 and 6:13, albedo, spp
and the reprojection; out, out, tone and result and, on a packed carry,
state words 5:8. ~220 operations a pixel: K4 with three powf, the 3x3
and cross min/max, the clamp and the blend (``chip_smoke.py``'s
count)."""

TRACE_NAME = "filtered_tail"


def count(s, config):
    px = s.image_width * s.image_height
    words = 3 * 4 if config["carry"] == "PackedState" else 0
    per_px = 12 + 4 + 28 + 12 + 1 + 8 + 36 + words
    return per_px * px, 220 * px
