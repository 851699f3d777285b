"""Kernel I (``csrc/warp_taps.cu``, the raw-plane tap warp and blend):
in, the 16 state channels (15 float32 and the u8 spp), the positions,
normals and the reprojection; out, the 13 blend planes. ~200 operations
a pixel (``chip_smoke.py``'s count)."""

TRACE_NAME = "warp_taps_kernel"


def count(s, config):
    px = s.image_width * s.image_height
    return (61 + 12 + 12 + 8 + 13 * 4) * px, 200 * px
