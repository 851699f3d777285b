"""The least time the card could take for a frame's compulsory bytes
(``benchmark/roofline/frame.py``) over the traced ms a frame, in %. It
does not change when a kernel is fused or split."""

from benchmark.yardstick import bound_ms, load


def read(reading):
    if not reading.device or reading.frames <= 0:
        return None
    ms, _ = bound_ms(*load("roofline", "frame").count(reading.settings,
                                                      reading.config))
    return 100.0 * ms / (reading.window_us / reading.frames / 1e3)
