"""The share of the traced range's host span in which no device
operation ran, in %, where each frame is waited for before the next:
the host's part of every frame's latency (the profiler's host cost in
it too)."""


def read(reading):
    if not reading.device or reading.window_us <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_us / reading.window_us)
