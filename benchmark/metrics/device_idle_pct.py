"""The share of the traced range's host span in which no device
operation ran, in %."""


def read(reading):
    if not reading.device or reading.window_us <= 0:
        return None
    return 100.0 * (1.0 - reading.busy_us / reading.window_us)
