"""Device operations (kernels, copies, fills) a frame in the traced
range: the compiled step's replay, its input copies and frame fill, and
the entry's copy of the result."""


def read(reading):
    if not reading.device:
        return None
    return len(reading.device) / reading.frames
