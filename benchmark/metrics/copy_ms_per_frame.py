"""Device ms a frame of the traced range's copies and fills (``Memcpy``,
``Memset``): the step's six input copies and the entry's copy of the
result."""


def read(reading):
    ops = [dur for name, _, dur in reading.device
           if name.startswith(("Memcpy", "Memset"))]
    if not ops:
        return None
    return sum(ops) / reading.frames / 1e3
