"""Kernel C's share of its roofline (``benchmark/roofline/C.py``):
its bound at the cell's shapes over its device ms per launch in the
trace, in %."""

from benchmark.yardstick import kernel_share


def read(reading):
    return kernel_share(reading, "C")
