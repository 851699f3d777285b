"""Timers and the mean/min/max/total report.

Port of :mod:`bmfr_tpu.profiling`: ``ProfilingInfo`` series with the
reference's report (CLUtils.hpp:240-361, printed as at
opencl/bmfr.cpp:489-517) and ``CPUTimer`` (CLUtils.hpp:371-431). PyTorch
returns before the card has run what it launched, so
:func:`device_timer` synchronizes the card before and after the timed
work, the counterpart of the JAX package's readback fence (``force``).
Kernel-level device times come from ``torch.profiler`` (``chip_smoke.py``);
there is no xplane ``trace`` here.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch


class CPUTimer:
    """chrono-style start/stop timer (CLUtils.hpp:371-431 equivalent)."""

    def __init__(self):
        self._t0 = None
        self._duration_ms = 0.0

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        self._duration_ms = (time.perf_counter() - self._t0) * 1e3
        return self._duration_ms

    def duration(self):
        return self._duration_ms


def synchronize(device):
    """Wait for the work launched on ``device`` (a no-op on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def device_timer(out: list, device):
    """Time the work launched inside the block on ``device``: synchronize
    before and after, append the milliseconds to ``out``."""
    synchronize(device)
    t0 = time.perf_counter()
    yield
    synchronize(device)
    out.append((time.perf_counter() - t0) * 1e3)


@dataclass
class ProfilingInfo:
    """Fixed-label timing series with the reference's report format
    (CLUtils.hpp:240-361)."""

    label: str
    times_ms: list = field(default_factory=list)

    def __getitem__(self, i):
        return self.times_ms[i]

    def append(self, ms):
        self.times_ms.append(ms)

    def mean(self):
        return sum(self.times_ms) / max(len(self.times_ms), 1)

    def min(self):
        return min(self.times_ms) if self.times_ms else 0.0

    def max(self):
        return max(self.times_ms) if self.times_ms else 0.0

    def total(self):
        return sum(self.times_ms)

    def report_row(self):
        return (f"{self.label:<55}{self.mean():>10.3f}{self.min():>10.3f}"
                f"{self.max():>10.3f}{self.total():>12.3f}")


def print_report(infos):
    """mean/min/max/total table, mirroring ProfilingInfo::print
    (CLUtils.hpp:313-332)."""
    header = (f"{'stage':<55}{'mean ms':>10}{'min ms':>10}"
              f"{'max ms':>10}{'total ms':>12}")
    lines = [header, "-" * len(header)]
    lines += [p.report_row() for p in infos]
    report = "\n".join(lines)
    print(report)
    return report
