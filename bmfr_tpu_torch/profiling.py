"""Timers and the mean/min/max/total report.

Port of :mod:`bmfr_tpu.profiling`: ``ProfilingInfo`` series with the
reference's report (CLUtils.hpp:240-361, printed as at
opencl/bmfr.cpp:489-517) and ``CPUTimer`` (CLUtils.hpp:371-431). PyTorch
returns before the card has run what it launched, so
:func:`device_timer` synchronizes the card before and after the timed
work, the counterpart of the JAX package's readback fence (``force``).
Kernel-level device times come from ``torch.profiler`` (``chip_smoke.py``,
:mod:`~bmfr_tpu_torch.profile_stages`); there is no xplane ``trace``
here. :func:`stage` marks a stage of the frame as a profiler range under
the JAX package's scope name, so a trace groups each kernel under its
stage.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

#: The stages of :func:`~bmfr_tpu_torch.pipeline.denoise.denoise_frame`,
#: in frame order, under the JAX package's scope names
#: (``bmfr_tpu/xplane.py`` ``STAGE_SCOPES``, less the TPU warp's own
#: sub-scopes: the GPU warp is one kernel, or one gather, inside
#: ``warp_taps``).
STAGES = ("warp_taps", "k1_accumulate_noisy", "k2_blockify", "k2_fitter",
          "k3_weighted_sum", "k4_accumulate_filtered", "k5_taa",
          "state_pack")

_NO_RANGE = contextlib.nullcontext()
#: an operator-scope range (``torch.profiler.record_function`` makes a
#: user-scope one)
_OP_RANGE = getattr(torch._C._profiler, "_RecordFunctionFast", None)


def _recording():
    return getattr(_autograd_profiler, "_is_profiler_enabled", True)


#: the range :func:`device_events` can keep a trace's device work to
RUN_RANGE = "profiled_run"
#: microseconds of slack at each end of that range: a trace places the
#: device's events on the host's clock, and the two disagreed by up to
#: 0.7 ms in a traced run on the H100 (a copy launched at the range's
#: start stood 633 us before it; ROADMAP Queue 3)
RUN_SLACK_US = 25000.0


def device_events(events, within=None):
    """The device's own work in a ``torch.profiler`` event list (kernels,
    copies, fills): CUDA events less the spans that mirror a profiler
    range on the device's timeline (those of :data:`STAGES` and
    :data:`RUN_RANGE` among them). With ``within``, the name of a host range of the same trace
    (:data:`RUN_RANGE` around the profiled work), only the events that
    started inside it, give or take :data:`RUN_SLACK_US`: in a long
    process a trace once lost device events and a later trace held
    extra ones, and events that started outside the range are no work of
    the run it traced."""
    work = [e for e in events
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and e.name not in STAGES and e.name != RUN_RANGE]
    if within is None:
        return work
    ranges = [e for e in events if e.name == within
              and e.device_type == torch.autograd.DeviceType.CPU]
    if not ranges:
        raise ValueError(f"the trace holds no host range {within!r}")
    lo = min(e.time_range.start for e in ranges) - RUN_SLACK_US
    hi = max(e.time_range.end for e in ranges) + RUN_SLACK_US
    return [e for e in work if lo <= e.time_range.start <= hi]


#: seconds the card idles inside a trace between a warm-up and
#: :data:`RUN_RANGE` (:func:`traced_run`): twice :data:`RUN_SLACK_US`, so
#: no event of the warm-up counts as the run's
TRACE_GUARD_S = 0.05


@contextlib.contextmanager
def traced_run(activities, warm=None):
    """``torch.profiler.profile(activities=...)`` around a
    :data:`RUN_RANGE` range; yields the profiler. ``warm``: work run
    inside the trace before the range (then the card is synchronized and
    idles :data:`TRACE_GUARD_S`). On the card the trace of a run of eager
    frames loses the first kernel the run launches, unless the same work
    ran earlier in the same trace (``scripts/torch_trace_loss.py``):
    pass that work as ``warm``. Synchronize the card before entering and
    at the end of the block."""
    from torch.profiler import profile, record_function

    with profile(activities=activities) as prof:
        if warm is not None:
            warm()
            if torch.cuda.is_available():
                torch.cuda.synchronize()
            time.sleep(TRACE_GUARD_S)
        with record_function(RUN_RANGE):
            yield prof


def stage(name):
    """A ``torch.profiler.record_function`` range named ``name`` (one of
    :data:`STAGES`) while a profiler records, else a no-op: a range costs
    microseconds of host time per frame even with no profiler."""
    if _recording():
        return torch.profiler.record_function(name)
    return _NO_RANGE


def launch_range(name):
    """An operator-scope range named ``name`` around a kernel launched
    outside PyTorch (the kernels' C entry points) while a profiler
    records, else a no-op. The profiler links a kernel to the operator
    range it was launched in, as it links PyTorch's kernels to their
    operators, and from there to the :func:`stage` around it; it links
    no kernel to a user-scope range."""
    if _OP_RANGE is not None and _recording():
        return _OP_RANGE(name)
    return _NO_RANGE


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
