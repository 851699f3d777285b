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

:func:`span` marks a layer's host work inside the per-frame step (the
names of :data:`SPANS`): a no-op unless :func:`recording` keeps spans in
memory or a profiler records, where it is an operator-scope range on the
trace's host timeline. :func:`count` and :func:`counters` are named
counters, always on (``copies``: the device copies and fills the
compiled step enqueues outside its kernels, and the entry's copy of the
result; ``inputs_in_place``: the inputs a replay reads where the caller
holds them).
"""

from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time
from dataclasses import dataclass, field

import torch
import torch.autograd.profiler as _autograd_profiler

from .ops import _lib

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


#: the spans of the per-frame step, by layer (PERF.md §3): the entry,
#: ``make_denoise_frame``'s step (``entry.step``, the result's copy
#: ``entry.clone``), the eager frame ``entry.eager`` (opened by
#: ``CompiledStep.run_scenes`` for every driver), and the compiled step
#: (``CompiledStep.run_scenes`` ``step.run``, a slot's ``_Slot.load``
#: ``step.load``, the graph's launch and the launch counters' advance
#: ``step.replay``)
SPANS = ("entry.step", "entry.clone", "entry.eager", "step.run",
         "step.load", "step.replay")
#: the spans one :func:`recording` keeps at most; later ones are dropped
RECORD_LIMIT = 1 << 18

_ACTIVE = None                  # the open Recording
_OPEN = threading.local()       # this thread's open recorded spans
_COUNTS = collections.Counter()


class Recording:
    """The spans kept by one :func:`recording` block. ``records``: one
    ``(name, start_ns, end_ns, parent, frame)`` per span, in the order
    the spans opened, on ``time.perf_counter_ns()``'s clock; ``parent``
    is the index of the enclosing recorded span on the same thread (None
    for a root), ``frame`` the frame the root span was given (None if
    none); a span still open when the block ends stays None. ``dropped``:
    the spans left out once ``limit`` were kept."""

    def __init__(self, limit):
        self.records = [None] * limit
        self.dropped = 0
        self.limit = limit
        self._next = itertools.count()
        self._open = True

    def _close(self):
        self._open = False
        del self.records[min(next(self._next), self.limit):]


class _Span:
    __slots__ = ("name", "frame", "rec", "op", "index", "parent", "start")

    def __init__(self, name, frame, rec):
        self.name, self.frame, self.rec = name, frame, rec
        self.op = (_OP_RANGE(name) if _OP_RANGE is not None and _recording()
                   else None)

    def __enter__(self):
        if self.op is not None:
            self.op.__enter__()
        rec = self.rec
        if rec is not None:
            i = next(rec._next)
            if i >= rec.limit:
                with _lib._COUNT_LOCK:
                    rec.dropped += 1
                self.rec = None
                return self
            stack = getattr(_OPEN, "stack", None)
            if stack is None:
                stack = _OPEN.stack = []
            if stack:
                self.parent, self.frame = stack[-1]
            else:
                self.parent = None
            self.index = i
            stack.append((i, self.frame))
            self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        rec = self.rec
        if rec is not None:
            end = time.perf_counter_ns()
            _OPEN.stack.pop()
            if rec._open:
                rec.records[self.index] = (self.name, self.start, end,
                                           self.parent, self.frame)
        if self.op is not None:
            self.op.__exit__(*exc)
        return False


def span(name, frame=None):
    """A span of host work named ``name`` (one of :data:`SPANS`).

    Off (no :func:`recording` open, no profiler recording) it returns the
    shared no-op context. Inside :func:`recording` it keeps ``(name,
    start_ns, end_ns, parent, frame)``; ``frame``, given to a root span,
    is shared by the spans inside it. While a profiler records it is
    also an operator-scope range of its name (as :func:`launch_range`),
    on the trace's host timeline beside the device's events."""
    rec = _ACTIVE
    if rec is None and not _autograd_profiler._is_profiler_enabled:
        return _NO_RANGE
    return _Span(name, frame, rec)


@contextlib.contextmanager
def recording(limit=RECORD_LIMIT):
    """Keep every :func:`span` of the process in memory for the block's
    duration; yields the :class:`Recording`. One at a time."""
    global _ACTIVE
    if _ACTIVE is not None:
        raise RuntimeError("spans are already being recorded")
    rec = _ACTIVE = Recording(limit)
    try:
        yield rec
    finally:
        _ACTIVE = None
        rec._close()


def self_ns(records):
    """Each record's self time in ns: its duration less the part of it
    that its child spans (the records whose ``parent`` is its index)
    cover; None where the record is None."""
    children = collections.defaultdict(list)
    for r in records:
        if r is not None and r[3] is not None:
            children[r[3]].append((r[1], r[2]))
    out = []
    for i, r in enumerate(records):
        if r is None:
            out.append(None)
            continue
        covered, end = 0, r[1]
        for s, e in sorted(children.get(i, ())):
            s, e = max(s, end), min(e, r[2])
            if e > s:
                covered += e - s
                end = e
        out.append(r[2] - r[1] - covered)
    return out


def count(name, n=1):
    """Add ``n`` to counter ``name`` (under the launch counters' lock:
    several threads step at once). Always on; apart from
    :func:`~bmfr_tpu_torch.ops._lib.tally_launches`."""
    with _lib._COUNT_LOCK:
        _COUNTS[name] += n


def counters():
    """The named counters' values, a dict."""
    with _lib._COUNT_LOCK:
        return dict(_COUNTS)


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
