"""The traced stretch of a ``--trace 1`` run and what the per-layer
metrics read from it.

A bounded run of steady frames inside ``torch.profiler`` (CPU and CUDA
activities): the same loop first warms up inside the trace (a trace
loses the first device events of the work it starts with), the card is
synchronized and idles 50 ms, and then ``frames`` frames run inside the
host range ``bench.window``, each step call inside ``bench.step`` and
each wait inside ``bench.wait``. The trace must hold one device event of
the port's kernels for each launch the program's own counters tallied in
that range (the compiled step's replays count their captured launches);
one that lost or gained events is taken again, and after three such
traces the run fails. The device events kept are those that started
inside the range, give or take 25 ms (the device's and the host's clocks
disagreed by up to 0.7 ms in a trace on the H100). Each device event
kept is put down to the CUDA graph replay that ran it, where one did: the
``cudaGraphLaunch`` call whose correlation id it carries.
"""

from __future__ import annotations

import bisect
import collections
import dataclasses
import time

import torch

RANGE = "bench.window"
SLACK_US = 25000.0
GUARD_S = 0.05
ATTEMPTS = 3


@dataclasses.dataclass
class Reading:
    """What a traced stretch gives the per-layer metrics' readers."""

    settings: object           # the reference's Settings of the cell
    config: dict               # the configuration file
    frames: int                # frames inside the range
    window_us: float           # the range's host duration
    busy_us: float             # the union of the device events' spans
    device: list               # (name, start us, duration us) in the range
    host_spans_s: list         # the step call's host span, untraced frames
    gaps: list                 # (what the host was doing, idle us)
    #: for each of ``device``, the correlation id of the graph launch that
    #: ran it, or None where no graph replay ran it
    replay_of: list = dataclasses.field(default_factory=list)


def _union_us(spans):
    total, end = 0.0, -float("inf")
    for start, stop in sorted(spans):
        if stop <= end:
            continue
        total += stop - max(start, end)
        end = stop
    return total


def _host_activity(cpu, starts, t):
    """The innermost host event covering host time ``t`` (us): of the
    events sorted by start (``starts`` their starts), the latest to start
    at or before ``t`` that has not ended, looked for among the 512
    latest."""
    i = bisect.bisect_right(starts, t) - 1
    for i in range(i, max(i - 512, -1), -1):
        name, start, stop = cpu[i]
        if stop >= t:
            return name
    return "(no host range)"


def _range(events):
    cuda = torch.autograd.DeviceType.CUDA
    ranges = [e for e in events if e.name == RANGE
              and e.device_type != cuda]
    if not ranges:
        raise RuntimeError(f"the trace holds no host range {RANGE!r}")
    return (min(e.time_range.start for e in ranges),
            max(e.time_range.end for e in ranges))


def _device_events(events, stages, lo, hi):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in events
            if e.device_type == cuda
            and not getattr(e, "is_user_annotation", False)
            and e.name not in stages
            and not e.name.startswith("bench.")
            and lo - SLACK_US <= e.time_range.start <= hi + SLACK_US]


def replay_of(events, stages):
    """For each device event that :func:`reduce_events` keeps, in its
    order, the correlation id of the ``cudaGraphLaunch`` call that ran it
    (a graph's kernels carry their launch's id), or None."""
    cuda = torch.autograd.DeviceType.CUDA
    launches = {e.id for e in events
                if e.device_type != cuda and e.name == "cudaGraphLaunch"}
    return [e.id if e.id in launches else None
            for e in _device_events(events, stages, *_range(events))]


def reduce_events(events, stages):
    """``(device events in the range, range start, range end, host
    events)`` of a profiler event list. ``stages``: the port's profiler
    ranges, which mirror on the device's timeline and are no work."""
    cuda = torch.autograd.DeviceType.CUDA
    lo, hi = _range(events)
    device = [(e.name, e.time_range.start, e.time_range.elapsed_us())
              for e in _device_events(events, stages, lo, hi)]
    cpu = sorted((e.name, e.time_range.start, e.time_range.end)
                 for e in events
                 if e.device_type != cuda and e.name != RANGE
                 and lo <= e.time_range.start <= hi)
    return device, lo, hi, cpu


def traced(stretch, warm, device, settings, config, host_spans, log):
    """Trace ``stretch()`` (which returns the frames it ran, all
    completed) after ``warm()``; returns a :class:`Reading`."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from bmfr_tpu_torch.ops import _lib
    from bmfr_tpu_torch.profiling import STAGES

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for attempt in range(1, ATTEMPTS + 1):
        torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            warm()
            torch.cuda.synchronize(device)
            time.sleep(GUARD_S)
            with _lib.tally_launches() as tally, record_function(RANGE):
                frames = stretch()
        events = prof.events()
        dev, lo, hi, cpu = reduce_events(events, STAGES)
        replays = replay_of(events, STAGES)
        del events, prof
        want = sum(tally.values())
        got = sum(1 for name, _, _ in dev
                  if any(k in name for k in _lib.KERNELS))
        in_replays = [r for r in replays if r is not None]
        print(f"[trace {attempt}] {got} device events of the port's kernels "
              f"for {want} launches counted, {len(dev)} device events in "
              f"{frames} frames; {len(in_replays)} of them in "
              f"{len(set(in_replays))} graph replays", file=log)
        if got == want:
            break
    else:
        raise RuntimeError(f"{ATTEMPTS} traces lost or gained device events "
                           "of the port's kernels")
    spans = sorted((start, start + dur) for _, start, dur in dev)
    cpu.sort(key=lambda e: e[1])
    starts = [e[1] for e in cpu]
    gaps = collections.Counter()
    end = lo
    for start, stop in spans:
        if start > end:
            gaps[_host_activity(cpu, starts, (start + end) / 2)] += (
                start - end)
        end = max(end, stop)
    if hi > end:
        gaps[_host_activity(cpu, starts, (hi + end) / 2)] += hi - end
    return Reading(settings=settings, config=config, frames=frames,
                   window_us=hi - lo, busy_us=_union_us(spans), device=dev,
                   host_spans_s=host_spans, gaps=gaps.most_common(),
                   replay_of=replays)


def breakdown(reading):
    """The device operations that took most time and the longest idle
    time by what the host was doing, seconds in the traced range."""
    ops = collections.Counter()
    for name, _, dur in reading.device:
        ops[name[:120]] += dur / 1e6
    return {"device_ops": [[n, s] for n, s in ops.most_common(10)],
            "idle_gaps": [[n, us / 1e6] for n, us in reading.gaps[:10]]}
