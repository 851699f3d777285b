"""The program's own spans and copy counter (``bmfr_tpu_torch.profiling``)
as per-layer numbers, and the check of a trace's shared clock.

The readers take a reading with, beside the fields of
:class:`benchmark.trace.Reading`, ``program`` (a dict: ``records``, the
``(name, start_ns, end_ns, parent, frame)`` of a stretch run inside
``profiling.recording()``, ``frames``, its frames, and ``counters``, the
named counters' change over them) and ``program_trace`` (the profiler's
host events of the program's spans, ``(name, start us, end us)``, in the
traced range). A reading without them reads None. ``run.py`` passes
neither yet (PERF.md §7 names the edits); ``benchmark/program_readings.py``
takes both on the card.
"""

from __future__ import annotations

import collections


def _program(reading):
    prog = getattr(reading, "program", None)
    if not prog or not prog.get("frames") or not prog.get("records"):
        return None
    return prog


def span_table(records):
    """``{name: (spans, mean us, mean self us)}`` of a recording's
    records (self time: a span's duration less the part its child spans
    cover)."""
    from bmfr_tpu_torch.profiling import self_ns

    n, dur, own = (collections.Counter() for _ in range(3))
    for r, mine in zip(records, self_ns(records)):
        if r is not None:
            n[r[0]] += 1
            dur[r[0]] += r[2] - r[1]
            own[r[0]] += mine
    return {k: (n[k], dur[k] / n[k] / 1e3, own[k] / n[k] / 1e3) for k in n}


def us_per_frame(reading, name, less=None):
    """The program's ``name`` spans' duration a frame, in us, each less its
    child spans named ``less``; None without spans of that name."""
    prog = _program(reading)
    if prog is None:
        return None
    recs = prog["records"]
    total, found = 0, False
    for r in recs:
        if r is not None and r[0] == name:
            total += r[2] - r[1]
            found = True
    if not found:
        return None
    if less is not None:
        parents = {i for i, r in enumerate(recs)
                   if r is not None and r[0] == name}
        total -= sum(r[2] - r[1] for r in recs
                     if r is not None and r[0] == less and r[3] in parents)
    return total / prog["frames"] / 1e3


def entry_us_per_frame(reading):
    """``entry.step`` less its child ``step.run``, us a frame: the entry's
    closure and the result's copy."""
    return us_per_frame(reading, "entry.step", less="step.run")


def load_us_per_frame(reading):
    """``step.load`` (``_Slot.load``: its checks, copies and fill), us a
    frame."""
    return us_per_frame(reading, "step.load")


def replay_us_per_frame(reading):
    """``step.replay`` (the graph's launch and the launch counters'
    advance), us a frame."""
    return us_per_frame(reading, "step.replay")


def step_copies_per_frame(reading):
    """The ``copies`` counter's change a frame: the step's device copies
    and fills outside its kernels."""
    prog = _program(reading)
    if prog is None or "copies" not in prog.get("counters", {}):
        return None
    return prog["counters"]["copies"] / prog["frames"]


def _port_kernels(device):
    from bmfr_tpu_torch.ops._lib import KERNELS

    return sorted(start for name, start, _ in device
                  if any(k in name for k in KERNELS))


def clock_lead(reading):
    """``(smallest lead, leads)`` in us of the traced range: the n-th
    ``step.replay`` span's host start paired with the first port kernel
    it launched, the n-th group of (kernels / replays) port kernels in
    start order; a kernel cannot start before its launch, so a negative
    lead is the trace's clocks' disagreement. None where the range holds
    no replay, or a number of port kernels no multiple of the replays."""
    trace = getattr(reading, "program_trace", None)
    if not trace:
        return None
    replays = sorted(s for name, s, _ in trace if name == "step.replay")
    kernels = _port_kernels(reading.device)
    if not replays or not kernels or len(kernels) % len(replays):
        return None
    k = len(kernels) // len(replays)
    leads = [kernels[i * k] - s for i, s in enumerate(replays)]
    return min(leads), leads


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def idle_in_program_us(reading):
    """Device-idle time while the host was inside an ``entry.step`` span,
    in us, the device's events moved later by the clock's disagreement
    where :func:`clock_lead` finds a negative lead; None without the
    program's trace or a device event."""
    trace = getattr(reading, "program_trace", None)
    if not trace or not reading.device:
        return None
    lead = clock_lead(reading)
    shift = -lead[0] if lead is not None and lead[0] < 0 else 0.0
    busy = _union((s + shift, s + shift + d) for _, s, d in reading.device)
    steps = _union((s, e) for name, s, e in trace if name == "entry.step")
    if not steps:
        return None
    idle, j = 0.0, 0
    for s, e in steps:
        covered = 0.0
        while j < len(busy) and busy[j][1] <= s:
            j += 1
        i = j
        while i < len(busy) and busy[i][0] < e:
            covered += min(e, busy[i][1]) - max(s, busy[i][0])
            i += 1
        idle += (e - s) - covered
    return idle


def idle_in_program_pct(reading):
    """:func:`idle_in_program_us` as a share of the traced range, in %: at
    most ``device_idle_pct``."""
    us = idle_in_program_us(reading)
    if us is None or reading.window_us <= 0:
        return None
    return 100.0 * us / reading.window_us


#: the per-layer metrics these readers serve, by the name each would take
READERS = {
    "entry_us_per_frame.interactive": entry_us_per_frame,
    "load_us_per_frame.interactive": load_us_per_frame,
    "replay_us_per_frame.interactive": replay_us_per_frame,
    "step_copies_per_frame": step_copies_per_frame,
    "idle_in_program_pct": idle_in_program_pct,
}
