"""The program's spans, copy counter and the trace's shared clock in a
cell, on the card: what ``benchmark/program.py``'s readers read.

    python3 benchmark/program_readings.py --seed 12345 \\
        --workload flagship.orbit.interactive [--workload ...] \\
        [--frames 2000] [--trace-frames 400]

Each cell is set up as ``run.py`` sets it up (its clip rendered from the
seed, frame 0 eager, the capture, the traffic's warm-up), then runs three
stretches of the renderer's loop (``benchmark/window.py``):

1. ``--frames`` frames, the step call's host span taken as ``--trace 1``
   takes ``host_us_per_frame.interactive``, the program's spans off;
2. as many again inside ``profiling.recording()``: the program's spans
   and the ``copies`` and ``inputs_in_place`` counters' changes; the
   ``[program]`` line gives each span's mean and self us a frame, the
   copies and the inputs read in place a frame and the spans' cost when
   on (stretch 2's host span less stretch 1's);
3. ``--trace-frames`` frames traced as ``benchmark/trace.py`` traces them
   (the same warm-up inside the trace, the launches held to the trace's
   port kernels), keeping the program's spans' host events: the
   ``[clock]`` line pairs each ``step.replay`` with the first port
   kernel it launched; the idle time by the host's innermost range, as
   the trace stands and with the device's events moved later by a
   negative lead.

Prints a ``[span cost]`` line (a span off, in memory and in a
profiler, ns) once, and one JSON
line per cell on standard output. Not part of a benchmark run: run in one
process, on one CPU as ``run.py`` is.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import os
import statistics
import sys
import time
import timeit
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def span_cost_ns(n=100000):
    """A span's cost, ns: ``with span(...)`` less an empty call, off, in
    memory (``recording()``) and inside a profiler of the host and the
    card; best of five."""
    from torch.profiler import ProfilerActivity, profile

    from bmfr_tpu_torch.profiling import recording, span

    def off():
        with span("entry.step", 1):
            pass

    def empty():
        pass

    def best(reps):
        return min(timeit.timeit(off, number=reps)
                   - timeit.timeit(empty, number=reps)
                   for _ in range(5)) / reps * 1e9

    cost = {"off": best(n)}
    with recording(limit=12 * n):
        cost["in memory"] = best(n)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        cost["in a profiler"] = best(n // 20)
    return cost


def traced(stretch, warm, device):
    """``(reduced events, launches)`` of ``stretch()`` traced as
    ``trace.traced`` traces it (retaken up to three times until the port's
    kernels in the trace equal the launches counted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchmark import trace
    from bmfr_tpu_torch.ops import _lib
    from bmfr_tpu_torch.profiling import STAGES

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    for _ in range(trace.ATTEMPTS):
        torch.cuda.synchronize(device)
        with profile(activities=acts) as prof:
            warm()
            torch.cuda.synchronize(device)
            time.sleep(trace.GUARD_S)
            with _lib.tally_launches() as tally, \
                    record_function(trace.RANGE):
                stretch()
        reduced = trace.reduce_events(prof.events(), STAGES)
        del prof
        want = sum(tally.values())
        got = sum(1 for name, _, _ in reduced[0]
                  if any(k in name for k in _lib.KERNELS))
        if got == want:
            return reduced, want
        print(f"[trace] {got} port kernels for {want} launches: again",
              file=sys.stderr)
    raise RuntimeError("the traces lost or gained port kernels")


def idle_by_host(spans, cpu, lo, hi):
    """The device's idle time in ``[lo, hi]`` by the host's innermost
    range at each gap's middle, as ``trace.traced`` names it: ``spans``
    the device's (start, end) sorted, ``cpu`` the host events sorted by
    start."""
    from benchmark import trace

    starts = [e[1] for e in cpu]
    gaps, end = collections.Counter(), lo
    for start, stop in spans:
        if start > end:
            gaps[trace._host_activity(cpu, starts, (start + end) / 2)] += (
                start - end)
        end = max(end, stop)
    if hi > end:
        gaps[trace._host_activity(cpu, starts, (hi + end) / 2)] += hi - end
    return gaps


def read_cell(workload, seed, frames, trace_frames, device):
    import torch

    from benchmark import cells, program, scenes, trace, window
    from benchmark.harness import import_program
    from benchmark.reference.bmfr import settings_from_config
    from bmfr_tpu_torch import profiling
    from bmfr_tpu_torch.pipeline.denoise import FrameInputs

    bench = cells.load_benchmark()
    cell = cells.cell(bench, workload)
    config = cells.config(bench, cell["config"])
    traffic = cells.traffic(cell["traffic"])
    bt = import_program(ROOT)
    cfg = bt.config.check_supported(bt.BMFRConfig(**config["bmfr"]))
    planes, cams, offs = scenes.render_clip(traffic, seed, device)
    clip = window.Clip(FrameInputs, planes, cams, offs)
    step = bt.make_denoise_frame(cfg)
    k = traffic["in_flight"]
    fences = window.events(device, k)
    start = cells.start_state(bt, config, cfg, device)
    state, t = window.drive(step, start, clip, 0, k, fences,
                            frames=1 + traffic["warm_frames"],
                            run=window.Run())
    torch.cuda.synchronize(device)
    gc.collect()

    off = window.Run()
    state, t = window.drive(step, state, clip, t, k, fences, frames=frames,
                            run=off, spans=True)
    on = window.Run()
    before = profiling.counters()
    with profiling.recording() as rec:
        state, t = window.drive(step, state, clip, t, k, fences,
                                frames=frames, run=on, spans=True)
    copies, in_place = (profiling.counters().get(n, 0) - before.get(n, 0)
                        for n in ("copies", "inputs_in_place"))
    host_off = statistics.fmean(off.host_spans) * 1e6
    host_on = statistics.fmean(on.host_spans) * 1e6
    table = program.span_table(rec.records)
    line = "; ".join(f"{n} {c / on.frames:g}/frame mean {m:.2f} us self "
                     f"{s:.2f} us" for n, (c, m, s) in sorted(table.items()))
    print(f"[program] {workload}: {on.frames} frames: {line}; copies "
          f"{copies / on.frames:g}, inputs in place "
          f"{in_place / on.frames:g} a frame; host span {host_on:.2f} us with "
          f"spans on, {host_off:.2f} us off: on-cost "
          f"{host_on - host_off:.2f} us a frame; dropped {rec.dropped}",
          file=sys.stderr)

    from torch.profiler import record_function

    def stretch_of(n):
        def go():
            nonlocal state, t
            state, t = window.drive(step, state, clip, t, k, fences,
                                    frames=n, run=window.Run(),
                                    annotate=record_function)
            torch.cuda.synchronize(device)
        return go

    (dev, lo, hi, cpu), launches = traced(
        stretch_of(trace_frames), stretch_of(traffic["trace"]["warm_frames"]),
        device)
    spans = sorted((s, s + d) for _, s, d in dev)
    reading = trace.Reading(
        settings=settings_from_config(config), config=config,
        frames=trace_frames, window_us=hi - lo,
        busy_us=trace._union_us(spans), device=dev,
        host_spans_s=off.host_spans, gaps=[])
    reading.program = {"records": rec.records, "frames": on.frames,
                       "counters": {"copies": copies}}
    reading.program_trace = [e for e in cpu if e[0] in profiling.SPANS]
    lead = program.clock_lead(reading)
    if lead is None:
        print(f"[clock] {workload}: no replay to pair", file=sys.stderr)
    else:
        leads = sorted(lead[1])
        print(f"[clock] {workload}: replay to first port kernel, smallest "
              f"lead {lead[0]:.1f} us (median "
              f"{statistics.median(leads):.1f}, {len(leads)} replays)"
              + ("; negative: the device's events moved later by it"
                 if lead[0] < 0 else "; no shift"), file=sys.stderr)

    cpu.sort(key=lambda e: e[1])
    shift = -lead[0] if lead is not None and lead[0] < 0 else 0.0
    gaps = idle_by_host(spans, cpu, lo, hi)
    shifted = idle_by_host([(s + shift, e + shift) for s, e in spans], cpu,
                           lo, hi)

    metrics = {name: read(reading) for name, read in program.READERS.items()}
    record = {
        "workload": workload, "seed": seed,
        "device": torch.cuda.get_device_name(device),
        "metrics": metrics,
        "spans_us": {n: {"per_frame": c / on.frames, "mean": m, "self": s}
                     for n, (c, m, s) in table.items()},
        "host_us_off": host_off, "host_us_on": host_on,
        "on_cost_us": host_on - host_off,
        "copies_per_frame": copies / on.frames,
        "inputs_in_place_per_frame": in_place / on.frames,
        "clock_lead_us": None if lead is None else lead[0],
        "clock_lead_median_us": (None if lead is None
                                 else statistics.median(lead[1])),
        "device_idle_pct": 100.0 * (1 - reading.busy_us / reading.window_us),
        "device_ops_per_frame": len(dev) / trace_frames,
        "port_kernels_per_frame": launches / trace_frames,
        "traced_us_per_frame": reading.window_us / trace_frames,
        "idle_us_per_frame": {n: us / trace_frames
                              for n, us in gaps.most_common(12)},
        "idle_us_per_frame_shifted": {n: us / trace_frames
                                      for n, us in shifted.most_common(12)},
    }
    del step, state, clip, planes, cams, offs, reading, rec
    gc.collect()
    torch.cuda.empty_cache()
    return record


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", action="append", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--frames", type=int, default=2000)
    p.add_argument("--trace-frames", type=int, default=400)
    args = p.parse_args(argv)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the readings are taken on the card")
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    torch.set_num_threads(1)
    cost = span_cost_ns()
    print("[span cost] a span: " + ", ".join(
        f"{state} {ns:.1f} ns" for state, ns in cost.items()),
        file=sys.stderr)
    for i, workload in enumerate(args.workload):
        record = read_cell(workload, args.seed + i, args.frames,
                           args.trace_frames, device)
        print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
