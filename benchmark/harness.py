"""One run of one cell: set-up, the measured window (``--trace 0``) or the
traced stretch (``--trace 1``), the check, and the result's line.

The timed path is the program's public per-frame step,
``bmfr_tpu_torch.make_denoise_frame(cfg)``, the counterpart of the JAX
package's jitted step and what a renderer calls once a frame. Set-up
renders the cell's clip onto the card, runs frame 0 eagerly from the
all-zero carry that the configuration names (:func:`.cells.start_state`),
lets frame 1 capture the compiled step (``pipeline/graph.py``) and warms
up; then every frame replays it, the donated carry handed back in, the
frame's inputs already on the card.
"""

from __future__ import annotations

import collections
import gc
import math
import statistics
import sys
import time
from pathlib import Path

import torch

from . import cells, check, scenes, trace, window, yardstick
from .reference.bmfr import settings_from_config

#: top-level module names that may not be loaded in a run: JAX and the JAX
#: package (compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "bmfr_tpu")


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def import_program(root):
    """The program under test, from this checkout and nowhere else."""
    import bmfr_tpu_torch

    origin = Path(bmfr_tpu_torch.__file__).resolve()
    if Path(root).resolve() not in origin.parents:
        raise SystemExit(f"bmfr_tpu_torch comes from {origin}, not from the "
                         f"checkout at {root}")
    return bmfr_tpu_torch


def percentile(values, q):
    """The ``q``-th percentile (nearest rank) of ``values``."""
    v = sorted(values)
    return v[max(0, math.ceil(q / 100 * len(v)) - 1)]


def _fault_step(step, fault):
    """The step broken as a test asks: ``"state_unchanged"`` (the state
    handed back is the one handed in, never updated) or
    ``"answer_altered"`` (a 16x16 corner of every result moved by 0.1)."""
    if fault == "state_unchanged":
        frozen = {}

        def broken(state, *args):
            if "state" not in frozen:
                frozen["state"] = state
            copy = type(state)(*(t.clone() for t in frozen["state"]))
            _, result = step(copy, *args)
            return frozen["state"], result
        return broken
    if fault == "answer_altered":
        def broken(*args):
            state, result = step(*args)
            result = result.clone()
            result[:, :16, :16] += 0.1
            return state, result
        return broken
    raise ValueError(f"unknown fault {fault!r}")


def run_cell(workload, seed, seconds, trace_on, *, device, t_start,
             overrides=None, fault=None, log=sys.stderr):
    """Run cell ``workload`` and return the result's record (a dict).

    ``device``: the card (``torch.device("cuda", 0)``); the CPU serves
    the tests' rehearsal, whose record holds no metric. ``overrides``
    (tests only): keys of the traffic file replaced (a smaller frame, a
    shorter clip), ``check`` and ``trace`` merged. ``fault`` (tests
    only): :func:`_fault_step`'s break of the timed path."""
    cuda = device.type == "cuda"
    bench = cells.load_benchmark()
    cell = cells.cell(bench, workload)
    config = cells.config(bench, cell["config"])
    traffic = cells.traffic(cell["traffic"])
    for k, v in (overrides or {}).items():
        traffic[k] = ({**traffic[k], **v} if isinstance(v, dict) else v)
    if overrides and "width" in overrides:
        config = dict(config, bmfr=dict(config["bmfr"],
                                        image_width=traffic["width"],
                                        image_height=traffic["height"]))
    bt = import_program(cells.ROOT)
    from bmfr_tpu_torch.pipeline.denoise import FrameInputs

    cfg = bt.config.check_supported(bt.BMFRConfig(**config["bmfr"]))
    settings = settings_from_config(config)
    torch.set_num_threads(1)

    planes, cams, offs = scenes.render_clip(traffic, seed, device)
    clip = window.Clip(FrameInputs, planes, cams, offs)
    step = bt.make_denoise_frame(cfg)
    if fault is not None:
        step = _fault_step(step, fault)
    state = cells.start_state(bt, config, cfg, device)
    k = traffic["in_flight"]
    fences = window.events(device, k)
    kept = collections.deque(maxlen=traffic["check"]["ring"])
    run = window.Run()
    # frame 0 eagerly, frame 1 captures the compiled step, then warm-up
    state, t = window.drive(step, state, clip, 0, k, fences,
                            frames=1 + traffic["warm_frames"], keep=kept,
                            run=run)
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = time.perf_counter() - t_start

    metrics, dev_info, extra = {}, {}, {}
    window_run = window.Run()
    if not trace_on:
        t0 = time.perf_counter()
        state, t = window.drive(step, state, clip, t, k, fences,
                                deadline=t0 + seconds, keep=kept,
                                run=window_run)
        wall = time.perf_counter() - t0
        lat = window_run.latencies
        print(f"[window] {window_run.frames} frames in {wall:.4f} s; "
              f"latency median {statistics.median(lat) * 1e3:.4f} ms, p95 "
              f"{percentile(lat, 95) * 1e3:.4f} ms over {len(lat)} frames",
              file=log)
        values = {"ms_per_frame": wall / max(window_run.frames, 1) * 1e3,
                  "frame_p95_ms": percentile(lat, 95) * 1e3,
                  "setup_s": setup_s}
        for m in cells.end_to_end(bench, workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    else:
        spans_run = window.Run()
        state, t = window.drive(step, state, clip, t, k, fences,
                                frames=traffic["trace"]["host_span_frames"],
                                keep=kept, run=spans_run, spans=True)
        if cuda:
            from torch.profiler import record_function

            def stretch_of(n):
                def go():
                    nonlocal state, t
                    state, t = window.drive(
                        step, state, clip, t, k, fences, frames=n, keep=kept,
                        run=window_run, annotate=record_function)
                    torch.cuda.synchronize(device)
                    return n
                return go

            reading = trace.traced(
                stretch_of(traffic["trace"]["frames"]),
                stretch_of(traffic["trace"]["warm_frames"]), device,
                settings, config, spans_run.host_spans, log)
            for m in cells.per_layer(bench, workload):
                value = yardstick.load("metrics", m["name"]).read(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            dev_info = {"busy_s": reading.busy_us / 1e6,
                        "window_s": reading.window_us / 1e6}
            extra["breakdown"] = trace.breakdown(reading)
        run.frames += spans_run.frames
        run.failed += spans_run.failed
    attempted = run.frames + run.failed + window_run.frames + window_run.failed
    failed = run.failed + window_run.failed

    if cuda:
        torch.cuda.synchronize(device)
        dev_info = {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device),
                    "count": 1,
                    "memory_peak_bytes": torch.cuda.max_memory_allocated(
                        device), **dev_info}
    else:
        dev_info = {"platform": "cpu", "kind": "cpu", "count": 1}

    # the check: the program's outputs kept, the program freed
    carry = {k2: v.clone() for k2, v in check.carried(config, state).items()}
    results = dict(kept)
    last_t = t - 1
    del step, state, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = dict(traffic["check"], limits=config["correct"]["limits"])
    t0 = time.perf_counter()
    got, compared = check.compare(settings, clip, results, carry, last_t,
                                  seed, limits)
    print(f"[check] the reference over frames up to {last_t}: "
          f"{time.perf_counter() - t0:.3f} s; {got}", file=log)
    correct = failed == 0 and check.passed(compared)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {found}: the benchmark runs the "
                         "port without JAX or the JAX package")
    record = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics if cuda else {}, "device": dev_info,
              **extra,
              "compared": {k2: {"value": v, "limit": lim}
                           for k2, (v, lim) in compared.items()}}
    for k2, (v, lim) in compared.items():
        print(f"compared {k2} {v!r} limit {lim!r}", file=log)
    return record
