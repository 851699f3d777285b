"""One run of one cell: set-up, the measured window (``--trace 0``) or the
traced stretch (``--trace 1``), the check, and the result's line.

The timed path is the program's entry that the configuration names
(:func:`.cells.entry`). By default it is the public per-frame step,
``bmfr_tpu_torch.make_denoise_frame(cfg)``, the counterpart of the JAX
package's jitted step and what a renderer calls once a frame. Set-up
renders the cell's clip onto the card, runs frame 0 eagerly from the
all-zero carry that the configuration names (:func:`.cells.start_state`),
lets frame 1 capture the compiled step (``pipeline/graph.py``) and warms
up; then every frame replays it, the donated carry handed back in, the
frame's inputs already on the card.

Under ``entry: "denoise_scenes_jit"`` it is the scene runner,
``bmfr_tpu_torch.denoise_scenes_jit(cfg, [card])``, built once; each
call hands it the traffic's S stacked clips of T frames
(:func:`.scenes.render_scenes`), and it denoises every scene from the
zero state: frame 0 eagerly, then one graph of S steps a frame. Set-up
runs ``warm_calls`` calls (the first captures the S-step graph); a call
counts S x T scene-frames, and ``ms_per_frame`` is the window's wall
time over its scene-frames.
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


def _fault_runner(runner, fault):
    """The scene runner broken as a test asks: ``"answer_altered"`` (a
    16x16 corner of every result moved by 0.1), ``"scenes_swapped"``
    (scenes 0 and 1 handed back in each other's place) or
    ``"scenes_halved"`` (the first half of the scenes run, their results
    handed back for the second half too)."""
    def broken(inputs, cams, offs):
        if fault == "scenes_halved":
            half = cams.shape[0] // 2
            out = runner(type(inputs)(*(x[:half] for x in inputs)),
                         cams[:half], offs[:half])
            return torch.cat([out, out])
        out = runner(inputs, cams, offs).clone()
        if fault == "answer_altered":
            out[..., :16, :16] += 0.1
        elif fault == "scenes_swapped":
            out[[0, 1]] = out[[1, 0]]
        else:
            raise ValueError(f"unknown fault {fault!r}")
        return out
    return broken


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
    if cells.entry(config)[0] == "denoise_scenes_jit":
        return _run_clips(bt, bench, workload, config, traffic, cfg,
                          settings, seed, seconds, trace_on, device=device,
                          t_start=t_start, fault=fault, log=log)

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
    dev_info = _device_info(device, dev_info)

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
    return _record(attempted, failed, compared, metrics, dev_info, extra,
                   cuda, log)


def _device_info(device, traced):
    """The result's ``device``, with the traced run's ``traced`` keys."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    torch.cuda.synchronize(device)
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device),
            **traced}


def _record(attempted, failed, compared, metrics, dev_info, extra, cuda,
            log):
    """The result's record, once the window has closed and the check has
    run; raises where the run loaded JAX or the JAX package."""
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


def _run_clips(bt, bench, workload, config, traffic, cfg, settings, seed,
               seconds, trace_on, *, device, t_start, fault, log):
    """:func:`run_cell` for a configuration whose entry is the scene
    runner: the S clips rendered, the runner built once and called with
    at most ``in_flight`` calls not yet completed, and the last call's
    results checked (:func:`.check.compare_clips`)."""
    from bmfr_tpu_torch.pipeline.denoise import FrameInputs

    cuda = device.type == "cuda"
    _, S = cells.entry(config)
    if traffic["scenes"] != S:
        raise SystemExit(f"the configuration runs {S} scenes a call, the "
                         f"traffic {traffic['name']!r} renders "
                         f"{traffic['scenes']}")
    carry = type(bt.zero_state(cfg, device)).__name__
    if carry != config["carry"]:
        raise SystemExit(f"the configuration states a {config['carry']!r} "
                         f"carry; the scene runner carries a {carry}")
    batch = window.Scenes(FrameInputs,
                          *scenes.render_scenes(traffic, seed, device))
    runner = bt.denoise_scenes_jit(cfg, [device])
    if fault is not None:
        runner = _fault_runner(runner, fault)
    k = traffic["in_flight"]
    fences = window.events(device, k)
    kept = collections.deque(maxlen=1)
    run = window.Run()
    # the first call captures the S-step graph
    window.drive_calls(runner, batch, k, fences,
                       calls=traffic["warm_calls"], keep=kept, run=run)
    if cuda:
        torch.cuda.synchronize(device)
    gc.collect()
    setup_s = time.perf_counter() - t_start

    metrics, dev_info, extra = {}, {}, {}
    window_run = window.Run()
    if not trace_on:
        t0 = time.perf_counter()
        n = window.drive_calls(runner, batch, k, fences,
                               deadline=t0 + seconds, keep=kept,
                               run=window_run)
        wall = time.perf_counter() - t0
        lat = window_run.latencies
        median = statistics.median(lat) * 1e3 if lat else math.nan
        print(f"[window] {n} calls, {window_run.frames} scene-frames in "
              f"{wall:.4f} s; call latency median {median:.4f} ms", file=log)
        values = {"ms_per_frame": wall / max(window_run.frames, 1) * 1e3,
                  "setup_s": setup_s}
        for m in cells.end_to_end(bench, workload):
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    elif cuda:
        from torch.profiler import record_function

        def stretch_of(n):
            def go():
                before = window_run.frames
                window.drive_calls(runner, batch, k, fences, calls=n,
                                   keep=kept, run=window_run,
                                   annotate=record_function)
                torch.cuda.synchronize(device)
                return window_run.frames - before
            return go

        reading = trace.traced(stretch_of(traffic["trace"]["calls"]),
                               stretch_of(traffic["trace"]["warm_calls"]),
                               device, settings, config, [], log)
        for m in cells.per_layer(bench, workload):
            value = yardstick.load("metrics", m["name"]).read(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        dev_info = {"busy_s": reading.busy_us / 1e6,
                    "window_s": reading.window_us / 1e6}
        extra["breakdown"] = trace.breakdown(reading)
    attempted = run.frames + run.failed + window_run.frames + window_run.failed
    failed = run.failed + window_run.failed
    dev_info = _device_info(device, dev_info)

    # the check: the last call's results kept, the runner freed
    results = kept[-1] if kept else None
    del runner, kept
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    limits = dict(traffic["check"], limits=config["correct"]["limits"])
    t0 = time.perf_counter()
    if results is None:
        got, compared = {}, {k2: (math.nan, lim)
                             for k2, lim in limits["limits"].items()}
    else:
        got, compared = check.compare_clips(settings, batch, results, seed,
                                            limits)
    print(f"[check] the reference over {batch.S} scenes of frames 0.."
          f"{batch.T - 1}: {time.perf_counter() - t0:.3f} s; {got}",
          file=log)
    return _record(attempted, failed, compared, metrics, dev_info, extra,
                   cuda, log)
