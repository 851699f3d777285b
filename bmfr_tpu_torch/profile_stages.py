"""Per-stage profile of the frame: the reference's per-kernel report.

Port of :mod:`bmfr_tpu.profile_stages`. The reference times each of its
five kernels per frame with events (opencl/bmfr.cpp:386-412, :489-517).
Here, on a steady mid-sequence transition of the synthetic orbit scene
(frame 4, after four eager frames built the state):

- the default report times each stage of
  :func:`~bmfr_tpu_torch.pipeline.denoise.denoise_frame` standalone
  (``--reps`` calls, the card synchronized around each: launch overhead
  included, so the rows do not sum to the frame), plus the full frame,
  eager and compiled (:class:`~bmfr_tpu_torch.pipeline.graph.
  CompiledStep`, the graph replayed on the inputs where they lie);
- ``--trace`` (the counterpart of ``--xplane``) runs ``--reps`` eager
  steady frames under ``torch.profiler`` and gives each stage the device
  time of the kernels launched inside its range (:func:`~bmfr_tpu_torch.
  profiling.stage`, the JAX package's scope names), plus the kernels
  outside every range ``(unattributed)`` and the total: these rows sum to
  the frame's device time. Kernel H runs inside ``warp_taps``, G inside
  ``k1_accumulate_noisy`` and F inside ``k5_taa``, so on the kernel path
  ``k4_accumulate_filtered`` and ``state_pack`` hold no work, as the
  direct fitters leave ``k2_blockify`` and ``k3_weighted_sum`` empty. On
  the card the trace must hold one device event of the port's kernels
  for each launch counted (:func:`check_launches`). On the CPU there is
  no device, and the rows are the operators' host time (the plain
  versions open the K4 and pack ranges inside G's and F's);
- :func:`sequence_trace_report` (``scripts/torch_trace_scan.py``, the
  counterpart of ``scripts/trace_scan.py``) splits a whole sequence, the
  one ``python -m bmfr_tpu_torch.bench`` times, by stage.

The flags' defaults are the JAX parser's: 1280x720, 5 reps,
``--warp-mode packed_x_bf16``; the port's own flags (``--fitter-impl``,
``--solver``, ``--tmp-dtype``, ``--residual-dtype``) default to the
configuration the JAX command profiles, ``BMFRConfig``'s defaults.

    python -m bmfr_tpu_torch.profile_stages          # JAX's default config
    python -m bmfr_tpu_torch.profile_stages --trace --warp-mode pallas \\
        --fitter-impl pallas_direct --solver cholesky --residual-dtype bfloat16
    python -m bmfr_tpu_torch.profile_stages --device cpu --width 64 --height 48
"""

from __future__ import annotations

import argparse
import time
from collections import Counter

import torch

from .config import BMFRConfig
from .io.fixtures import synthetic_sequence
from .ops import _lib
from .ops.blockify import build_feature_blocks
from .ops.fitter import fit_blocks
from .ops.reproject import noisy_tail, reproject_coords
from .ops.tail import filtered_tail
from .ops.weighted_sum import weighted_sum
from .pipeline import denoise
from .pipeline.denoise import (FrameInputs, PackedState, PreviousCameras,
                               denoise_frame, denoise_sequence,
                               frame_inputs_from_numpy, zero_state)
from .pipeline.graph import CompiledStep
from .profiling import (RUN_RANGE, STAGES, ProfilingInfo, device_events,
                        print_report, synchronize, traced_run)

#: the steady frame profiled (frame 0 -> 1 of the scene is a camera
#: jump: it is not the typical frame)
FRAME = 4


def _device_arg(text):
    if text in ("cpu", "cuda"):
        return torch.device(text)
    return torch.device("cuda", int(text))


def _build_argparser():
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--device", type=_device_arg, default="cuda",
                   help="'cuda' (the current card), a card index or 'cpu'")
    p.add_argument("--warp-mode", default="packed_x_bf16",
                   choices=["float32", "packed_bf16", "packed_x_bf16",
                            "pallas"])
    p.add_argument("--fitter-impl", default="auto",
                   choices=["auto", "xla", "pallas", "pallas_direct"])
    p.add_argument("--solver", default="householder",
                   choices=["householder", "cholesky"])
    p.add_argument("--tmp-dtype", default="float32",
                   choices=["float32", "float16", "bfloat16"])
    p.add_argument("--residual-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--trace", action="store_true",
                   help="per-stage device ms from one torch.profiler pass "
                        "of the eager steady step (sums to the frame)")
    return p


def steady_setup(cfg, device):
    """``(state, inputs, prev_cam, offset)`` of frame :data:`FRAME` of the
    orbit scene, the state from eager frames 0..FRAME-1."""
    sc = synthetic_sequence(width=cfg.image_width, height=cfg.image_height,
                            frames=FRAME + 1)
    seq = frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                  sc["noisy"], sc["albedo"], device)
    cams = torch.from_numpy(sc["camera_matrices"]).to(device)
    offs = torch.from_numpy(sc["pixel_offsets"]).to(device)
    state, lag = zero_state(cfg, device), PreviousCameras(cams)
    for t in range(FRAME):
        state, _ = denoise_frame(cfg, state,
                                 FrameInputs(*(x[t] for x in seq)), lag[t],
                                 offs[t], t)
    return (state, FrameInputs(*(x[FRAME] for x in seq)), lag[FRAME],
            offs[FRAME])


def _timed(label, fn, reps, device, note=""):
    """``fn()`` once to warm, then ``reps`` calls each between two
    synchronizations; returns (the row, fn's last output)."""
    out = fn()
    info = ProfilingInfo(label + note)
    for _ in range(reps):
        synchronize(device)
        t0 = time.perf_counter()
        out = fn()
        synchronize(device)
        info.append((time.perf_counter() - t0) * 1e3)
    return info, out


def stage_report(cfg, state, inputs, cam, off, reps, device):
    """The standalone stage rows and the full frame, eager and compiled.
    Returns the rows."""
    f = FRAME
    direct = cfg.fitter_impl == "pallas_direct"
    rows = []

    def run(name, fn, note=""):
        row, out = _timed(name, fn, reps, device, note)
        rows.append(row)
        return out

    def idle(name, why):
        rows.append(ProfilingInfo(f"{name} ({why})"))

    def warp():
        prev_pixels = reproject_coords(cfg, inputs.positions, cam, off)
        return prev_pixels, denoise._warp_planes(
            cfg, state, inputs, *prev_pixels, True, False)[0]

    # kernels G and F pack the next state's words into a scratch copy
    pack = (torch.empty_like(state.src8) if isinstance(state, PackedState)
            else None)
    prev_pixels, planes = run("warp_taps", warp)
    k1 = run("k1_accumulate_noisy", lambda: noisy_tail(
        cfg, inputs.noisy, prev_pixels, planes, inputs.positions,
        inputs.normals, f, pack=pack))
    if direct:
        idle("k2_blockify", "in the fitter kernel on this path")
        filtered = run("k2_fitter", lambda: denoise._filter(
            cfg, inputs, k1["accum"], f, False)[0])
        idle("k3_weighted_sum", "in the fitter kernel on this path")
    else:
        tmp = run("k2_blockify", lambda: build_feature_blocks(
            cfg, inputs.normals, inputs.positions, k1["accum"], f))
        w, mm = run("k2_fitter", lambda: fit_blocks(cfg, tmp, f))
        filtered = run("k3_weighted_sum", lambda: weighted_sum(
            cfg, w, mm, inputs.normals, inputs.positions, k1["accum"], f,
            feature_blocks=tmp))
    idle("k4_accumulate_filtered", "in kernel F, k5_taa")
    run("k5_taa", lambda: filtered_tail(
        cfg, filtered, planes, inputs.albedo, k1["spp"], k1["prev_pixels"],
        f, pack=pack))
    idle("state_pack", "in kernels G and F" if pack is not None
         else "eager: the state is this frame's planes (the compiled "
              "step's G and F write its carry)")

    eager_state = (PackedState(state.src8.clone())
                   if isinstance(state, PackedState) else state)
    run("full frame, eager", lambda: denoise_frame(
        cfg, eager_state, inputs, cam, off, f))
    if device.type == "cuda":
        compiled = CompiledStep(cfg)
        carry = [compiled.run(state, inputs, cam, off, f)[0]]  # the capture

        def replay():
            carry[0], outputs = compiled.run(carry[0], inputs, cam, off, f)
            return outputs["result"]

        capture_s = compiled.capture_seconds[
            (type(state).__name__, str(device), 1)]
        run("full frame, compiled (CUDA graph)", replay,
            f" [capture {capture_s:.3f} s]")
    else:
        idle("full frame, compiled (CUDA graph)", "needs a card")
    return rows


def _runtime_call(name):
    """A CUDA runtime or driver call's event (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ...): its id is the runtime's correlation id,
    which may equal an operator's, and the profiler then lists that
    operator's kernels under it too."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


def _stage_of(event):
    """The stage range ``event`` ran in, if it ran in the traced run's
    :data:`~bmfr_tpu_torch.profiling.RUN_RANGE` (a warm-up before that
    range is no work of the run)."""
    stage_name = None
    while event is not None:
        if event.name in STAGES and stage_name is None:
            stage_name = event.name
        if event.name == RUN_RANGE:
            return stage_name
        event = event.cpu_parent
    return None


def _in_run(event):
    while event is not None:
        if event.name == RUN_RANGE:
            return True
        event = event.cpu_parent
    return False


def _attribute(events, cuda):
    """Group a ``torch.profiler`` event list of work run inside a
    :data:`~bmfr_tpu_torch.profiling.RUN_RANGE` range by stage, in
    microseconds: ``(per_stage, total, loose, inside)``, with ``loose`` the
    work outside every stage range by name (``{name: (count, us)}``) and
    ``inside`` each stage's work by ``(stage, name)``. On the card the
    work is the device's kernels that started inside the run's range, each
    under the stage range it was launched in; on the CPU, the operators'
    host self time."""
    per = dict.fromkeys(STAGES, 0.0)
    inside, named = Counter(), Counter()
    for e in events:
        if cuda:
            s = (_stage_of(e) if e.kernels and not _runtime_call(e.name)
                 else None)
            # a range's own span on the device timeline is no work
            done = [(k.name, k.duration) for k in e.kernels
                    if k.name not in STAGES] if s else []
        else:
            s = _stage_of(e) if e.name not in STAGES else None
            done = [(e.name, e.self_cpu_time_total)] if s else []
        for name, us in done:
            per[s] += us
            inside[s, name] += us
            named[name] += 1
    work = ([(e.name, e.time_range.elapsed_us())
             for e in device_events(events, within=RUN_RANGE)] if cuda else
            [(e.name, e.self_cpu_time_total) for e in events
             if e.name not in STAGES + (RUN_RANGE,) and _in_run(e)])
    count, us = Counter(), Counter()
    for name, t in work:
        count[name] += 1
        us[name] += t
    for (_, name), t in inside.items():
        us[name] -= t
    loose = {name: (count[name] - named[name], us[name]) for name in count
             if count[name] > named[name]}
    return per, sum(t for _, t in work), loose, inside


def check_launches(label, events, tally, log=None):
    """Whether a trace's ``events`` (a :func:`~bmfr_tpu_torch.
    profiling.traced_run`'s) hold, inside its run's range, one device
    event of the port's kernels (:data:`~bmfr_tpu_torch.ops._lib.
    KERNELS`) for each launch that ``tally`` (a :func:`~bmfr_tpu_torch.
    ops._lib.tally_launches` dict of the same frames: eager launches and
    the replays' captured counts) counted: a trace that lost device
    events cannot split the frame. Prints the count and where the first
    and last device events lie from the range's host start and end (a
    device event cannot start before the range that launched it: a
    negative lead is the clocks' disagreement) to ``log`` (default
    ``sys.stdout``)."""
    work = device_events(events, within=RUN_RANGE)
    want = sum(tally.values())
    got = sum(1 for e in work if any(k in e.name for k in _lib.KERNELS))
    ranges = [e for e in events if e.name == RUN_RANGE
              and e.device_type == torch.autograd.DeviceType.CPU]
    edges = ""
    if work and ranges:
        lead = (min(e.time_range.start for e in work)
                - min(r.time_range.start for r in ranges))
        trail = (max(r.time_range.end for r in ranges)
                 - max(e.time_range.end for e in work))
        edges = (f"; first device event {lead:.1f} us after the range's "
                 f"start, last one {trail:.1f} us before its end")
    names = Counter(k for e in work for k in _lib.KERNELS if k in e.name)
    print(f"{label}: {got} device events of the port's kernels for {want} "
          f"launches counted ({len(device_events(events)) - len(work)} "
          f"device events outside the range{edges}); events by kernel "
          f"{dict(names)}, launches by wrapper "
          f"{ {fn.__name__: n for fn, n in tally.items()} }", file=log)
    return got == want


#: traces :func:`checked_trace` takes before it gives up
TRACE_ATTEMPTS = 3


def checked_trace(label, acts, run, device, warm=None, log=None,
                  launches=None):
    """The events of one :func:`~bmfr_tpu_torch.profiling.traced_run` of
    ``run()`` (``warm()`` first, in the same trace), this thread's
    launches tallied. On the card each trace must hold every launch
    (:func:`check_launches`, printed to ``log``); one that lost or gained
    device events is printed and taken again, and after
    :data:`TRACE_ATTEMPTS` such traces this raises. ``launches``: a dict
    that takes the returned trace's tally, launches by wrapper."""
    synchronize(device)
    for attempt in range(1, TRACE_ATTEMPTS + 1):
        with traced_run(acts, warm=warm) as prof, \
                _lib.tally_launches() as tally:
            run()
        events = prof.events()
        if device.type != "cuda" or check_launches(
                f"{label} (trace {attempt})", events, tally, log):
            if launches is not None:
                launches.update(tally)
            return events
    raise RuntimeError(f"{label}: {TRACE_ATTEMPTS} traces lost or gained "
                       "device events of the port's kernels")


#: where the stages without a range of their own run on the kernel path
KERNEL_PATH_NOTE = ("on a card kernel H runs inside warp_taps, G (the K1 "
                    "tail and words 0:5) inside k1_accumulate_noisy and F "
                    "(K4 + K5 and words 5:8) inside k5_taa: "
                    "k4_accumulate_filtered and state_pack hold no work "
                    "there: G and F write either carry in place")


def _print_stages(title, per, other, total, scale):
    """The stage rows, ``(unattributed)`` and the total, in ms per
    frame (``scale``: ms per microsecond and frame), with their shares,
    and :data:`KERNEL_PATH_NOTE`."""
    print(title)
    print(f"{'stage':<40}{'ms/frame':>12}{'share':>9}")
    print("-" * 61)
    for name in STAGES + ("(unattributed)", "total"):
        us = {"(unattributed)": other, "total": total}.get(name,
                                                           per.get(name))
        share = 100.0 * us / total if total else 0.0
        print(f"{name:<40}{us * scale:>12.4f}{share:>8.1f}%")
    print(f"({KERNEL_PATH_NOTE})")


def trace_report(cfg, state, inputs, cam, off, reps, device):
    """Per-stage device ms per frame from one ``torch.profiler`` pass of
    ``reps`` eager steady frames; returns ``(per_stage, unattributed,
    total)`` in ms per frame. On the CPU, the operators' host time."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    if isinstance(state, PackedState):
        state = PackedState(state.src8.clone())
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def frames():
        for _ in range(reps):
            denoise_frame(cfg, state, inputs, cam, off, FRAME)
        synchronize(device)

    events = checked_trace(f"trace of {reps} frames", acts, frames, device,
                           warm=lambda: denoise_frame(cfg, state, inputs,
                                                      cam, off, FRAME))
    per, total, loose, _ = _attribute(events, cuda)
    other = total - sum(per.values())
    scale = 1e-3 / reps
    unit = "device" if cuda else "host (CPU run: no device)"
    _print_stages(f"Per-stage {unit} time over {reps} frames "
                  f"(torch.profiler, ms/frame):", per, other, total, scale)
    if cuda:
        for name, (n, _) in sorted(loose.items(),
                                   key=lambda kv: -kv[1][0])[:5]:
            print(f"  unattributed kernel x{n / reps:g}/frame: {name[:80]}")
    return ({k: v * scale for k, v in per.items()}, other * scale,
            total * scale)


#: how far the eager pass's stage total, with the compiled step's own
#: copies, may lie from the compiled sequence's busy time
#: (``scripts/trace_scan.py``: its rows must total within 5 % of the
#: headline)
SEQUENCE_TOLERANCE = 0.05
#: the compiled step's own work, which the eager pass has not: the copies
#: into its static input buffers of the inputs it cannot read in place
#: (``pipeline/bind.py``; none for a sequence's contiguous frames, where
#: a replay copies nothing; kernels G and F write either carry in place),
#: by name in a trace
STEP_COPY = "Memcpy DtoD (Device -> Device)"


def eager_sequence(cfg, inputs, cams, offs):
    """The sequence ``[T, 3, H, W]`` through the eager
    :func:`denoise_frame`, frame by frame, each result copied out as
    :func:`denoise_sequence` copies it: the work of the compiled sequence
    less its input copies, and its values bit for bit."""
    T = inputs.noisy.shape[0]
    device = inputs.noisy.device
    results = torch.empty((T, 3, cfg.image_height, cfg.image_width),
                          dtype=torch.float32, device=device)
    state, lag = zero_state(cfg, device), PreviousCameras(cams)
    for t in range(T):
        state, outputs = denoise_frame(
            cfg, state, FrameInputs(*(x[t] for x in inputs)), lag[t],
            offs[t], t)
        results[t] = outputs["result"]
    return results


def sequence_trace_report(cfg, inputs, cams, offs, device, scope=None):
    """Per-stage device ms per frame of a whole sequence (``[T, 3, H, W]``
    inputs on ``device``), frame 0 included: ``scripts/trace_scan.py``'s
    table for the sequence ``bench`` times.

    A replayed CUDA graph keeps no profiler range, so the stages come from
    one profiled pass of the same frames through the eager
    :func:`denoise_frame`, and the busy time, the device's idle time and
    the span from one profiled :func:`denoise_sequence` (frames 1..
    replayed). Prints the stage rows, the top 15 kernels outside every
    stage, the kernels whose time the compiled sequence adds to the eager
    one and, with ``scope``, the kernels of the stages (or with names)
    containing it. Each pass runs once inside its trace before the traced
    run, and on the card each trace must hold one device event of the
    port's kernels per launch counted (:func:`checked_trace`). On the card
    it raises unless the eager total plus the copies
    the compiled sequence adds (:data:`STEP_COPY`) lies within
    :data:`SEQUENCE_TOLERANCE` of the compiled busy time. On the CPU the
    rows are the operators' host time and the compiled numbers are None.

    Returns ``{"stages", "unattributed", "total", "busy", "idle",
    "span"}`` in ms per frame (``stages`` by stage name), and on the card
    ``"step_copies"``."""
    from torch.profiler import ProfilerActivity

    cuda = device.type == "cuda"
    T = inputs.noisy.shape[0]
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])

    def eager():
        eager_sequence(cfg, inputs, cams, offs)
        synchronize(device)

    def compiled():     # frame 0 eager, then replays (the warm captures)
        denoise_sequence(cfg, inputs, cams, offs)
        synchronize(device)

    events = checked_trace(f"eager pass of {T} frames", acts, eager, device,
                           warm=eager)
    per, total, loose, inside = _attribute(events, cuda)
    counts = [len(device_events(events, within=RUN_RANGE)),
              len(device_events(events))] if cuda else None
    del events
    other = total - sum(per.values())
    scale = 1e-3 / T
    busy = span = None
    if cuda:
        events = checked_trace(f"compiled sequence of {T} frames", acts,
                               compiled, device, warm=compiled)
        work = device_events(events, within=RUN_RANGE)
        counts += [len(work), len(device_events(events))]
        del events
        if not work:
            raise RuntimeError("the profiled sequence recorded no device "
                               "event")
        busy = sum(e.time_range.elapsed_us() for e in work)
        span = (max(e.time_range.end for e in work)
                - min(e.time_range.start for e in work))
        added = Counter()
        for e in work:
            added[e.name] += e.time_range.elapsed_us()
        for (_, name), us in inside.items():
            added[name] -= us
        for name, (_, us) in loose.items():
            added[name] -= us
    unit = "device" if cuda else "host (CPU run: no device)"
    _print_stages(
        f"{T}-frame sequence, warp_mode={cfg.warp_mode} fitter="
        f"{cfg.fitter_impl} solver={cfg.solver} tier={cfg.warp_tier_impl} "
        f"residual={cfg.residual_dtype}: per-stage {unit} ms/frame of the "
        f"eager pass (torch.profiler, frame 0 included)", per, other, total,
        scale)
    rows = {"stages": {k: v * scale for k, v in per.items()},
            "unattributed": other * scale, "total": total * scale,
            "busy": None, "idle": None, "span": None}
    if cuda:
        rows.update(busy=busy * scale, idle=(span - busy) * scale,
                    span=span * scale)
        print(f"{'compiled sequence: total busy':<40}{busy * scale:>12.4f}")
        print(f"{'compiled: device idle (span-busy)':<40}"
              f"{(span - busy) * scale:>12.4f}")
        print(f"{'compiled: span':<40}{span * scale:>12.4f}")
        print(f"device events per frame: eager {counts[0] / T:.1f}, "
              f"compiled {counts[2] / T:.1f} (outside the run's range, "
              f"left out: {counts[1] - counts[0]} and "
              f"{counts[3] - counts[2]})")
    print("top unattributed kernels (ms/frame):")
    for name, (n, us) in sorted(loose.items(),
                                key=lambda kv: -kv[1][1])[:15]:
        print(f"  {us * scale:9.4f}  x{n / T:g}/frame  {name[:100]}")
    if scope:
        print(f"kernels inside stage or name ~'{scope}' (ms/frame):")
        hits = Counter()
        for (s, name), us in inside.items():
            if scope in s or scope in name:
                hits[s, name] += us
        for (s, name), us in hits.most_common(20):
            print(f"  {us * scale:9.4f}  {s:<24}{name[:80]}")
    if not cuda:
        return rows
    print("kernels the compiled sequence adds to the eager pass (ms/frame):")
    for name, us in added.most_common(10):
        if us > 0:
            print(f"  {us * scale:9.4f}  {name[:100]}")
    copies = max(added.get(STEP_COPY, 0.0), 0.0)
    rows["step_copies"] = copies * scale
    gap = abs(total + copies - busy) / busy
    print(f"eager stage total {total * scale:.4f} + the compiled step's "
          f"own copies {copies * scale:.4f} against compiled busy "
          f"{busy * scale:.4f} ms/frame: {100 * gap:.2f} % apart (limit "
          f"{100 * SEQUENCE_TOLERANCE:g} %)")
    if gap > SEQUENCE_TOLERANCE:
        raise RuntimeError(
            f"the eager stage total {total * scale:.4f} ms/frame and the "
            f"compiled step's copies {copies * scale:.4f} lie "
            f"{100 * gap:.2f} % from the compiled sequence's busy "
            f"{busy * scale:.4f} ms/frame (limit "
            f"{100 * SEQUENCE_TOLERANCE:g} %)")
    return rows


def main(argv=None):
    args = _build_argparser().parse_args(argv)
    device = args.device
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("no CUDA device: pass --device cpu")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    cfg = BMFRConfig(image_width=args.width, image_height=args.height,
                     position_limit_squared=0.03, normal_limit_squared=0.5,
                     warp_mode=args.warp_mode, fitter_impl=args.fitter_impl,
                     solver=args.solver, tmp_data_dtype=args.tmp_dtype,
                     residual_dtype=args.residual_dtype).validate()
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"Per-stage profile at {args.width}x{args.height} on {name}: "
          f"warp_mode={cfg.warp_mode} fitter_impl={cfg.fitter_impl} "
          f"solver={cfg.solver} tmp={cfg.tmp_data_dtype} "
          f"residual={cfg.residual_dtype}, frame {FRAME} of the orbit scene")
    setup = steady_setup(cfg, device)
    if args.trace:
        trace_report(cfg, *setup, args.reps, device)
        return 0
    print("(standalone stages, synchronized around each call: the rows do "
          "not sum to the frame; the full-frame rows are the frame)")
    print_report(stage_report(cfg, *setup, args.reps, device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
