"""Does ``torch.profiler`` lose device events on the card, and which?

A reproduction of ROADMAP Queue 3's "trace that lost device events".
Each trial opens a profiler, launches a known sequence of device work,
synchronizes, closes it, and aligns the device events it recorded with
the launches it made (in order of their start on the card): every
launch without its event is reported by its position in the sequence.
The sequence cycles the port's kernels H, G and F
(``reproject_coords``, ``noisy_tail``, ``filtered_tail``) at 1280x720,
``--cycles`` times; the variants differ in what opens the window:

- ``port first``: the port's kernel H;
- ``torch first``: a torch fill (``zero_()``), then the cycles;
- ``warmed``: one launch of H and a synchronization, then the cycles
  (what the trace reports do before their measured range, if a loss
  falls on a window's first launch);
- ``after a graph`` and ``after a graph, warmed``: the first and the
  third, each after a window of its own that traced the replay of a CUDA
  graph of the cycles (as ``chip_smoke.py`` traces a compiled path
  before the next path's eager one).

Then the stage split's windows (``profile_stages.trace_report``: 5
eager steady frames of ``denoise_frame`` inside a ``RUN_RANGE`` range),
once with nothing before the range ("eager") and once after one more
frame traced before it ("eager after a frame", what
``profiling.traced_run``'s ``warm`` does), and a compiled
``denoise_sequence`` of 16 frames, on the flagship and the default
path, ``--trials`` times each: the launches of the port's kernels are
logged as they are made (``_lib.launch``), each kernel's events are
counted against its launches, and in the eager windows each lost event
is placed in the launch order, and the first kernel is counted among
all of the trace's events and kineto's own.

    python3 scripts/torch_trace_loss.py [--trials 20] [--cycles 30]

Prints per variant the trials that lost events and the positions lost.
Needs a card.
"""

from __future__ import annotations

import argparse
import os
import sys
from collections import Counter

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: the device kernel each step of the cycle launches
CYCLE = ("reproject_kernel", "noisy_tail_kernel", "filtered_tail_kernel")


def missing(expected, observed):
    """Positions of ``expected`` (names in launch order) that have no
    event in ``observed`` (names in start order), aligned greedily."""
    lost, j = [], 0
    for i, name in enumerate(expected):
        if j < len(observed) and name in observed[j]:
            j += 1
        else:
            lost.append(i)
    return lost


def main(argv=None):
    import torch
    from torch.profiler import ProfilerActivity, profile

    import bmfr_tpu_torch as bt
    from bmfr_tpu_torch.fidelity import device_name
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence
    from bmfr_tpu_torch.ops import _lib
    from bmfr_tpu_torch.ops.reproject import noisy_tail, reproject_coords
    from bmfr_tpu_torch.ops.tail import filtered_tail
    from bmfr_tpu_torch.profiling import device_events

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--cycles", type=int, default=30)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this measures the card's traces")
    dev = torch.device("cuda", 0)
    print(device_name(dev))
    _lib.library()
    cfg = bt.BMFRConfig(image_width=1280, image_height=720,
                        position_limit_squared=0.03,
                        normal_limit_squared=0.5, **bt.FLAGSHIP)
    sc = synthetic_sequence(width=1280, height=720, frames=2)
    inputs = bt.frame_inputs_from_numpy(sc["normals"][1], sc["positions"][1],
                                        sc["noisy"][1], sc["albedo"][1], dev)
    cam = torch.from_numpy(sc["camera_matrices"][0]).to(dev)
    off = torch.from_numpy(sc["pixel_offsets"][1]).to(dev)
    planes = torch.zeros((13, 720, 1280), device=dev)
    pack = bt.PackedState.initial(cfg, dev).src8
    scratch = torch.empty(1, device=dev)

    def cycle():
        pp = reproject_coords(cfg, inputs.positions, cam, off)
        k1 = noisy_tail(cfg, inputs.noisy, pp, planes, inputs.positions,
                        inputs.normals, 1, pack=pack)
        filtered_tail(cfg, k1["accum"], planes, inputs.albedo, k1["spp"],
                      pp, 1, pack=pack)

    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.graph(graph, stream=side):
        for _ in range(args.cycles):
            cycle()
    torch.cuda.current_stream(dev).wait_stream(side)

    def run(variant):
        expected = list(CYCLE) * args.cycles
        if variant.startswith("after a graph"):
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]):
                graph.replay()
                torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            if variant == "torch first":
                scratch.zero_()
                expected = ["FillFunctor"] + expected
            elif variant.endswith("warmed"):
                reproject_coords(cfg, inputs.positions, cam, off)
                torch.cuda.synchronize()
                expected = [CYCLE[0]] + expected
            for _ in range(args.cycles):
                cycle()
            torch.cuda.synchronize()
        events = sorted(device_events(prof.events()),
                        key=lambda e: e.time_range.start)
        return missing(expected, [e.name for e in events]), len(expected)

    cycle()
    torch.cuda.synchronize()
    for variant in ("port first", "torch first", "warmed", "after a graph",
                    "after a graph, warmed"):
        trials, where = 0, Counter()
        for _ in range(args.trials):
            lost, n = run(variant)
            trials += bool(lost)
            where.update(lost)
        print(f"{variant}: {trials} of {args.trials} trials lost events "
              f"({n} launches a trial); lost positions (position: trials) "
              f"{dict(sorted(where.items()))}")
    windows(args.trials, dev)


#: the device kernel of each C entry point the paths launch
ENTRY_KERNEL = {
    "bmfr_reproject": "reproject_kernel",
    "bmfr_noisy_tail": "noisy_tail_kernel",
    "bmfr_filtered_tail": "filtered_tail",
    "bmfr_warp_blend": "warp_blend_kernel",
    "bmfr_fit_reconstruct_cholesky": "fit_chol_kernel",
    "bmfr_fit_blocks_registers": "fit_blocks_regs_kernel",
    "bmfr_fit_blocks_shared": "fit_blocks_smem_kernel"}


def windows(trials, dev):
    """The stage split's eager windows and a compiled sequence's, each
    kernel's events against its logged launches."""
    import time

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    import bmfr_tpu_torch as bt
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence
    from bmfr_tpu_torch.ops import _lib
    from bmfr_tpu_torch.profile_stages import FRAME, steady_setup
    from bmfr_tpu_torch.profiling import RUN_RANGE, device_events

    log = []
    launch = _lib.launch

    def logged(name, *args):
        log.append(ENTRY_KERNEL[name])
        launch(name, *args)

    _lib.launch = logged
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    sc = synthetic_sequence(width=1280, height=720, frames=16)
    seq = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                     sc["noisy"], sc["albedo"], dev)
    cams = torch.from_numpy(sc["camera_matrices"]).to(dev)
    offs = torch.from_numpy(sc["pixel_offsets"]).to(dev)
    for label in ("flagship", "default"):
        cfg = bt.BMFRConfig(image_width=1280, image_height=720,
                            position_limit_squared=0.03,
                            normal_limit_squared=0.5,
                            **(bt.FLAGSHIP if label == "flagship" else {}))
        state, inputs, cam, off = steady_setup(cfg, dev)
        if isinstance(state, bt.PackedState):
            state = bt.PackedState(state.src8.clone())
        bt.denoise_sequence(cfg, seq, cams, offs)       # the capture
        per_frame = None
        for mode in ("eager", "eager after a frame", "compiled"):
            lost_trials, lost, where, seen = 0, Counter(), Counter(), Counter()
            for _ in range(trials):
                torch.cuda.synchronize()
                with profile(activities=acts) as prof:
                    if mode == "eager after a frame":
                        bt.denoise_frame(cfg, state, inputs, cam, off, FRAME)
                        torch.cuda.synchronize()
                    log.clear()
                    time.sleep(0.02)
                    with record_function(RUN_RANGE):
                        if mode.startswith("eager"):
                            for _ in range(5):
                                bt.denoise_frame(cfg, state, inputs, cam,
                                                 off, FRAME)
                        else:
                            bt.denoise_sequence(cfg, seq, cams, offs)
                        torch.cuda.synchronize()
                    time.sleep(0.02)
                work = sorted(device_events(prof.events(), within=RUN_RANGE),
                              key=lambda e: e.time_range.start)
                if mode.startswith("eager"):
                    where.update(missing(log, [
                        e.name for e in work
                        if any(k in e.name for k in ENTRY_KERNEL.values())]))
                    # the first kernel in every record of the trace: the
                    # function events of any type, and kineto's own
                    first = ENTRY_KERNEL["bmfr_reproject"]
                    raw = prof.profiler.kineto_results.events()
                    seen["function events"] += sum(
                        first in e.name for e in prof.events())
                    seen["kineto events"] += sum(first in e.name()
                                                 for e in raw)
                    seen["launched"] += log.count(first)
                want = Counter(log)     # frame 0 of a compiled sequence
                if mode.startswith("eager"):
                    per_frame = Counter({k: n // 5 for k, n in want.items()})
                else:                   # the 15 replays launch no wrapper
                    for k, n in per_frame.items():
                        want[k] += 15 * n
                got = Counter(k for e in work for k in set(
                    ENTRY_KERNEL.values()) if k in e.name)
                if got != want:
                    lost_trials += 1
                    lost.update(want - got)
                    lost.update({f"{k} extra": n
                                 for k, n in (got - want).items()})
            print(f"{label} {mode}: {lost_trials} of {trials} windows lost "
                  f"or gained events; by kernel {dict(lost)}"
                  + (f"; lost positions among the port's {len(log)} "
                     f"launches (position: windows) "
                     f"{dict(sorted(where.items()))}; {ENTRY_KERNEL['bmfr_reproject']}"
                     f" launched, and found among all events: {dict(seen)}"
                     if mode.startswith("eager") else ""))
    _lib.launch = launch


if __name__ == "__main__":
    main()
