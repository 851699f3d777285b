"""The readings the check's limits are set from, on the card, at a cell's
own size and load: for each seed, every number of :mod:`.check` for the
program (the cell's timed path over ``--frames`` frames after its
warm-up, and as many more, below the clip's length, as the seed draws:
a timed window ends anywhere in the clip, and the gaps depend on where)
and for the control, the reference computed in TF32 in the
program's place (the step below the float32 with TF32 off that every
configuration states).

    python3 benchmark/readings.py --workload flagship.orbit.pipelined \\
        --seeds 1 2 3 --frames 3000

A cell whose configuration's entry is the scene runner is read in clip
mode: for each seed its S clips rendered, ``warm_calls`` and ``--calls``
more calls of one runner built once (with ``in_flight`` calls not yet
completed, as in the window), and the last call's results compared as
:func:`benchmark.check.compare_clips` compares them; the control is the
reference in TF32 over the same clips, against the same reference.

One JSON line per seed on standard output. Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import collections
import gc
import json
import random
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--frames", type=int, default=3000)
    p.add_argument("--calls", type=int, default=2,
                   help="clip mode: calls after the warm-up")
    p.add_argument("--control-seeds", type=int, default=None,
                   help="read the control on the first N seeds only")
    args = p.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells, check, scenes, window
    from benchmark.harness import import_program
    from benchmark.reference.bmfr import settings_from_config

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: the readings are taken on the card")
    device = torch.device("cuda", 0)
    bench = cells.load_benchmark()
    cell = cells.cell(bench, args.workload)
    config = cells.config(bench, cell["config"])
    traffic = cells.traffic(cell["traffic"])
    bt = import_program(ROOT)
    from bmfr_tpu_torch.pipeline.denoise import FrameInputs

    cfg = bt.config.check_supported(bt.BMFRConfig(**config["bmfr"]))
    s = settings_from_config(config)
    if cells.entry(config)[0] == "denoise_scenes_jit":
        return _clips(args, bt, cfg, s, traffic, device)
    chk = traffic["check"]
    k = traffic["in_flight"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        planes, cams, offs = scenes.render_clip(traffic, seed, device)
        clip = window.Clip(FrameInputs, planes, cams, offs)
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        step = bt.make_denoise_frame(cfg)
        kept = collections.deque(maxlen=chk["ring"])
        run = window.Run()
        start = cells.start_state(bt, config, cfg, device)
        state, t = window.drive(step, start, clip, 0, k,
                                window.events(device, k),
                                frames=1 + traffic["warm_frames"]
                                + args.frames
                                + random.Random(seed).randrange(clip.T),
                                keep=kept, run=run)
        torch.cuda.synchronize()
        carry = {n: v.clone() for n, v in check.carried(config, state).items()}
        results = dict(kept)
        last_t = t - 1
        del step, state, kept
        gc.collect()
        torch.cuda.empty_cache()
        picks = check.pick(seed, results, chk["sampled"])
        t_from = max(0, picks[0] - chk["lead"])
        t1 = time.perf_counter()
        ref_state, ref_results = check.replay(s, clip, t_from, last_t,
                                              set(picks))
        torch.cuda.synchronize()
        ref_s = time.perf_counter() - t1
        line = {"workload": args.workload, "seed": seed,
                "frames": last_t + 1, "failed": run.failed,
                "render_s": render_s, "reference_s": ref_s,
                "reference_frames": last_t - t_from + 1,
                "program": check.numbers(results, carry, ref_results,
                                         ref_state)}
        if args.control_seeds is None or seed in args.seeds[
                :args.control_seeds]:
            ctl_state, ctl_results = check.replay(s, clip, t_from, last_t,
                                                  set(picks), "tf32")
            line["control"] = check.numbers(
                ctl_results, {n: v for n, v in ctl_state.items()},
                ref_results, ref_state)
            del ctl_state, ctl_results
        print(json.dumps(line), flush=True)
        del planes, cams, offs, clip, results, carry, ref_state, ref_results
        gc.collect()
        torch.cuda.empty_cache()
    return 0


def _clips(args, bt, cfg, s, traffic, device):
    """The readings of a scene runner's cell, one line per seed."""
    import torch

    from benchmark import check, scenes, window
    from bmfr_tpu_torch.pipeline.denoise import FrameInputs

    k = traffic["in_flight"]
    fences = window.events(device, k)
    runner = bt.denoise_scenes_jit(cfg, [device])
    for seed in args.seeds:
        t0 = time.perf_counter()
        batch = window.Scenes(FrameInputs,
                              *scenes.render_scenes(traffic, seed, device))
        torch.cuda.synchronize()
        render_s = time.perf_counter() - t0
        kept = collections.deque(maxlen=1)
        run = window.Run()
        window.drive_calls(runner, batch, k, fences,
                           calls=traffic["warm_calls"] + args.calls,
                           keep=kept, run=run)
        torch.cuda.synchronize()
        results = kept[-1]
        del kept
        control = (None if args.control_seeds is not None
                   and seed not in args.seeds[:args.control_seeds]
                   else "tf32")
        t1 = time.perf_counter()
        mine, ctl = check.clip_numbers(s, batch, results, seed,
                                       traffic["check"]["sampled"], control)
        torch.cuda.synchronize()
        line = {"workload": args.workload, "seed": seed,
                "scene_frames": run.frames, "failed": run.failed,
                "render_s": render_s,
                "reference_s": time.perf_counter() - t1,
                "picks": [check.clip_picks(seed, sc, batch.T,
                                           traffic["check"]["sampled"])
                          for sc in range(batch.S)],
                "program": mine}
        if ctl is not None:
            line["control"] = ctl
        print(json.dumps(line), flush=True)
        del batch, results
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
