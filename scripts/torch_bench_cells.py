"""The four ``[bench]`` cells of ``chip_smoke.py``, several rounds in one
process, and how far their device numbers spread.

Builds the kernels, then runs ``chip_smoke.py``'s ``bench_phase``
``--rounds`` times. Each round is that phase whole: ``python -m
bmfr_tpu_torch.bench`` once as a subprocess (the 60-frame 1280x720 orbit
flagship) and ``bench.run_bench`` in this process on the swing flagship,
the reference-exact default path and the householder flagship, each
cell's launches and its profiled run's trace check held and printed. Then
prints, per cell, the headline, steady, busy and span ms/frame of every
round, and for each the spread (largest less smallest) in ms and in % of
the median, beside ``nvidia-smi``'s name and power limit, and with
``--json-out`` writes every round's records and the spreads to a file.

    python3 scripts/torch_bench_cells.py [--rounds 3] [--json-out FILE]

Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import runpy
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

#: the record's keys compared across rounds
KEYS = ("value", "steady_ms_per_frame", "busy_ms_per_frame",
        "device_span_ms_per_frame")


def spread(values):
    """``(largest - smallest, that in % of the median)``."""
    import numpy as np

    width = max(values) - min(values)
    return width, 100.0 * width / float(np.median(values))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--json-out", default=None)
    args = p.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_cells.py needs a CUDA device")
    smoke = runpy.run_path(os.path.join(ROOT, "chip_smoke.py"),
                           run_name="chip_smoke")
    bt, lib = smoke["bt"], smoke["_lib"]
    dev = torch.device("cuda:0")
    print(f"[gpu] {smoke['gpu_line']()}")
    t0 = time.perf_counter()
    lib.build()
    lib.library()
    print(f"[build] {time.perf_counter() - t0:.1f} s")
    W, H = smoke["WIDTH"], smoke["HEIGHT"]
    flagship = bt.BMFRConfig(image_width=W, image_height=H,
                             **smoke["SCENE_LIMITS"], **bt.FLAGSHIP)
    exact = bt.BMFRConfig(image_width=W, image_height=H,
                          **smoke["SCENE_LIMITS"])
    hh_flagship = flagship.replace(solver="householder")

    rounds = []
    for r in range(1, args.rounds + 1):
        print(f"---- round {r} of {args.rounds} ----", flush=True)
        runs, orbit = smoke["bench_phase"](flagship, exact, hh_flagship, dev)
        del orbit
        rounds.append({label: dict(record=run["record"], trace=run["trace"])
                       for label, run in runs.items()})

    out = {"gpu": smoke["gpu_line"](), "rounds": rounds, "spread": {}}
    print(f"\n{smoke['gpu_line']()}; {args.rounds} rounds")
    for label in rounds[0]:
        print(f"{label}: traces taken "
              f"{[rd[label]['trace']['trace'] for rd in rounds]}")
        out["spread"][label] = {}
        for key in KEYS:
            values = [rd[label]["record"][key] for rd in rounds]
            ms, pct = spread(values)
            out["spread"][label][key] = dict(values=values, ms=ms, pct=pct)
            print(f"  {key:<26}{values}  spread {ms:.4f} ms "
                  f"({pct:.2f} %)")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out["spread"]))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
