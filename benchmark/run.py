"""The benchmark's command: one run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload flagship.orbit.pipelined \\
        --seed 12345 --seconds 10 --trace 0

from the root of a checkout, on a machine with a CUDA card. Prints the
numbers the check compared as the last lines of standard error and, as
the last line of standard output, one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics
with ``--trace 0``, its per-layer metrics with ``--trace 1``),
``device``, with ``--trace 1`` ``breakdown``, and last ``compared``.
Without a card, with fewer cards than the cell asks for, or where the
run loaded JAX or the JAX package, it exits non-zero and prints no
result. The process runs on one CPU, the last it may use: the host's
part of a waited-for frame spread less over runs that way (on an H100
host of 8 CPUs, the 95th percentile's quartiles lay 2.6-2.9 % apart over
four pinned runs, 6.5-15.2 % over four unpinned ones).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import cells

    bench = cells.load_benchmark()
    cell = cells.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device (torch.cuda.is_available() is "
                         "False): the benchmark runs on the card")
    if torch.cuda.device_count() < cell["chips"]:
        raise SystemExit(f"{args.workload} asks for {cell['chips']} cards, "
                         f"{torch.cuda.device_count()} available")
    from benchmark.harness import run_cell

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    record = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), device=device, t_start=T_START)
    sys.stderr.flush()
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
