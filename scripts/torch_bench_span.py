"""Where the bench's profiled run idles: the device span of
``python -m bmfr_tpu_torch.bench``'s sequence against its busy time.

Runs the bench's configuration (the ``BENCH_*`` knobs, the 60-frame
1280x720 orbit flagship by default) three times unprofiled (host ms per
frame, fenced by the checksum's host read as the bench fences it), then
twice under ``torch.profiler`` with CPU and CUDA activity (as the bench
traces) and twice with CUDA activity alone. For each profiled run it
prints the host ms per frame, the device span, busy and idle ms per
frame, and the idle time between consecutive device events in the first
``events / T`` events (about frame 0, which runs eagerly) and after them
(the replays), with the largest gaps and their event indices.

    python3 scripts/torch_bench_span.py
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bmfr_tpu_torch import bench
    from bmfr_tpu_torch.fidelity import device_name
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence
    from bmfr_tpu_torch.pipeline.denoise import denoise_sequence
    from bmfr_tpu_torch.profiling import device_events

    if not torch.cuda.is_available():
        raise SystemExit("torch_bench_span.py needs a CUDA device")
    dev = bench.resolve_device("cuda")
    print(device_name(dev))
    s = bench.settings()
    cfg, T = s["cfg"], s["frames"]
    inputs, cams, offs = bench.scene_inputs(synthetic_sequence(
        cfg.image_width, cfg.image_height, T, scene=s["scene"]), dev)

    def run():
        t0 = time.perf_counter()
        out = denoise_sequence(cfg, inputs, cams, offs, return_stats=True)[0]
        out.sum().item()
        return (time.perf_counter() - t0) / T * 1e3

    for _ in range(3):
        run()
    print("unprofiled host ms/frame", [round(run(), 4) for _ in range(3)])
    for name, acts in (("cpu+cuda", [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]),
                       ("cuda", [ProfilerActivity.CUDA])):
        for rep in range(2):
            with profile(activities=acts) as prof:
                ms = run()
            work = sorted(device_events(prof.events()),
                          key=lambda e: e.time_range.start)
            del prof
            st = np.array([e.time_range.start for e in work], np.float64)
            en = np.array([e.time_range.end for e in work], np.float64)
            busy, span = (en - st).sum(), en.max() - st.min()
            gaps = np.maximum(st[1:] - np.maximum.accumulate(en)[:-1], 0)
            k0 = len(work) // T
            top = np.argsort(-gaps)[:8]
            print(f"{name} run {rep}: host {ms:.4f} ms/frame; span "
                  f"{span / T / 1e3:.4f}, busy {busy / T / 1e3:.4f}, idle "
                  f"{(span - busy) / T / 1e3:.4f} ms/frame; {len(work)} "
                  f"device events; idle in the first {k0} events "
                  f"{gaps[:k0].sum() / 1e3:.3f} ms, after them "
                  f"{gaps[k0:].sum() / 1e3:.3f} ms; largest gaps (us @ "
                  f"event): {[(round(float(gaps[i]), 1), int(i)) for i in top]}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
