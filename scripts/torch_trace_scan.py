"""Per-stage device split of the benched sequence on the card: the port's
counterpart of ``scripts/trace_scan.py``.

Renders the synthetic orbit scene at 1280x720 over ``TRACE_FRAMES``
frames (60: the sequence ``python -m bmfr_tpu_torch.bench`` times) and
prints :func:`bmfr_tpu_torch.profile_stages.sequence_trace_report`'s
table in device ms/frame over the whole sequence, frame 0 included: each
stage, ``(unattributed)``, the eager total and the compiled sequence's
busy time, idle time and span; then the top 15 kernels outside every
stage, the kernels the compiled sequence adds, and, with
``TRACE_SCOPE``, the kernels of the stages (or with names) containing
it. It fails unless the eager stage total, with the copies the
compiled step adds (its static inputs filled each frame), lies within 5 %
of the compiled sequence's busy time (``trace_scan.py``'s rule: its rows
total within 5 % of the headline), and unless each trace holds one
device event of the port's kernels per launch counted.

The configuration takes ``trace_scan.py``'s environment names and
defaults (the flagship): ``WARP_MODE`` (pallas), ``FITTER``
(pallas_direct), ``SOLVER`` (cholesky), ``TIER`` (steady_cond),
``RESIDUAL`` (bfloat16), with the limits 0.03 / 0.5.

    python3 scripts/torch_trace_scan.py
    TRACE_SCOPE=k5_taa python3 scripts/torch_trace_scan.py
    WARP_MODE=float32 FITTER=auto SOLVER=householder RESIDUAL=float32 \\
        python3 scripts/torch_trace_scan.py          # reference-exact
    TRACE_FRAMES=4 python3 scripts/torch_trace_scan.py --device cpu \\
        --width 64 --height 48                       # host time
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

#: default 60 — the full reference workload (opencl/bmfr.cpp:41), the
#: sequence the bench times
FRAMES = int(os.environ.get("TRACE_FRAMES", "60"))


def main(argv=None):
    from bmfr_tpu_torch.bench import resolve_device, scene_inputs
    from bmfr_tpu_torch.config import BMFRConfig, check_supported
    from bmfr_tpu_torch.fidelity import device_name
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence
    from bmfr_tpu_torch.profile_stages import sequence_trace_report

    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--device", default="cuda",
                   help="'cuda' (the current card), a card index or 'cpu'")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    args = p.parse_args(argv)
    cfg = check_supported(BMFRConfig(
        image_width=args.width, image_height=args.height,
        position_limit_squared=0.03, normal_limit_squared=0.5,
        warp_mode=os.environ.get("WARP_MODE", "pallas"),
        fitter_impl=os.environ.get("FITTER", "pallas_direct"),
        solver=os.environ.get("SOLVER", "cholesky"),
        warp_tier_impl=os.environ.get("TIER", "steady_cond"),
        residual_dtype=os.environ.get("RESIDUAL", "bfloat16")))
    device = resolve_device(args.device)
    print(device_name(device))
    sc = synthetic_sequence(width=args.width, height=args.height,
                            frames=FRAMES)
    inputs, cams, offs = scene_inputs(sc, device)
    del sc
    sequence_trace_report(cfg, inputs, cams, offs, device,
                          scope=os.environ.get("TRACE_SCOPE"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
