"""Production-resolution parity of the PyTorch/CUDA port: the port on the
card against the port's copy of the vectorized NumPy oracle at
1280x720, the counterpart of ``scripts/parity_fullres.py``.

Runs each mode of the port through ``denoise_sequence`` (frame 0
eagerly, the compiled step after it) over the synthetic scene, runs
``bmfr_tpu_torch/oracle/reference_vec.py`` over the same frames on the
host, and writes per-frame PSNR and max |diff| of the TAA result to
``PARITY_FULLRES_torch.json`` at the repository root. Modes:
``float32`` (the default ``BMFRConfig()``, kernel D), ``pallas`` (the
fused warp and the Householder direct fitter, kernels A and C) and
``pallas_cholesky`` (kernels A and B), as the JAX script has them. The
oracle takes minutes per 1280x720 frame on a CPU.

Usage: python3 scripts/torch_parity_fullres.py [--frames 4]
    [--modes float32,pallas,pallas_cholesky] [--scene orbit] [--device 0]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import bmfr_tpu_torch as bt  # noqa: E402
from bmfr_tpu_torch.cli import device_arg, resolve_device  # noqa: E402
from bmfr_tpu_torch.fidelity import device_name  # noqa: E402
from bmfr_tpu_torch.io.fixtures import synthetic_sequence  # noqa: E402
from bmfr_tpu_torch.metrics import psnr  # noqa: E402
from bmfr_tpu_torch.parity import oracle_frames  # noqa: E402


def mode_cfg(base, mode):
    """The port's configuration of one mode of ``scripts/
    parity_fullres.py``."""
    warp, solver = mode, "householder"
    if mode == "pallas_cholesky":
        warp, solver = "pallas", "cholesky"
    return base.replace(
        warp_mode=warp, solver=solver,
        fitter_impl="pallas_direct" if warp == "pallas" else "auto")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=4)
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--modes", default="float32,pallas,pallas_cholesky")
    p.add_argument("--scene", default="orbit",
                   choices=["orbit", "corridor", "swing"])
    p.add_argument("--device", type=device_arg, default=0,
                   help="card index or 'cpu'")
    p.add_argument("--out", default=os.path.join(ROOT,
                                                 "PARITY_FULLRES_torch.json"))
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 1

    H, W, T = args.height, args.width, args.frames
    sc = synthetic_sequence(width=W, height=H, frames=T, scene=args.scene)
    base = bt.BMFRConfig(image_width=W, image_height=H,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5).validate()
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], device)
    cams = torch.from_numpy(sc["camera_matrices"]).to(device)
    offs = torch.from_numpy(sc["pixel_offsets"]).to(device)

    record = dict(width=W, height=H, frames=T, device=device_name(device),
                  torch=torch.__version__,
                  scene=f"synthetic {args.scene} (io/fixtures.py)", modes={})
    results = {}
    for mode in args.modes.split(","):
        cfg = mode_cfg(base, mode)
        t0 = time.perf_counter()
        results[mode] = bt.denoise_sequence(cfg, inputs, cams,
                                            offs).cpu().numpy()
        print(f"[parity] port mode={mode}: {time.perf_counter() - t0:.1f} s",
              file=sys.stderr)
    del inputs

    print(f"[parity] vectorized oracle over {T} frames at {W}x{H}...",
          file=sys.stderr)
    t0 = time.perf_counter()
    oracle = oracle_frames(base, sc)
    record["oracle_s"] = time.perf_counter() - t0
    print(f"[parity] oracle done in {record['oracle_s']:.1f} s",
          file=sys.stderr)

    for mode, res in results.items():
        rows = []
        for t in range(T):
            got = np.moveaxis(res[t], 0, -1)
            want = oracle[t]["result"]
            rows.append(dict(frame=t, psnr_vs_oracle=psnr(got, want),
                             max_abs=float(np.max(np.abs(got - want)))))
            print(f"  mode={mode} frame {t}: PSNR "
                  f"{rows[-1]['psnr_vs_oracle']:.4f} dB  max|diff| "
                  f"{rows[-1]['max_abs']:.3e}")
        record["modes"][mode] = rows

    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[parity] wrote {args.out}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
