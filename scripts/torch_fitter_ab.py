"""Device times of the fitter kernels (B, C and D) and of kernel A, and
the launches per frame of the port's three paths, for one checkout of
the repository, on one CUDA card. Compare two checkouts (a parent and a
change) inside one call on one card, in turns:

    python3 scripts/torch_fitter_ab.py --root PARENT --root . --root . \\
        --root PARENT

Each root runs in a fresh interpreter that imports that root's
``bmfr_tpu_torch`` (and builds its kernels there) and the helpers of that
root's ``chip_smoke.py``. Kernel B runs on frame 5 of the 1280x720 orbit
scene with f32, f16 and bf16 tmp; for each root the table gives the max
|difference| of B's, C's and D's outputs from the first root's.
Prints one JSON line per root, then a table. Needs a CUDA device;
imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

#: kernel D's (tmp dtype, block_edge) cases
D_CASES = (("float32", 32), ("float16", 32), ("bfloat16", 32),
           ("float32", 8), ("float32", 16), ("float32", 48),
           ("float32", 64))
#: kernel B's tmp dtypes
B_DTYPES = ("float32", "float16", "bfloat16")
CALLS = 20

CHILD = r"""
import json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import bmfr_tpu_torch as bt
import chip_smoke as cs
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.ops import _lib
from bmfr_tpu_torch.ops.blockify import build_feature_blocks
from bmfr_tpu_torch.ops.fitter_direct import (fit_reconstruct_cholesky,
                                              fit_reconstruct_direct)
from bmfr_tpu_torch.ops.fitter_pallas import fit_blocks_pallas
from bmfr_tpu_torch.ops.reproject import reproject_coords
from bmfr_tpu_torch.ops.warp_blend import warp_blend

D_CASES, CALLS = json.loads(sys.argv[2]), int(sys.argv[3])
B_DTYPES, SAVE = json.loads(sys.argv[4]), sys.argv[5]
assert bt.__file__.startswith(sys.argv[1].rstrip("/")), bt.__file__
dev = torch.device("cuda:0")
_lib.library()
W, H, T = cs.WIDTH, cs.HEIGHT, cs.FRAMES
sc = synthetic_sequence(width=W, height=H, frames=T)
inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                    sc["noisy"], sc["albedo"], dev)
cams = torch.from_numpy(sc["camera_matrices"]).to(dev)
offs = torch.from_numpy(sc["pixel_offsets"]).to(dev)
c5 = cs.frame_of(inputs, 5)
exact = bt.BMFRConfig(image_width=W, image_height=H, **cs.SCENE_LIMITS)
flagship = exact.replace(**bt.FLAGSHIP)
out = dict(root=sys.argv[1], gpu=cs.gpu_line(), b_ms={}, d_ms={}, paths={})
state = bt.PackedState.initial(flagship, dev)
state, _ = bt.denoise_frame(flagship, state, cs.frame_of(inputs, 0), cams[0],
                            offs[0], 0)
c1 = cs.frame_of(inputs, 1)
pfx, pfy = reproject_coords(flagship, c1.positions, cams[0], offs[1])
out["a_ms"] = cs.kernel_device_ms(lambda: warp_blend(
    flagship, state.src8, c1.positions, c1.normals, pfx, pfy),
    "warp_blend_kernel", CALLS)
saved = {}
for dtype in B_DTYPES:
    cfg = flagship.replace(tmp_data_dtype=dtype)
    run_b = lambda: fit_reconstruct_cholesky(cfg, c5.normals, c5.positions,
                                             c5.noisy, 5)
    out["b_ms"][dtype] = cs.kernel_device_ms(run_b, "fit_chol", CALLS)
    img, w = run_b()
    saved[f"B {dtype} image"], saved[f"B {dtype} weights"] = (
        img.cpu().numpy(), w.cpu().numpy())
for dtype, be in D_CASES:
    cfg = exact.replace(tmp_data_dtype=dtype, block_edge=be)
    tmp = build_feature_blocks(cfg, c5.normals, c5.positions, c5.noisy, 5)
    out["d_ms"][f"{dtype} {be}"] = cs.kernel_device_ms(
        lambda: fit_blocks_pallas(cfg, tmp, 5), "fit_blocks", CALLS)
    saved[f"D {dtype} {be} weights"] = fit_blocks_pallas(
        cfg, tmp, 5)[0].cpu().numpy()
hh = flagship.replace(solver="householder")
run_c = lambda: fit_reconstruct_direct(hh, c5.normals, c5.positions,
                                       c5.noisy, 5)
out["c_ms"] = cs.kernel_device_ms(run_c, "fit_direct", CALLS)
saved["C image"], saved["C weights"] = (x.cpu().numpy() for x in run_c())
np.savez(SAVE, **saved)
for label, cfg in (("flagship", flagship), ("default", exact),
                   ("householder_flagship", hh)):
    run = cs.steady_frames(cfg, inputs, cams, offs, False)[0]
    run()
    torch.cuda.synchronize()
    out["paths"][label] = cs.device_breakdown(label, run, T - 1)
print("RESULT " + json.dumps(out))
"""


def run_root(root, cases, save):
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(Path(root).resolve()),
         json.dumps(cases), str(CALLS), json.dumps(B_DTYPES), str(save)],
        capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: rc {proc.returncode}\n{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout of the repository (repeatable)")
    args = ap.parse_args()
    work = Path(tempfile.mkdtemp(prefix="fitter_ab_"))
    saves = [work / f"out_{i}.npz" for i in range(len(args.root))]
    results = [run_root(r, [list(c) for c in D_CASES], f)
               for r, f in zip(args.root, saves)]
    outputs = [dict(np.load(f)) for f in saves]
    for res, o in zip(results, outputs):
        res["max_abs_diff_from_first"] = {
            k: float(np.abs(o[k] - outputs[0][k]).max()) for k in o}
        print(json.dumps(res))
    print(f"card: {results[0]['gpu']}")
    print("device ms per call  " + "  ".join(r["root"][-24:] for r in results))
    print("A warp_blend        " + "  ".join(
        f"{r['a_ms']:.4f}" for r in results))
    for dtype in B_DTYPES:
        print(f"B {dtype:>16}  " + "  ".join(
            f"{r['b_ms'][dtype]:.4f}" for r in results))
    for dtype, be in D_CASES:
        key = f"{dtype} {be}"
        print(f"D {key:>14}  " + "  ".join(
            f"{r['d_ms'][key]:.4f}" for r in results))
    print("C reconstruct     " + "  ".join(f"{r['c_ms']:.4f}" for r in results))
    print("max |diff| from the first root's output")
    for key in outputs[0]:
        print(f"{key:>24}  " + "  ".join(
            f"{r['max_abs_diff_from_first'][key]:.3e}" for r in results))
    for label in results[0]["paths"]:
        print(f"{label} kernels/frame, busy ms/frame  " + "  ".join(
            f"{r['paths'][label]['kernels_per_frame']:.1f}, "
            f"{r['paths'][label]['busy_ms_per_frame']:.4f}" for r in results))


if __name__ == "__main__":
    main()
