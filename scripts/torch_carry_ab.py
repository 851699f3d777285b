"""The ``[carry]`` cells of ``chip_smoke.py`` for several checkouts of the
repository, in turns, on one CUDA card: each configuration of
``chip_smoke.carry_configs`` (the graft entry's Householder flagship,
the Cholesky flagship, the default path) over the 60-frame 1280x720
orbit scene on a ``TemporalState`` carry and, on the fused warp, on a
``PackedState``. Compare a parent and a change inside one call:

    python3 scripts/torch_carry_ab.py --root PARENT --root . --root . \\
        --root PARENT

The scene is rendered once, here, and handed to each root as ``.npy``
files. Each root runs in a fresh interpreter that imports that root's
``bmfr_tpu_torch`` (and builds its kernels there) and this checkout's
``chip_smoke.carry_cell``, which uses only what the port has had since
its checked bench trace. Per root and cell it prints the headline-style
ms/frame (median of 5 whole-sequence runs), the checked trace's busy
ms/frame, device operations and copies a frame, the launches by wrapper
and a digest of the 60 results; then a table, and whether every root's
results equal the first root's bit for bit. ``--json-out FILE`` keeps
every number. Needs a CUDA device; imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
KEYS = ("normals", "positions", "noisy", "albedo", "camera_matrices",
        "pixel_offsets")
FRAMES = 60

CHILD = r"""
import hashlib, importlib.util, json, sys
import numpy as np
sys.path.insert(0, sys.argv[1])
import torch
import bmfr_tpu_torch as bt
from bmfr_tpu_torch.ops import _lib

assert bt.__file__.startswith(sys.argv[1].rstrip("/")), bt.__file__
spec = importlib.util.spec_from_file_location("carry_smoke", sys.argv[2])
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
scene_dir, keys = sys.argv[3], json.loads(sys.argv[4])
dev = torch.device("cuda:0")
_lib.library()
sc = {k: np.load(f"{scene_dir}/{k}.npy", mmap_mode="r") for k in keys}
inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                    sc["noisy"], sc["albedo"], dev)
cams = torch.from_numpy(np.array(sc["camera_matrices"])).to(dev)
offs = torch.from_numpy(np.array(sc["pixel_offsets"])).to(dev)
del sc
W, H = cs.WIDTH, cs.HEIGHT
exact = bt.BMFRConfig(image_width=W, image_height=H, **cs.SCENE_LIMITS)
flagship = exact.replace(**bt.FLAGSHIP)
out = dict(root=sys.argv[1], gpu=cs.gpu_line(), cells={})
for label, cfg in cs.carry_configs(flagship, exact):
    carries = ((bt.TemporalState, bt.PackedState)
               if cfg.warp_mode == "pallas" else (bt.TemporalState,))
    for state_type in carries:
        cell = cs.carry_cell(label, cfg, inputs, cams, offs, state_type)
        res = cell.pop("out").cpu().numpy()
        cell["digest"] = hashlib.sha256(res.tobytes()).hexdigest()[:16]
        cell["finite"] = bool(np.isfinite(res).all())
        out["cells"][f"{label} {state_type.__name__}"] = cell
        del res
print("RESULT " + json.dumps(out))
"""


def run_root(root, scene_dir):
    proc = subprocess.run(
        [sys.executable, "-c", CHILD, str(Path(root).resolve()),
         str(HERE / "chip_smoke.py"), str(scene_dir), json.dumps(KEYS)],
        capture_output=True, text=True, timeout=1200)
    if proc.returncode != 0:
        raise SystemExit(f"{root}: rc {proc.returncode}\n"
                         f"{proc.stdout[-2000:]}\n{proc.stderr[-4000:]}")
    line = [x for x in proc.stdout.splitlines() if x.startswith("RESULT ")]
    return json.loads(line[-1][len("RESULT "):])


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", action="append", required=True,
                    help="a checkout of the repository (repeatable)")
    ap.add_argument("--json-out", help="write every root's numbers here")
    args = ap.parse_args()
    sys.path.insert(0, str(HERE))
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence

    work = Path(tempfile.mkdtemp(prefix="carry_ab_"))
    sc = synthetic_sequence(width=1280, height=720, frames=FRAMES)
    for k in KEYS:
        np.save(work / f"{k}.npy", np.ascontiguousarray(sc[k], np.float32))
    del sc
    try:
        results = [run_root(r, work) for r in args.root]
    finally:
        for k in KEYS:
            (work / f"{k}.npy").unlink()
        work.rmdir()
    for r in results:
        print(json.dumps(r))
    print(f"card: {results[0]['gpu']}")
    print("roots: " + "  |  ".join(r["root"] for r in results))
    first = results[0]["cells"]
    for cell in first:
        print(f"[{cell}]")
        for key, fmt in (("ms_per_frame", "{:.4f}"),
                         ("busy_ms_per_frame", "{:.4f}"),
                         ("ops_per_frame", "{:.1f}"),
                         ("copies_per_frame", "{:.1f}")):
            print(f"  {key:<20}" + "  ".join(
                fmt.format(r["cells"][cell][key]) for r in results))
        print("  launches            " + "  |  ".join(
            json.dumps({k: v for k, v in r["cells"][cell]["launches"].items()
                        if v}) for r in results))
        same = all(r["cells"][cell]["digest"] == first[cell]["digest"]
                   and r["cells"][cell]["finite"] for r in results)
        print(f"  results equal to the first root's, finite: {same}")
    if args.json_out:
        Path(args.json_out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.json_out).write_text(json.dumps(results, indent=1))


if __name__ == "__main__":
    main()
