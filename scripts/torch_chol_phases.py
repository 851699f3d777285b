"""Where kernel B's time goes: a phase split of the Cholesky direct
fitter (``bmfr_tpu_torch/csrc/fitter_chol.cu``) on one CUDA card.

    python3 scripts/torch_chol_phases.py [--root CHECKOUT]

It copies the checkout's ``fitter_chol.cu`` into a temporary directory,
adds a ``clock64()`` stamp by lane 0 of every warp at each phase marker
of the kernel (a line ``// ---- N. <phase> ----``) and one after a
closing barrier at the end of the kernel, builds
that copy alone with nvcc (plus the unchanged source with ``-Xptxas -v``
for its registers and spills), and runs it through the checkout's own
wrapper ``fit_reconstruct_cholesky`` on the 1280x720 orbit scene's frame
5 for each tmp dtype. Per tmp dtype it prints, as warp 0 sees them, the
mean cycles of each phase per CTA and its share of a CTA's life; when
each warp reaches each marker, from warp 0's first stamp (a marker inside
a branch is stamped by the warps that take it); the most CTAs that were
resident on one SM at once, and the device ms per call of the stamped
and the unchanged kernel (``torch.profiler``). The stamps cost a few
instructions per CTA; the device times show how much. Needs a CUDA
device and nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

#: stamp slots per warp; the last one is the kernel's end
SLOTS = 16
MAX_CTAS, MAX_WARPS = 4096, 8
MODES = ("float32", "float16", "bfloat16")

PRELUDE = r"""
__device__ long long bmfr_phase_clock[%(ctas)d][%(warps)d][%(slots)d];
__device__ unsigned bmfr_phase_sm[%(ctas)d];
#define BMFR_CTA \
  (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define BMFR_STAMP(i)                                                    \
  do {                                                                   \
    if ((threadIdx.x & 31) == 0 && (threadIdx.x >> 5) < %(warps)d)        \
      bmfr_phase_clock[BMFR_CTA][threadIdx.x >> 5][i] = clock64();       \
  } while (0)
"""

EPILOGUE = r"""
extern "C" int bmfr_phase_read(long long* clk, unsigned* sm) {
  cudaError_t e = cudaMemcpyFromSymbol(clk, bmfr_phase_clock,
                                       sizeof(bmfr_phase_clock));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaMemcpyFromSymbol(sm, bmfr_phase_sm, sizeof(bmfr_phase_sm));
}
extern "C" int bmfr_phase_clear() {
  static long long zero[%(ctas)d][%(warps)d][%(slots)d];
  return (int)cudaMemcpyToSymbol(bmfr_phase_clock, zero, sizeof(zero));
}
"""

MARKER = re.compile(r"^(\s*)// ---- (\d+)\. (.*?) ----", re.M)


def stamped_source(src):
    """The kernel source with a stamp at each phase marker and at the end
    of the (first) ``__global__`` function. Returns (source, phase
    names by slot)."""
    names = {}

    def mark(m):
        slot = int(m.group(2))
        names[slot] = m.group(3)
        return f"{m.group(1)}BMFR_STAMP({slot});\n{m.group(0)}"

    body = MARKER.sub(mark, src)
    if not names or max(names) >= SLOTS - 1:
        raise SystemExit("no usable '// ---- N. phase ----' markers")
    start = body.index("{", body.index("__global__"))
    depth = 0
    for i in range(start, len(body)):
        depth += {"{": 1, "}": -1}.get(body[i], 0)
        if depth == 0:
            break
    end = ("  __syncthreads();\n  BMFR_STAMP(%d);\n  if (threadIdx.x == 0) {\n"
           "    unsigned s;\n    asm volatile(\"mov.u32 %%0, %%%%smid;\" : "
           "\"=r\"(s));\n    bmfr_phase_sm[BMFR_CTA] = s;\n  }\n"
           % (SLOTS - 1))
    body = body[:i] + end + body[i:]
    head, inc, rest = body.partition('#include "fitter_front.cuh"')
    if not inc:
        raise SystemExit("fitter_chol.cu does not include fitter_front.cuh")
    fill = dict(ctas=MAX_CTAS, warps=MAX_WARPS, slots=SLOTS)
    return head + inc + PRELUDE % fill + rest + EPILOGUE % fill, names


def build(root, work):
    """Build the checkout's kernel B alone and its stamped copy into
    work/, in parallel. Returns (unchanged library, stamped library, the
    unchanged source's ptxas report lines, phase names by slot)."""
    sys.path.insert(0, str(root))
    from bmfr_tpu_torch.ops import _lib

    csrc = root / "bmfr_tpu_torch" / "csrc"
    src, names = stamped_source((csrc / "fitter_chol.cu").read_text())
    copy = work / "fitter_chol_stamped.cu"
    copy.write_text(src)
    flags = _lib.NVCC_FLAGS
    nvcc = _lib._nvcc()
    libs = (work / "libchol.so", work / "libchol_stamped.so")
    cmds = [[nvcc, *flags, "-Xptxas", "-v", "-shared", "-o", str(libs[0]),
             str(csrc / "fitter_chol.cu")],
            [nvcc, *flags, "-I", str(csrc), "-shared", "-o", str(libs[1]),
             str(copy)]]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit("nvcc failed:\n" + "\n".join(logs))
    report = [ln.strip() for ln in logs[0].splitlines()
              if "registers" in ln or "spill" in ln or "entry function" in ln]
    return libs, report, names


def load(path, signatures):
    """ctypes library at path with the wrapper's argument types."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in signatures.items():
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_int
    return lib


def most_resident(starts, ends, sms):
    """The most CTAs whose [start, end) clock intervals overlap on one
    SM."""
    best = 0
    by_sm = {}
    for s, e, sm in zip(starts, ends, sms):
        by_sm.setdefault(sm, []).append((s, e))
    for spans in by_sm.values():
        events = sorted([(s, 1) for s, _ in spans]
                        + [(e, -1) for _, e in spans])
        now = 0
        for _, d in events:
            now += d
            best = max(best, now)
    return best


def summarize(clk, sm, names):
    """The phase split from the stamps ``clk`` [CTAs, warps, SLOTS] (0 where
    a warp stamped nothing) and the SM of each CTA. Warp 0's phases run
    between the markers it meets, in the order it meets them; every
    warp's arrival at a marker is its mean stamp from warp 0's first."""
    import numpy as np

    used = clk[:, 0, SLOTS - 1] != 0
    clk, sm = clk[used], sm[used]
    warps = int((clk[:, :, SLOTS - 1] != 0).any(axis=0).sum())
    first = min(names)
    w0 = clk[:, 0]
    seen = [s for s in [*names, SLOTS - 1] if (w0[:, s] != 0).all()]
    seen.sort(key=lambda s: w0[:, s].mean())
    life = w0[:, SLOTS - 1] - w0[:, first]
    phases = {}
    for a, b in zip(seen, seen[1:]):
        d = w0[:, b] - w0[:, a]
        phases[f"{a}. {names[a]}"] = dict(
            mean_cycles=float(d.mean()), share=float(d.sum() / life.sum()))
    arrive = {}
    for slot in [*names, SLOTS - 1]:
        hit = clk[:, :warps, slot] != 0
        rel = clk[:, :warps, slot] - w0[:, first:first + 1]
        arrive[names.get(slot, "end")] = [
            float(rel[hit[:, w], w].mean()) if hit[:, w].any() else None
            for w in range(warps)]
    start, end = w0[:, first], w0[:, SLOTS - 1]
    span = [int(end[sm == s].max() - start[sm == s].min())
            for s in np.unique(sm)]
    return dict(ctas=int(used.sum()), warps=warps,
                life_mean_cycles=float(life.mean()),
                most_resident_per_sm=most_resident(start, end, sm),
                sm_span_mean_cycles=float(np.mean(span)),
                sm_span_max_cycles=max(span), phases=phases,
                warp_arrival_cycles=arrive)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="a checkout of the repository")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    work = Path(tempfile.mkdtemp(prefix="chol_phases_"))
    libs, report, names = build(root, work)

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    import bmfr_tpu_torch as bt
    import chip_smoke as cs
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence
    from bmfr_tpu_torch.ops import _lib
    from bmfr_tpu_torch.ops.fitter_direct import fit_reconstruct_cholesky

    assert bt.__file__.startswith(str(root)), bt.__file__
    if not torch.cuda.is_available():
        raise SystemExit("torch_chol_phases: no CUDA device")
    dev = torch.device("cuda:0")
    sc = synthetic_sequence(width=cs.WIDTH, height=cs.HEIGHT, frames=6)
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], dev)
    c5 = cs.frame_of(inputs, 5)
    base = bt.BMFRConfig(image_width=cs.WIDTH, image_height=cs.HEIGHT,
                         **cs.SCENE_LIMITS, **bt.FLAGSHIP)

    def run(cfg):
        return fit_reconstruct_cholesky(cfg, c5.normals, c5.positions,
                                        c5.noisy, 5)

    # the unchanged kernel's device times, then the stamped copy's
    _lib._lib = load(libs[0], _lib._SIGNATURES)
    plain_ms = {m: cs.kernel_device_ms(
        lambda: run(base.replace(tmp_data_dtype=m)), "fit_chol", 20)
        for m in MODES}
    stamped = _lib._lib = load(libs[1], _lib._SIGNATURES)
    out = dict(root=str(root), gpu=cs.gpu_line(), ptxas=report, modes={})
    print(f"[gpu] {out['gpu']}")
    for line in report:
        print(f"[ptxas] {line}")
    for mode in MODES:
        cfg = base.replace(tmp_data_dtype=mode)
        stamped_ms = cs.kernel_device_ms(lambda: run(cfg), "fit_chol", 20)
        assert stamped.bmfr_phase_clear() == 0
        run(cfg)
        torch.cuda.synchronize()
        clk = np.zeros((MAX_CTAS, MAX_WARPS, SLOTS), np.int64)
        sm = np.zeros(MAX_CTAS, np.uint32)
        assert stamped.bmfr_phase_read(
            clk.ctypes.data_as(ctypes.c_void_p),
            sm.ctypes.data_as(ctypes.c_void_p)) == 0
        rec = summarize(clk, sm, names)
        span_max = rec.pop("sm_span_max_cycles")
        rec.update(device_ms=plain_ms[mode], stamped_device_ms=stamped_ms,
                   # the SM clock, as the longest SM span over the call
                   cycles_per_us=float(span_max / (stamped_ms * 1e3)))
        out["modes"][mode] = rec
        print(f"[{mode}] {rec['ctas']} CTAs, at most "
              f"{rec['most_resident_per_sm']} resident per SM; CTA life "
              f"{rec['life_mean_cycles']:.0f} cycles; SM busy span "
              f"{rec['sm_span_mean_cycles']:.0f} cycles (~"
              f"{rec['cycles_per_us']:.0f} cycles/us); device "
              f"{plain_ms[mode]:.4f} ms per call (stamped {stamped_ms:.4f})")
        for label, p in rec["phases"].items():
            print(f"[{mode}]   {label:<40} {p['mean_cycles']:9.0f} cycles "
                  f"{100 * p['share']:5.1f} %")
        for label, means in rec["warp_arrival_cycles"].items():
            print(f"[{mode}]   warps reach '{label[:36]}' at "
                  + ", ".join("-" if m is None else f"{m:.0f}" for m in means))
    print(json.dumps(out))


if __name__ == "__main__":
    main()
