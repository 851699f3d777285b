"""Where a kernel's time goes: a phase split of kernel B (the Cholesky
direct fitter, ``bmfr_tpu_torch/csrc/fitter_chol.cu``), of the basis
kernels B and C (``fitter_chol_basis.cu``,
``householder_direct_basis.cu``) or of kernel F (K4 + K5 + words 5:8,
``filtered_tail.cu``) on one CUDA card.

    python3 scripts/torch_chol_phases.py [--root CHECKOUT]
        [--kernel {B,B-basis,C-basis,F,K}] [--basis NAME ...]
        [--tile TXxTYxSTAGES ...]

It copies the kernel's source from the checkout into a temporary
directory, adds a ``clock64()`` stamp by lane 0 of every warp at each
phase marker of the kernel (a line ``// ---- N. <phase> ----``) and one
at the end of the kernel (after a closing barrier; in a kernel with early
returns, by each warp as it leaves), builds that copy alone with nvcc
(plus the unchanged source with ``-Xptxas -v`` for its registers and
spills), and runs it through the checkout's own wrapper
(``fit_reconstruct_cholesky`` or ``fit_reconstruct_direct``) on the
1280x720 orbit scene's frame 5 for each tmp dtype: kernel B on the
flagship, the basis kernels on each basis of ``--basis`` (the names of
``chip_smoke.BASES``; first_order, 10 columns, and 16 columns by
default). Per case it prints, as warp 0 sees them, the mean cycles of
each phase per CTA and its share of a CTA's life; when each warp reaches
each marker, from warp 0's first stamp (a marker inside a branch is
stamped by the warps that take it); the most CTAs that were resident on
one SM at once, and the device ms per call of the stamped and the
unchanged kernel (``torch.profiler``). The stamps cost a few
instructions per CTA; the device times show how much.

Kernel F runs through ``filtered_tail`` on the orbit scene's frame 1 at
1280x720, its inputs made by the plain versions, on the flagship
(packed carry, bf16 residual) and the default path (f32 residual, no
words). Its CTAs are persistent and run the markers once a tile, so
each warp adds up the cycles from each marker to the next over its
CTA's life (slot 0 the set-up before the first marker); the split is
those sums' share of the warps' lives. ``--tile 32x16x2`` (repeatable)
builds the source with ``BMFR_F_TX``, ``BMFR_F_TY`` and
``BMFR_F_STAGES`` set, a sweep of the tile shape and ring depth; by
default the source's own.

Kernel K (the block reconstruction, ``block_reconstruct.cu``) runs
through ``weighted_sum`` on the orbit scene's frame 1 at 1280x720 on the
default path, its inputs made by the plain versions, on f32 tmp (the
blocks' rows reused) and f16 tmp. Its CTAs walk their pixels in a loop,
so its stamps add up as kernel F's do (the set-up, the loads and
products, the stores). It always splits this checkout's kernel;
``--root DIR`` names a second checkout, whose package is imported beside
this one under another name and builds its kernels through its own
``ops/_lib.py`` (in a thread, while this checkout's K builds), and the
two wrappers' device ms in K are taken in turns (DIR, this, this, DIR)
with the largest difference of their outputs. Needs a CUDA device and
nvcc; imports no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

#: stamp slots per warp; the last one is the kernel's end
SLOTS = 16
MAX_CTAS, MAX_WARPS = 4096, 32
MODES = ("float32", "float16", "bfloat16")
#: per kernel: its source, the wrapper that launches it, the solver, and
#: the name its device time is found by (and a looped kernel's stamped
#: function)
KERNELS = {
    "B": ("fitter_chol.cu", "fit_reconstruct_cholesky", "cholesky",
          "fit_chol_kernel"),
    "B-basis": ("fitter_chol_basis.cu", "fit_reconstruct_cholesky",
                "cholesky", "fit_chol_basis_kernel"),
    "C-basis": ("householder_direct_basis.cu", "fit_reconstruct_direct",
                "householder", "fit_direct_basis_kernel"),
    "F": ("filtered_tail.cu", "filtered_tail", None, "filtered_tail_kernel"),
    "K": ("block_reconstruct.cu", "weighted_sum", None,
          "block_reconstruct_kernel"),
}
#: kernels whose markers run once a tile of a persistent loop: their
#: stamps add up (LOOP_PRELUDE)
LOOPED = ("F", "K")

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

#: the looped kernels' stamps: lane 0 of each warp adds the cycles since
#: its last stamp to the phase it leaves (slot 0 before the first
#: marker, at most LOOP_SLOTS slots) in shared memory, and at the end
#: writes the sums, its start (slot SLOTS - 2) and its end (SLOTS - 1).
#: Warps count the block's threads in order, as 2-D blocks lay them out.
LOOP_SLOTS = 8
LOOP_PRELUDE = r"""
__device__ long long bmfr_phase_clock[%(ctas)d][%(warps)d][%(slots)d];
__device__ unsigned bmfr_phase_sm[%(ctas)d];
#define BMFR_CTA \
  (blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y * blockIdx.z))
#define BMFR_TID \
  (threadIdx.x + blockDim.x * (threadIdx.y + blockDim.y * threadIdx.z))
#define BMFR_LEAD ((BMFR_TID & 31) == 0 && (BMFR_TID >> 5) < %(warps)d)
#define BMFR_BEGIN                                                       \
  __shared__ unsigned bmfr_acc[%(warps)d][%(loop_slots)d];               \
  long long bmfr_t0 = clock64(), bmfr_last = bmfr_t0;                    \
  int bmfr_prev = 0;                                                     \
  if (BMFR_LEAD)                                                         \
    for (int k = 0; k < %(loop_slots)d; ++k) bmfr_acc[BMFR_TID >> 5][k] = 0
#define BMFR_STAMP(i)                                                    \
  do {                                                                   \
    if (BMFR_LEAD) {                                                     \
      const long long now = clock64();                                   \
      bmfr_acc[BMFR_TID >> 5][bmfr_prev] += now - bmfr_last;             \
      bmfr_last = now;                                                   \
      bmfr_prev = (i);                                                   \
    }                                                                    \
  } while (0)
#define BMFR_END                                                         \
  do {                                                                   \
    if (BMFR_LEAD) {                                                     \
      const long long now = clock64();                                   \
      long long* out = bmfr_phase_clock[BMFR_CTA][BMFR_TID >> 5];        \
      bmfr_acc[BMFR_TID >> 5][bmfr_prev] += now - bmfr_last;             \
      for (int k = 0; k < %(loop_slots)d; ++k)                           \
        out[k] = bmfr_acc[BMFR_TID >> 5][k];                             \
      out[%(slots)d - 2] = bmfr_t0;                                      \
      out[%(slots)d - 1] = now;                                          \
    }                                                                    \
  } while (0)
"""

MARKER = re.compile(r"^(\s*)// ---- (\d+)\. (.*?) ----", re.M)


INCLUDE = re.compile(r'^#include "[^"]+\.cuh"\n', re.M)
EARLY_RETURN = re.compile(r"\breturn\s*;")


def stamped_source(src, kernel=None, loop=False):
    """The kernel source with a stamp at each phase marker and at the end
    of the ``__global__`` function named ``kernel`` (the first one by
    default): after a closing barrier, or, where the kernel returns
    early, by each warp as it leaves (a barrier there would wait for
    threads that have left). Thread 0 records the CTA's SM at its start.
    With ``loop`` the stamps add up (:data:`LOOP_PRELUDE`): the function
    starts with ``BMFR_BEGIN`` and every warp ends with ``BMFR_END``,
    with no closing barrier. Returns (source, phase names by slot)."""
    names = {}

    def mark(m):
        slot = int(m.group(2))
        names[slot] = m.group(3)
        return f"{m.group(1)}BMFR_STAMP({slot});\n{m.group(0)}"

    body = MARKER.sub(mark, src)
    if not names or max(names) >= (LOOP_SLOTS if loop else SLOTS - 1):
        raise SystemExit("no usable '// ---- N. phase ----' markers")
    head = (body.index("__global__") if kernel is None else re.search(
        r"__global__[^;{]*?\b" + kernel + r"\s*\(", body).start())
    start = body.index("{", head)
    depth = 0
    for i in range(start, len(body)):
        depth += {"{": 1, "}": -1}.get(body[i], 0)
        if depth == 0:
            break
    fn = body[start + 1:i]
    leave = "BMFR_END;" if loop else f"BMFR_STAMP({SLOTS - 1});"
    if EARLY_RETURN.search(fn):
        fn = EARLY_RETURN.sub("{ " + leave + " return; }", fn)
        end = f"  {leave}\n"
    else:
        end = (f"  {leave}\n" if loop
               else f"  __syncthreads();\n  {leave}\n")
    sm = ('\n  if (threadIdx.x == 0) {\n    unsigned s;\n    asm volatile('
          '"mov.u32 %0, %%smid;" : "=r"(s));\n    bmfr_phase_sm[BMFR_CTA] '
          '= s;\n  }')
    if loop:
        sm = "\n  BMFR_BEGIN;" + sm
    body = body[:start + 1] + sm + fn + end + body[i:]
    includes = list(INCLUDE.finditer(body))
    if not includes:
        raise SystemExit("the kernel source includes no .cuh header")
    cut = includes[-1].end()
    fill = dict(ctas=MAX_CTAS, warps=MAX_WARPS, slots=SLOTS,
                loop_slots=LOOP_SLOTS)
    prelude = LOOP_PRELUDE if loop else PRELUDE
    return (body[:cut] + prelude % fill + body[cut:] + EPILOGUE % fill,
            names)


def tile_defines(tile):
    """``"32x16x2"`` -> nvcc's -D flags of kernel F's tile and ring."""
    if tile is None:
        return []
    names = ("BMFR_F_TX", "BMFR_F_TY", "BMFR_F_STAGES")
    return [f"-D{k}={int(v)}" for k, v in zip(names, tile.split("x"))]


def build(root, work, source, kernel=None, loop=False, tiles=(None,)):
    """Build the checkout's kernel source alone and its stamped copy into
    work/, all in parallel, once per tile of ``tiles`` (kernel F's
    ``TXxTYxSTAGES``; None: the source's own). Returns ({tile:
    (unchanged library, stamped library, the unchanged source's ptxas
    report lines)}, phase names by slot)."""
    sys.path.insert(0, str(root))
    from bmfr_tpu_torch.ops import _lib

    csrc = root / "bmfr_tpu_torch" / "csrc"
    src, names = stamped_source((csrc / source).read_text(), kernel, loop)
    copy = work / source.replace(".cu", "_stamped.cu")
    copy.write_text(src)
    flags = _lib.NVCC_FLAGS
    nvcc = _lib._nvcc()
    cmds, libs = [], {}
    for k, tile in enumerate(tiles):
        pair = (work / f"libkernel_{k}.so", work / f"libkernel_{k}_stamped.so")
        libs[tile] = pair
        defs = tile_defines(tile)
        cmds += [[nvcc, *flags, *defs, "-Xptxas", "-v", "-shared", "-o",
                  str(pair[0]), str(csrc / source)],
                 [nvcc, *flags, *defs, "-I", str(csrc), "-shared", "-o",
                  str(pair[1]), str(copy)]]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    logs = [p.communicate()[0] for p in procs]
    if any(p.returncode for p in procs):
        raise SystemExit("nvcc failed:\n" + "\n".join(logs))
    out = {}
    for k, tile in enumerate(tiles):
        report = [ln.strip() for ln in logs[2 * k].splitlines()
                  if "registers" in ln or "spill" in ln
                  or "entry function" in ln]
        out[tile] = (*libs[tile], report)
    return out, names


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


def summarize_loop(clk, sm, names):
    """The phase split of a looped kernel from its stamps ``clk`` [CTAs,
    warps, SLOTS] (:data:`LOOP_PRELUDE`: each warp's cycles per phase, its
    start and its end) and the SM of each CTA: per phase the mean cycles
    per CTA and the share of the warps' lives, over every warp and over
    warp 0 alone (on kernel F the one that issues the TMA copies)."""
    import numpy as np

    used = clk[:, 0, SLOTS - 1] != 0
    clk, sm = clk[used], sm[used]
    stamped = clk[:, :, SLOTS - 1] != 0
    warps = int(stamped.any(axis=0).sum())
    start, end = clk[:, 0, SLOTS - 2], clk[:, 0, SLOTS - 1]
    lives = np.where(stamped, clk[:, :, SLOTS - 1] - clk[:, :, SLOTS - 2], 0)
    phases = {}
    for slot in sorted({0, *names}):
        cyc = np.where(stamped, clk[:, :, slot], 0)
        phases[f"{slot}. {names.get(slot, 'set-up')}"] = dict(
            mean_cycles=float(cyc[:, 0].mean()),
            share=float(cyc.sum() / lives.sum()),
            share_warp0=float(cyc[:, 0].sum() / lives[:, 0].sum()))
    span = [int(end[sm == s].max() - start[sm == s].min())
            for s in np.unique(sm)]
    return dict(ctas=int(used.sum()), warps=warps,
                life_mean_cycles=float((end - start).mean()),
                most_resident_per_sm=most_resident(start, end, sm),
                sm_span_mean_cycles=float(np.mean(span)),
                sm_span_max_cycles=max(span), phases=phases,
                warp_arrival_cycles={})


def report_case(label, rec):
    print(f"[{label}] {rec['ctas']} CTAs, at most "
          f"{rec['most_resident_per_sm']} resident per SM; CTA life "
          f"{rec['life_mean_cycles']:.0f} cycles; SM busy span "
          f"{rec['sm_span_mean_cycles']:.0f} cycles (~"
          f"{rec['cycles_per_us']:.0f} cycles/us); device "
          f"{rec['device_ms']:.4f} ms per call (stamped "
          f"{rec['stamped_device_ms']:.4f})")
    for name, p in rec["phases"].items():
        warp0 = (f" (warp 0 {100 * p['share_warp0']:5.1f} %)"
                 if "share_warp0" in p else "")
        print(f"[{label}]   {name:<40} {p['mean_cycles']:9.0f} cycles "
              f"{100 * p['share']:5.1f} %{warp0}")
    for name, means in rec["warp_arrival_cycles"].items():
        print(f"[{label}]   warps reach '{name[:36]}' at "
              + ", ".join("-" if m is None else f"{m:.0f}" for m in means))


def f_calls(cs, inputs, cams, offs):
    """Kernel F's calls on the orbit scene's frame 1, by path: its inputs
    from the plain versions of the stages before it (frame 0 and frame
    1's warp, K1 and fit), the flagship's words from its packed state."""
    import bmfr_tpu_torch as bt
    from bmfr_tpu_torch.ops.reproject import (noisy_tail_reference,
                                              reproject_coords_reference)
    from bmfr_tpu_torch.ops.tail import filtered_tail
    from bmfr_tpu_torch.pipeline.denoise import _filter, _warp_planes

    dev = inputs.noisy.device
    base = bt.BMFRConfig(image_width=cs.WIDTH, image_height=cs.HEIGHT,
                         **cs.SCENE_LIMITS)
    cur = cs.frame_of(inputs, 1)
    calls = {}
    for path, cfg in (("flagship", base.replace(**bt.FLAGSHIP)),
                      ("default", base)):
        st0, _ = bt.denoise_frame(cfg, bt.zero_state(cfg, dev),
                                  cs.frame_of(inputs, 0), cams[0], offs[0],
                                  0, plain=True)
        pp = reproject_coords_reference(cfg, cur.positions, cams[0], offs[1])
        planes = _warp_planes(cfg, st0, cur, pp[0], pp[1], True, True)[0]
        pack = getattr(st0, "src8", None)
        k1 = noisy_tail_reference(cfg, cur.noisy, pp, planes, cur.positions,
                                  cur.normals, 1, pack=pack)
        filtered = _filter(cfg, cur, k1["accum"], 1, True)[0]
        args = (cfg, filtered, planes, cur.albedo, k1["spp"], pp, 1)
        calls[path] = (lambda args=args, pack=pack:
                       filtered_tail(*args, pack=pack))
    return calls


def k_calls(cs, inputs, cams, offs):
    """Kernel K's calls on the orbit scene's frame 1 on the default path,
    its inputs from the plain versions of the stages before it (frame 0,
    frame 1's warp, K1, blocks and fit), by tmp dtype: f32 (the blocks'
    rows reused, NaN -> 0) and f16 (the raw features)."""
    import bmfr_tpu_torch as bt
    from bmfr_tpu_torch.ops.blockify import build_feature_blocks_reference
    from bmfr_tpu_torch.ops.fitter import fit_blocks
    from bmfr_tpu_torch.ops.reproject import (noisy_tail_reference,
                                              reproject_coords_reference)
    from bmfr_tpu_torch.ops.weighted_sum import weighted_sum
    from bmfr_tpu_torch.pipeline.denoise import _warp_planes

    dev = inputs.noisy.device
    cfg = bt.BMFRConfig(image_width=cs.WIDTH, image_height=cs.HEIGHT,
                        **cs.SCENE_LIMITS)
    cur = cs.frame_of(inputs, 1)
    st0, _ = bt.denoise_frame(cfg, bt.zero_state(cfg, dev),
                              cs.frame_of(inputs, 0), cams[0], offs[0], 0,
                              plain=True)
    pp = reproject_coords_reference(cfg, cur.positions, cams[0], offs[1])
    planes = _warp_planes(cfg, st0, cur, pp[0], pp[1], True, True)[0]
    accum = noisy_tail_reference(cfg, cur.noisy, pp, planes, cur.positions,
                                 cur.normals, 1)["accum"]
    calls = {}
    for dtype in ("float32", "float16"):
        kcfg = cfg.replace(tmp_data_dtype=dtype)
        tmp = build_feature_blocks_reference(kcfg, cur.normals,
                                             cur.positions, accum, 1)
        w, mm = (t.contiguous() for t in fit_blocks(kcfg, tmp, 1,
                                                    impl="xla"))
        args = (kcfg, w, mm, cur.normals, cur.positions, accum, 1)
        calls[f"default {dtype}"] = (
            lambda args=args, tmp=tmp: weighted_sum(*args,
                                                    feature_blocks=tmp),
            args + (tmp,))
    return calls


def other_package(root, alias="bmfr_tpu_torch_other"):
    """Checkout ``root``'s ``bmfr_tpu_torch`` imported under ``alias``
    beside this checkout's (its modules import each other relatively), so
    its wrappers build and call its own kernels through its own
    ``ops/_lib.py``, whatever their entry points' arguments."""
    pkg = root / "bmfr_tpu_torch"
    spec = importlib.util.spec_from_file_location(
        alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return mod


def compare_k(cs, other_ws, cases):
    """This checkout's kernel K and another's, each through its own
    ``weighted_sum`` (``other_ws``) on ``cases`` (k_calls'): device ms per
    call in turns (other, this, this, other), and the largest
    |difference| of their outputs (NaN where NaN in both)."""
    import torch

    out = {}
    for key, (run, inputs) in cases.items():
        *args, tmp = inputs

        def other(args=args, tmp=tmp):
            return other_ws(*args, feature_blocks=tmp)

        ms = [cs.kernel_device_ms(f, "block_reconstruct_kernel", 20)
              for f in (other, run, run, other)]
        got_other, mine = other(), run()
        torch.cuda.synchronize()
        nan = mine.isnan() & got_other.isnan()
        same_nan = bool(torch.equal(mine.isnan(), got_other.isnan()))
        diff = float(torch.where(nan, 0.0, (mine - got_other).abs()).max())
        out[key] = dict(root_ms=[ms[0], ms[3]], this_ms=[ms[1], ms[2]],
                        max_abs_diff=diff, same_nan=same_nan)
        print(f"[K {key}] device ms per call: other checkout {ms[0]:.4f}, "
              f"{ms[3]:.4f}; this checkout {ms[1]:.4f}, {ms[2]:.4f}; "
              f"max |this - other| {diff:.3e}, NaN equal {same_nan}")
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=".", help="a checkout of the repository")
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="B")
    ap.add_argument("--basis", action="append",
                    help="a basis of chip_smoke.BASES (basis kernels only; "
                         "repeatable; default first_order and 16 columns)")
    ap.add_argument("--tile", action="append",
                    help="kernel F only: TXxTYxSTAGES, its tile and ring "
                         "depth (repeatable; default the source's own)")
    args = ap.parse_args()
    if args.tile and args.kernel != "F":
        raise SystemExit("--tile is kernel F's")
    root = Path(args.root).resolve()
    source, wrapper, solver, kname = KERNELS[args.kernel]
    loop = args.kernel in LOOPED
    work = Path(tempfile.mkdtemp(prefix="chol_phases_"))
    # kernel K: split this checkout's kernel, time --root's beside it,
    # built by its own _lib while this one builds
    other = None
    here = Path(__file__).resolve().parents[1]
    if args.kernel == "K" and root != here:
        other = other_package(root)
        other_build = ThreadPoolExecutor(1).submit(
            sys.modules[other.__name__ + ".ops._lib"].build)
        root = here
    built, names = build(root, work, source, kname if loop else None, loop,
                         args.tile or (None,))
    if other is not None:
        other_build.result()

    import numpy as np
    import torch

    sys.path.insert(0, str(root))
    import bmfr_tpu_torch as bt
    import chip_smoke as cs
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence
    from bmfr_tpu_torch.ops import _lib, fitter_direct

    assert bt.__file__.startswith(str(root)), bt.__file__
    if not torch.cuda.is_available():
        raise SystemExit("torch_chol_phases: no CUDA device")
    dev = torch.device("cuda:0")
    sc = synthetic_sequence(width=cs.WIDTH, height=cs.HEIGHT, frames=6)
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], dev)
    # each case: (a call of the wrapper, the fitters' column count)
    if args.kernel in ("F", "K"):
        cams = torch.from_numpy(sc["camera_matrices"]).to(dev)
        offs = torch.from_numpy(sc["pixel_offsets"]).to(dev)
        if args.kernel == "F":
            cases = {key: (call, None) for key, call in
                     f_calls(cs, inputs, cams, offs).items()}
        else:
            k_cases = k_calls(cs, inputs, cams, offs)
            cases = {key: (call, None)
                     for key, (call, _) in k_cases.items()}
    else:
        c5 = cs.frame_of(inputs, 5)
        base = bt.BMFRConfig(image_width=cs.WIDTH, image_height=cs.HEIGHT,
                             **cs.SCENE_LIMITS, **bt.FLAGSHIP).replace(
                                 solver=solver)
        if args.kernel == "B":
            bases = {"default": {}}
        else:
            for name, fn in cs.CROSS_FEATURES.items():
                bt.register_feature(name, fn)
            bases = {b: cs.BASES[b]
                     for b in args.basis or ("first_order", "16 columns")}
        fit = getattr(fitter_direct, wrapper)
        cases = {}
        for b, kw in bases.items():
            for m in MODES:
                cfg = base.replace(tmp_data_dtype=m, **kw)
                cases[f"{b} {m}"] = (
                    lambda cfg=cfg: fit(cfg, c5.normals, c5.positions,
                                        c5.noisy, 5), cfg.buffer_count)

    out = dict(root=str(root), kernel=args.kernel, source=source,
               gpu=cs.gpu_line(), ptxas={}, cases={})
    print(f"[gpu] {out['gpu']}")
    for tile, (lib, lib_stamped, report) in built.items():
        out["ptxas"][str(tile)] = report
        for line in report:
            print(f"[ptxas{'' if tile is None else ' ' + tile}] {line}")
        # the unchanged kernel's device times, then the stamped copy's
        _lib._lib = load(lib, _lib._SIGNATURES)
        plain_ms = {key: cs.kernel_device_ms(run, kname, 20)
                    for key, (run, _) in cases.items()}
        if other is not None:
            out["other"] = str(Path(other.__file__).parents[1])
            out["compare"] = compare_k(
                cs, importlib.import_module(
                    other.__name__ + ".ops.weighted_sum").weighted_sum,
                k_cases)
        stamped = _lib._lib = load(lib_stamped, _lib._SIGNATURES)
        for key, (run, columns) in cases.items():
            stamped_ms = cs.kernel_device_ms(run, kname, 20)
            assert stamped.bmfr_phase_clear() == 0
            run()
            torch.cuda.synchronize()
            clk = np.zeros((MAX_CTAS, MAX_WARPS, SLOTS), np.int64)
            sm = np.zeros(MAX_CTAS, np.uint32)
            assert stamped.bmfr_phase_read(
                clk.ctypes.data_as(ctypes.c_void_p),
                sm.ctypes.data_as(ctypes.c_void_p)) == 0
            rec = (summarize_loop if loop else summarize)(clk, sm, names)
            span_max = rec.pop("sm_span_max_cycles")
            rec.update(columns=columns, device_ms=plain_ms[key],
                       stamped_device_ms=stamped_ms,
                       # the SM clock, as the longest SM span over the call
                       cycles_per_us=float(span_max / (stamped_ms * 1e3)))
            label = " ".join([args.kernel, *([tile] if tile else []), key])
            out["cases"][label] = rec
            report_case(label, rec)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
