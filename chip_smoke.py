"""Chip smoke test of the PyTorch/CUDA port (bmfr_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the CUDA kernels from ``bmfr_tpu_torch/csrc/`` with nvcc
and holds each against its plain PyTorch version at 1280x720 on the
orbit scene: A (warp + blend), B (Cholesky direct fitter, f32 and f16
tmp; its device time also on bf16), C (Householder direct fitter, both
entries), D (block fitter: f32, f16 and bf16 tmp at block_edge 32, f32 at
8, 16, 48 and 64) and E (row-pair gather, bit-equal, also at saturated
coordinates). For each kernel it measures
its device time per call (torch.profiler), computes its bound (the bytes
it must move over 3.35 TB/s or its f32 operations over 67 TFLOP/s,
whichever is larger) from this run's inputs, and times the one PyTorch
call that computes the same function where there is one
(``torch.linalg.lstsq`` for C and D; the port never calls it). Then it drives three
paths through ``denoise_sequence`` over 16 frames of the 1280x720 orbit
scene: the JAX package's flagship (kernels A and B), the default
``BMFRConfig()`` (the reference-exact path: kernel D) and the flagship
with ``solver="householder"`` (kernels A and C). ``denoise_sequence``
runs frame 0 eagerly and replays the compiled step (a CUDA graph,
``pipeline/graph.py``) for frames 1-15. For each path it checks the
launch counts, that the compiled frames equal the eager step bit for
bit, agreement with the same path on the plain versions and that every
frame is closer to the clean render than its noisy input, and times the
steady frames eager and compiled with CUDA events and the profiler
(device busy ms and kernels per frame, capture seconds, peak memory),
with the launches per frame that the in-kernel noise saves; then the
per-stage device split of the flagship and the default path
(``profile_stages --trace``). The stream phase
writes the 16 frames to a temporary directory in the TUNI layout
(``io/export.py``; a second directory links the same files under a
camera header with a tight position limit), finds both with
``discover_scenes``, streams the flagship and the default path from disk
in chunks of 5 (``stream_scene``, whose chunk runner replays its
compiled step on a ``TemporalState`` carry, the flagship's warp kernel I
in packed_bf16: launch counts, bit-equal to ``denoise_sequence``),
resumes the flagship from a checkpoint at frame 8 through
``make_denoise_frame``'s compiled step (bit-equal), streams both
directories at once (``stream_scenes``: the
first bit-equal, the second different), and splits the streamed
flagship's time into ingest, compute and wall. Kernel E
is off every pipeline path: it is driven by ``gather_taps(mode=
"pallas")`` over the default path's 15 warped states. Three fidelity
phases follow, each with every count set to 0 before it and held to what
its configurations launch: ``[fidelity r5]`` runs the fidelity sweep
(``bmfr_tpu_torch/fidelity.py``, 11 configurations) over the four
synthetic scenes at 128x96x8 and holds its 44 rows to the JAX package's
TPU record ``FIDELITY_r5.json`` (noisy PSNR to 1e-9 dB; PSNR to 0.02 dB
and SSIM to 1e-3, ``tmp_f16`` to 0.1 dB and 2e-3); ``[fidelity
1280x720]`` sweeps corridor and swing at full size over 4 frames (every
row above its noisy input, the flagships within 0.1 dB of the default
path); ``[oracle]`` holds the default path and the flagship to the
port's copy of the NumPy oracle at 72x48x4 on orbit, corridor and swing
(``bmfr_tpu_torch/parity.py``).

``[tail kernels]`` (after kernel E) holds the kernels that stand for
the stages XLA fuses in the TPU step, H (``reproject_coords``), G
(``noisy_tail``: the K1 tail and the state's words 0:5) and F
(``filtered_tail``: K4, K5 and words 5:8), to their plain versions at
1280x720 on orbit frame 1, the flagship's packed carry and bf16 residual
and the default path's f32 residual, every value and word equal (NaN
where NaN), F also on a reprojection that leaves the screen with NaN and
infinities in it, with each kernel's device ms, bound, wrapper and plain
ms; every path, stream, staging, scenes, entry, sweep and oracle phase
holds H, G and F to one launch a frame.

``[default kernels]`` (after ``[tail kernels]``) holds the kernels that
stand for the default path's stages XLA fuses in the TPU step, I
(``warp_blend_planes``: the raw-plane tap warp + blend), J
(``build_feature_blocks``: the feature-block store) and K
(``weighted_sum``: the block reconstruction), to their plain versions at
1280x720 on orbit frame 1 with the default path's state: I in each warp
mode bit for bit (NaN where NaN), also on the NaN-laden field over a
random state with NaN and infinite values; J bit for bit in each tmp
dtype at three jitter frames; K within ``K_TOL`` of the products'
magnitudes on the reused f32 blocks, with NaN positions (at every one of
the 16 jitter frames), and on f16 tmp, and on the first-order and
16-column bases (its table instance) at four jitter frames;
with each kernel's device ms, bound, wrapper and plain ms, and for K
``torch.einsum`` on the rescaled blocks as its library yardstick. The
default path's phases (``[path default]``, stream, staging, scenes,
sweep, oracle, ``[bench]``) hold I to a launch a frame with history and
J and K to one a frame.

The later slices' phases: ``[basis B]`` and ``[basis C]`` hold kernels B
and C on feature bases of 4, 7, 10 (first order) and 16 columns (three
cross terms registered with ``register_feature``, which the kernels read
as extra planes beside the ten built-in features they compute) to their
plain versions at 1280x720 on f32, f16 and bf16 tmp, each with its
device ms, its bound over the planes it reads, the
default-basis kernel's ms in the same call and, for C,
``torch.linalg.lstsq`` at each column count; ``[basis override]``
registers ``normal_x`` anew and holds B and C on the card to their plain
versions, which evaluate the registry; ``[path flagship first_order]``
and ``[path householder flagship 16 columns]`` drive the flagship on the
first-order basis (the basis B) and the householder flagship on the
16-column basis (the basis C) like the other paths; ``[scenes]`` renders three
more 1280x720x16 scenes (an orbit seed, corridor, swing) and runs the
flagship and the default path through ``denoise_scenes_sharded`` over
1, 2 and 4 scenes of the card and 4 on a mesh that names the card twice
(bit-equal to the per-scene ``denoise_sequence``, launch counts held),
timing each card-frame of S scenes (one graph of S steps); ``[entry]``
runs ``graft_entry.entry()``'s step eagerly, captured and replayed
(equal; on its TemporalState kernel I, not A); ``[dryrun]`` runs ``dryrun_multichip`` on the card and on a
mesh naming it four times (every scene equal to its per-scene run).
``[staging]`` (after ``[stream]``) stages the orbit scene with
``io/staging.py::stage_scene``, the EXR codec cycled per file over ZIP,
ZIPS, PIZ, PXR24 and B44 (after one 1280x720 file of each codec on one
thread, timed), requires the native IO library built, finds and loads
the scene bit-equal to the arrays staging returned, streams the
flagship (A, B) and the default path (D) from it with the ``[stream]``
phase's launch counts, each bit-equal to ``denoise_sequence`` on those
arrays in memory, times the flagship streamed from it beside the ZIP
scene of ``[stream]``, runs ``python -m bmfr_tpu_torch.cli --scene
<staged dir> --device 0`` to PNGs that the native and the Python PNG readers
read equal to each other and to the in-memory run quantised as
``io/exr.py::write_png`` does, and prints each codec's native decode
seconds per file (median of 5), its bytes and ``read_exr_py``'s seconds.
``[bench]`` (after ``[oracle]``) runs ``python -m bmfr_tpu_torch.bench``
once as a subprocess with no ``BENCH_*`` set (the 60-frame 1280x720
orbit flagship, median of 5 runs: its last line parsed, every key of
``bench.py``'s line and the port's three, the device numbers measured,
the launches of one run A 59 and B 60, H, G and F 60 on every cell) while
host threads render the 60-frame swing and orbit scenes; then the bench's
``run_bench`` in this process on the swing flagship (A 59, B 60), the
reference-exact default path (D 60) and the householder flagship (A 59,
C 60), each with every
count set to 0 just before it and read just after. Each cell's profiled
run (its busy and span) goes through ``profile_stages.checked_trace``:
the phase prints each cell's trace check (device events of the port's
kernels against the launches of one run, and which trace held them) and
fails on a bench that raises, as one does after three lossy traces.
``[bench trace]``
splits the flagship's 60-frame sequence by stage
(``profile_stages.sequence_trace_report``: the eager pass's stages, the
compiled sequence's busy time and span) and fails unless the eager total
with the copies the compiled step adds lies within 5 % of the compiled
busy time and each trace holds one device event of the port's kernels
per launch counted (as ``[stages *]`` does). ``[carry]`` (after
``[bench trace]``, on the same 60-frame orbit scene) runs
``denoise_sequence`` from a ``TemporalState`` (the stream's, the
checkpoint's and ``graft_entry``'s carry) on the graft entry's
configuration (the Householder flagship), the Cholesky flagship and the
default path, and the flagships also from a ``PackedState``: per run the
launches (every count set to 0 just before; the fused warp's
``TemporalState`` runs kernel I in packed_bf16 59 times and kernel A
never), the headline-style ms/frame (median of 5 runs), and a checked
trace's busy ms/frame, device operations and copies a frame; the
flagships' 60 results equal on the two carries bit for bit
(``scripts/torch_carry_ab.py`` runs the same cells on a parent
checkout). Each phase prints its seconds.

The last line is the JSON contract ``{"ok": true, "device": {...}}``;
any failed check exits non-zero before it. Without a CUDA device it
exits non-zero at once.
"""

from __future__ import annotations

import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch.io import exr_py, native, png
from bmfr_tpu_torch.io.dataset import discover_scenes
from bmfr_tpu_torch.io.export import export_scene, write_camera_header
from bmfr_tpu_torch import bench, graft_entry, parity
from bmfr_tpu_torch.fidelity import (device_name, print_report, run_sweep,
                                     synthetic_scenes)
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.io.staging import STAGE_CODECS, stage_scene
from bmfr_tpu_torch.metrics import psnr
from bmfr_tpu_torch.ops import _lib
from bmfr_tpu_torch.ops.blockify import (STORAGE_DTYPES, build_feature_blocks,
                                         build_feature_blocks_reference,
                                         unblockify_planes)
from bmfr_tpu_torch.ops.fitter import highest_precision
from bmfr_tpu_torch.ops.fitter import scale_blocks, storage_roundtrip
from bmfr_tpu_torch.ops.fitter_direct import (
    basis_plan, fit_blocks_direct, fit_blocks_direct_reference,
    fit_reconstruct_cholesky, fit_reconstruct_cholesky_reference,
    fit_reconstruct_direct, fit_reconstruct_direct_reference)
from bmfr_tpu_torch.ops.fitter_pallas import (fit_blocks_pallas,
                                              fit_blocks_pallas_reference)
from bmfr_tpu_torch.ops.gather import floor_int
from bmfr_tpu_torch.ops.reproject import (noisy_tail, noisy_tail_reference,
                                          reproject_coords,
                                          reproject_coords_reference)
from bmfr_tpu_torch.ops.tail import (filtered_tail, filtered_tail_loader,
                                     filtered_tail_reference)
from bmfr_tpu_torch.ops.warp import (gather_taps, pack_pairs_bf16,
                                     pack_x_pairs_bf16, warp_rows,
                                     warp_rows_reference)
from bmfr_tpu_torch.ops.warp_blend import (TAP_MODES, warp_blend,
                                           warp_blend_planes,
                                           warp_blend_planes_reference,
                                           warp_blend_reference)
from bmfr_tpu_torch.ops.weighted_sum import (block_basis,
                                             reconstruct_geometry,
                                             weighted_sum,
                                             weighted_sum_reference)
from bmfr_tpu_torch.pipeline.graph import CompiledStep
from bmfr_tpu_torch.profile_stages import (TRACE_ATTEMPTS, eager_sequence,
                                           sequence_trace_report,
                                           steady_setup, trace_report)
from bmfr_tpu_torch.profiling import RUN_RANGE, device_events, traced_run
from bmfr_tpu_torch.rng import feature_noise

WIDTH, HEIGHT, FRAMES = 1280, 720, 16
#: frames per chunk of the stream phase: chunks of 5, 5, 5 and 1
STREAM_CHUNK = 5
#: kernel A: accept plane equal on this share of pixels (flips only from
#: rounding at the limit compare); other planes to 1e-5 (rtol = atol)
ACCEPT_SHARE, WARP_TOL = 0.9999, 1e-5
#: kernels B and C: |err| <= 5e-3 + 5e-3 |ref| on the reconstruction
#: (tests/test_fitter_direct.py:146)
FIT_TOL = 5e-3
#: kernels C and D: weights to 2e-3 (f32) / 5e-3 (f16, bf16)
#: (tests/test_fitter_pallas.py:27-37, :75-77), mins/maxs to 1e-6. f32
#: holds every weight to |err| <= tol + tol |ref|; f16/bf16 hold the
#: weights' relative norm |w - ref| / |ref| to tol: on the orbit scene's
#: blocks a mere reordering of the plain version's sums moves 6 (f16) and
#: 87 (bf16) of 29520 weights past the elementwise bound at 1280x720, at
#: a relative norm of 3.1e-4 / 8.7e-4
WEIGHT_TOL = {"float32": 2e-3, "float16": 5e-3, "bfloat16": 5e-3}
MM_TOL = 1e-6
#: each path with kernels vs with plain versions, per frame
PATH_MIN_DB = 60.0
SCENE_LIMITS = dict(position_limit_squared=0.03, normal_limit_squared=0.5)
#: the kernel each configuration of the fidelity sweep launches, by its
#: letter (A warp_blend, B fit_reconstruct_cholesky, C
#: fit_reconstruct_direct, D fit_blocks_pallas; "cholesky" fits its blocks
#: with the plain Cholesky solve, as JAX's falls back to XLA; I
#: warp_blend_planes on every warped frame of a raw-plane warp, J
#: build_feature_blocks and K weighted_sum on every frame of the block
#: path), beside F filtered_tail, G noisy_tail and H reproject_coords,
#: which every configuration launches once a frame
SWEEP_KERNELS = {
    "default": "DIJK", "cholesky": "IJK", "tmp_f16": "DIJK",
    "warp_packed": "DIJK", "warp_pallas": "ADJK", "flagship": "AC",
    "flagship_cholesky": "AB", "flagship_f32res": "AC",
    "residual_bf16": "DIJK", "no_taa": "DIJK", "first_order": "DIJK"}
#: [fidelity r5]: the JAX package's TPU record, row by row: noisy_psnr to
#: 1e-9 dB; psnr_mean/first/last (dB) and ssim_mean to these, per config
R5_NOISY_TOL = 1e-9
R5_TOL = {"tmp_f16": (0.1, 2e-3)}
R5_TOL_DEFAULT = (0.02, 1e-3)
#: [fidelity 1280x720]: the flagships within this of the default path's
#: psnr_mean (BASELINE.md:25)
FLAGSHIP_GAP_DB = 0.1
#: [oracle]: size and frames (the workset rounds on both axes)
ORACLE_W, ORACLE_H, ORACLE_T = 72, 48, 4
#: the H100 SXM's data-sheet peaks: HBM bytes
#: per second and f32 operations per second outside the tensor cores
PEAK_BYTES, PEAK_F32 = 3.35e12, 67e12


#: kernels H, G and F, launched once a frame on every path
TAILS = {"reproject_coords": reproject_coords, "noisy_tail": noisy_tail,
         "filtered_tail": filtered_tail}


#: kernels I, J and K, launched on the default path (every block path
#: with a raw-plane warp): I on every frame with history, J and K on every
#: frame; their launches over the FRAMES frames of a sequence
DEFAULT_KERNELS = {"warp_blend_planes": warp_blend_planes,
                   "build_feature_blocks": build_feature_blocks,
                   "weighted_sum": weighted_sum}
DEFAULT_LAUNCHES = {"warp_blend_planes": FRAMES - 1,
                    "build_feature_blocks": FRAMES, "weighted_sum": FRAMES}
#: kernel K against its plain version (a batched product in another
#: summation order): |kernel - plain| <= K_TOL * sum_f |basis_f w_f| per
#: pixel, what an f32 10-term dot product's rounding allows either way
K_TOL = 2e-6
#: the Cholesky flagship on a TemporalState carry (the stream's and the
#: checkpoint's): kernel I in packed_bf16 on every frame with history and
#: kernel A on none; its counters and their launches over FRAMES frames
TEMPORAL_FLAGSHIP = (
    {"warp_blend": warp_blend, "warp_blend_planes": warp_blend_planes,
     "fit_reconstruct_cholesky": fit_reconstruct_cholesky},
    {"warp_blend": 0, "warp_blend_planes": FRAMES - 1,
     "fit_reconstruct_cholesky": FRAMES})


def with_tails(counters, expected, frames):
    """A path's counters and expected launches with kernels H, G and F
    added, ``frames`` launches each."""
    return ({**counters, **TAILS},
            {**expected, **dict.fromkeys(TAILS, frames)})


def bound(nbytes, flops):
    """(ms, what bounds it): the least time the card could take to move
    ``nbytes`` and do ``flops`` f32 operations."""
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, flops / PEAK_F32 * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def qr_flops(n_blocks, bp, columns):
    """f32 operations of the Householder reflections of n_blocks blocks:
    per reflection col, sigma (2 per row) and for each trailing column a
    dot (2 per row) and the update (3 per row)."""
    F = columns - 3
    return n_blocks * bp * sum(2 + 5 * (columns - 1 - c) for c in range(F))


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAIL: {msg}")


def gpu_line():
    return device_name(torch.device("cuda:0"))


def cuda_ms(fn, reps, warmup=2):
    """Mean device ms per call of ``fn`` (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_breakdown(label, run, frames):
    """Profile ``run()`` (``frames`` steady frames) and print device
    time by kernel, launches per frame and the device's busy share of
    the span from its first to its last kernel. Returns a dict, or None
    when the profiler recorded no device events."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with traced_run([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    warm=run) as prof:
        run()
        torch.cuda.synchronize()
    kern = device_events(prof.events(), within=RUN_RANGE)
    if not kern:
        print(f"[profile {label}] no device events recorded: not measured")
        return None
    by_name = {}
    for e in kern:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(f"[profile {label}] {frames} steady frames: "
          f"{len(kern) / frames:.1f} device kernels/frame, device busy "
          f"{busy / frames / 1e3:.4f} ms/frame = {100 * busy / span:.1f}% "
          f"of the kernel span {span / frames / 1e3:.4f} ms/frame")
    for name, (n, us) in rows[:12]:
        print(f"[profile {label}]   {us / frames / 1e3:8.4f} ms/frame "
              f"{100 * us / busy:5.1f}%  x{n / frames:4.1f}  {name[:90]}")
    return dict(kernels_per_frame=len(kern) / frames,
                busy_ms_per_frame=busy / frames / 1e3,
                span_ms_per_frame=span / frames / 1e3,
                top={name[:60]: us / frames / 1e3
                     for name, (n, us) in rows[:6]})


def kernel_device_ms(fn, kernel, calls=10):
    """Device ms per call of ``fn`` spent in kernels whose name contains
    ``kernel`` (torch.profiler: one call in the trace, then ``calls``
    more, every event of the trace counted: a long process's traces have
    placed events outside their run's range, ROADMAP Queue 3), or None
    when no device event was recorded."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with traced_run([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    warm=fn) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in device_events(prof.events())
          if kernel in e.name]
    if len(us) % (calls + 1):
        print(f"[trace] {kernel!r}: {len(us)} device events for {calls + 1} "
              "calls")
    return sum(us) / (calls + 1) / 1e3 if us else None


def kernel_names(fn):
    """The names of the device kernels one call of ``fn`` launches
    (torch.profiler; empty when no device event was recorded)."""
    from torch.profiler import ProfilerActivity

    torch.cuda.synchronize()
    with traced_run([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    warm=fn) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in device_events(prof.events(), within=RUN_RANGE)]


def kernels_launched(fn):
    """Device kernels one call of ``fn`` launches (torch.profiler), or
    None when no device event was recorded."""
    return len(kernel_names(fn)) or None


def stored_system(cfg, tmp, frame):
    """The rescaled, noised f32 system that the fitters solve from the
    blocks ``tmp``: A ``[n_blocks, bp, F]``, b ``[n_blocks, bp, 3]``."""
    F = cfg.feature_count
    data, _ = scale_blocks(cfg, tmp.float())
    data = storage_roundtrip(cfg, data)
    noise = feature_noise(frame, F, cfg.block_pixels, cfg.buffer_count,
                          cfg.noise_amount, tmp.device)
    A = (data[:, :F] + noise[None]).transpose(1, 2).contiguous()
    return A, data[:, F:].transpose(1, 2).contiguous()


def lstsq_yardstick(cfg, tmp, w_kernel, frame):
    """Time ``torch.linalg.lstsq`` on the system that kernel D fits
    (``stored_system``), the one PyTorch call that computes the same
    least-squares weights. Returns (ms per call, relative norm of its
    weights from the kernel's)."""
    A, b = stored_system(cfg, tmp, frame)
    sol = torch.linalg.lstsq(A, b).solution
    rel = float((sol - w_kernel).norm() / w_kernel.norm())
    return cuda_ms(lambda: torch.linalg.lstsq(A, b), 10), rel


def tone_map(a):
    """Gamma 1/2.2 and clamp, as K4 tone-maps (opencl/bmfr.cl:852-856)."""
    return np.clip(np.power(np.maximum(a, 0.0), 0.454545), 0.0, 1.0)


def frame_of(inputs, t):
    return bt.FrameInputs(*(x[t] for x in inputs))


def off_tolerance(got, ref, tol):
    return int(((got - ref).abs() > tol + tol * ref.abs()).sum())


def check_warp(cfg, state, cur, pfx, pfy, label):
    """Kernel A vs its plain version on one field. Returns max |err|."""
    got = warp_blend(cfg, state.src8, cur.positions, cur.normals, pfx, pfy)
    ref = warp_blend_reference(cfg, state.src8, cur.positions, cur.normals,
                               pfx, pfy)
    torch.cuda.synchronize()
    flips = int((got[5] != ref[5]).sum())
    share = 1.0 - flips / got[5].numel()
    ix, iy = floor_int(pfx), floor_int(pfy)
    on = ((ix >= -1) & (iy >= -1) & (ix < cfg.image_width)
          & (iy < cfg.image_height) & (got[5] == ref[5]))
    diff = (got - ref).abs()
    bound = WARP_TOL + WARP_TOL * ref.abs()
    bad = int(((diff > bound) & on[None]).sum())
    err = float(torch.where(on[None], diff, 0.0).max())
    print(f"[warp_blend] {label}: max |err| {err:.3e} on on-screen pixels, "
          f"accept flips {flips} ({100 * share:.4f}% equal), "
          f"off-tolerance values {bad}, on-screen pixels {int(on.sum())}")
    require(share >= ACCEPT_SHARE, f"warp {label}: accept flips {flips}")
    require(bad == 0, f"warp {label}: {bad} values off tolerance")
    require(bool(torch.isfinite(got).all()), f"warp {label}: non-finite")
    return err


def check_reconstruct(name, fit, plain, cfg, cur, accum, frame):
    """Kernel B or C (reconstructing entry) vs its plain version at one
    frame. Returns max |err|."""
    got, w = fit(cfg, cur.normals, cur.positions, accum, frame)
    ref, wr = plain(cfg, cur.normals, cur.positions, accum, frame)
    torch.cuda.synchronize()
    bad = off_tolerance(got, ref, FIT_TOL)
    err = float((got - ref).abs().max())
    db = psnr(got.cpu().numpy(), ref.cpu().numpy())
    zero = int((w == 0).all(dim=(1, 2)).sum())
    zero_ref = int((wr == 0).all(dim=(1, 2)).sum())
    print(f"[{name}] {cfg.tmp_data_dtype} frame {frame}: max |err| "
          f"{err:.3e}, off-tolerance values {bad} of {got.numel()}, "
          f"{db:.2f} dB, zero-weight blocks {zero} (plain {zero_ref}) of "
          f"{w.shape[0]}")
    require(bad == 0, f"{name} frame {frame}: {bad} values off tolerance")
    require(zero == zero_ref, f"{name} frame {frame}: zero-weight blocks "
            f"{zero} vs {zero_ref}")
    require(bool(torch.isfinite(got).all()), f"{name} frame {frame}: "
            "non-finite")
    return err


def check_weights(name, label, w, mm, wr, mmr, dtype):
    """Weights and mins/maxs of a Householder kernel vs its plain version
    (``WEIGHT_TOL``). Returns max |err| of the weights."""
    torch.cuda.synchronize()
    tol = WEIGHT_TOL[dtype]
    bad_w = off_tolerance(w, wr, tol)
    bad_mm = off_tolerance(mm, mmr, MM_TOL)
    err_w = float((w - wr).abs().max())
    rel = float((w - wr).norm() / wr.norm())
    err_mm = float((mm - mmr).abs().max()) if mm.numel() else 0.0
    print(f"[{name}] {label}: weights max |err| {err_w:.3e}, relative norm "
          f"{rel:.3e} (elementwise off {tol:g}: {bad_w} of {w.numel()}), "
          f"mins/maxs max |err| {err_mm:.3e} (off: {bad_mm})")
    require(rel <= tol, f"{name} {label}: weights' relative norm {rel:.3e}")
    require(bad_w == 0 or dtype != "float32",
            f"{name} {label}: {bad_w} weights off tolerance")
    require(bad_mm == 0, f"{name} {label}: {bad_mm} mins/maxs off")
    require(bool(torch.isfinite(w).all()), f"{name} {label}: non-finite")
    return err_w


def check_rows(src, iy, ix, label):
    """Kernel E vs the two clipped gathers: bit equality on every pixel."""
    row0, row1 = warp_rows(src, iy, ix)
    ref0, ref1 = warp_rows_reference(src, iy, ix)
    torch.cuda.synchronize()
    diff = int((row0 != ref0).sum() + (row1 != ref1).sum())
    print(f"[warp_rows] {label}: {diff} words differ of {2 * row0.numel()}")
    require(diff == 0, f"warp_rows {label}: {diff} words differ")
    return 0.0


def check_same(name, label, got, want):
    """A kernel of F, G and H against its plain version: equal as values
    on every element (``-0 == +0``), NaN where NaN. Returns the largest
    |difference| of the finite values (0 when equal)."""
    torch.cuda.synchronize()
    got, want = got.float(), want.float()
    both_nan = got.isnan() & want.isnan()
    differ = int((~((got == want) | both_nan)).sum())
    fin = torch.isfinite(got) & torch.isfinite(want)
    err = float(torch.where(fin, (got - want).abs(), 0.0).max())
    print(f"[{name}] {label}: {differ} of {got.numel()} values differ from "
          f"the plain version's (max |err| {err:.3e}; NaN in both "
          f"{int(both_nan.sum())})")
    require(differ == 0, f"{name} {label}: {differ} values differ")
    return err


def tail_phase(flagship, exact, inputs, cams, offs, field):
    """[tail kernels]: kernels H (reproject_coords), G (noisy_tail) and F
    (filtered_tail) against their plain versions at 1280x720 on the orbit
    scene's frame 1, for the flagship (packed carry, bf16 residual) and
    the default path (no pack, f32 residual), each output and word equal
    as values; F also on ``field``, a reprojection that leaves the screen
    at every edge with NaN and infinities in it. F must run its TMA-fed
    variant on both paths (``filtered_tail_loader`` and the kernel's name
    in a trace). Returns ``(errs, ms, dev_ms, bounds)`` by letter: the
    largest |err|, (wrapper, plain) ms per call, device ms per call and
    each kernel's bound (the flagship's, F's on the default path's f32
    residual, no words, as "F default", and G's storing into the default
    path's TemporalState carry, as "G into", whose stores G and F are held
    to their plain versions' there too)."""
    from bmfr_tpu_torch.pipeline.denoise import _filter, _warp_planes

    t0 = time.perf_counter()
    errs = dict.fromkeys("FGH", 0.0)
    ms, dev_ms, bounds = {}, {}, {}
    cur = frame_of(inputs, 1)
    n_px = HEIGHT * WIDTH
    for label, cfg in (("flagship", flagship), ("default", exact)):
        st0, _ = bt.denoise_frame(cfg, bt.zero_state(cfg, inputs.noisy.device),
                                  frame_of(inputs, 0), cams[0], offs[0], 0)
        args_h = (cfg, cur.positions, cams[0], offs[1])
        pp = reproject_coords(*args_h)
        for history in ("always", "never"):
            errs["H"] = max(errs["H"], check_same(
                "reproject_coords", f"{label} history={history}",
                reproject_coords(*args_h, history),
                reproject_coords_reference(*args_h, history)))
        planes = _warp_planes(cfg, st0, cur, pp[0], pp[1], True, False)[0]
        src8 = getattr(st0, "src8", None)
        packs = ([src8.clone(), src8.clone()] if src8 is not None
                 else [None, None])
        args_g = (cfg, cur.noisy, pp, planes, cur.positions, cur.normals, 1)
        k1 = noisy_tail(*args_g, pack=packs[0])
        k1_ref = noisy_tail_reference(*args_g, pack=packs[1])
        for k in ("accum", "spp", "accept"):
            errs["G"] = max(errs["G"], check_same(
                "noisy_tail", f"{label} {k}", k1[k], k1_ref[k]))
        filtered = _filter(cfg, cur, k1["accum"], 1, False)[0]
        for field_label, prev_pixels in (("orbit", pp), ("field", field)):
            args_f = (cfg, filtered, planes, cur.albedo, k1["spp"],
                      prev_pixels, 1)
            got = filtered_tail(*args_f, pack=packs[0])
            want = filtered_tail_reference(*args_f, pack=packs[1])
            for k, g, w in zip(("out", "tone", "result"), got, want):
                errs["F"] = max(errs["F"], check_same(
                    "filtered_tail", f"{label} {field_label} {k} "
                    f"({cfg.residual_dtype} residual)", g, w))
        if src8 is not None:
            diff = int((packs[0] != packs[1]).sum())
            print(f"[tail kernels] {label}: the state words G and F wrote "
                  f"differ from the plain versions' in {diff} of "
                  f"{packs[0].numel()}")
            require(diff == 0, f"tail kernels {label}: {diff} words differ")
        scratch = packs[0]
        run_h = (lambda: reproject_coords(*args_h),
                 lambda: reproject_coords_reference(*args_h))
        run_g = (lambda: noisy_tail(*args_g, pack=scratch),
                 lambda: noisy_tail_reference(*args_g, pack=scratch))
        args_f = (cfg, filtered, planes, cur.albedo, k1["spp"], pp, 1)
        run_f = (lambda: filtered_tail(*args_f, pack=scratch),
                 lambda: filtered_tail_reference(*args_f, pack=scratch))
        loader = filtered_tail_loader(
            WIDTH, [t.data_ptr() for t in (filtered, planes, cur.albedo, pp)])
        f_names = [n for n in kernel_names(run_f[0]) if "filtered_tail" in n]
        print(f"[tail kernels] {label}: F's loader {loader}, kernels "
              f"{[n[:80] for n in f_names]}")
        require(loader == "tma" and len(f_names) == 1
                and "TmaLoads" in f_names[0],
                f"tail kernels {label}: F did not run its TMA-fed variant")
        if label == "default":
            # the compiled step's TemporalState destination: G stores the
            # raw positions, normals, noisy and spp into it, F out and
            # result
            intos = [bt.TemporalState(*(torch.empty_like(t) for t in (
                cur.normals, cur.positions, cur.noisy, k1["spp"], cur.noisy,
                cur.noisy))) for _ in range(2)]
            k1i = noisy_tail(*args_g, into=intos[0])
            noisy_tail_reference(*args_g, into=intos[1])
            args_fi = (cfg, filtered, planes, cur.albedo, k1i["spp"], pp, 1)
            filtered_tail(*args_fi, into=intos[0])
            filtered_tail_reference(*args_fi, into=intos[1])
            for name, a, b in zip(intos[0]._fields, *intos):
                key = "F" if name in ("out", "result") else "G"
                errs[key] = max(errs[key], check_same(
                    {"G": "noisy_tail", "F": "filtered_tail"}[key],
                    f"default into.{name}", a, b))
            dev_ms["G into"] = kernel_device_ms(
                lambda: noisy_tail(*args_g, into=intos[0]),
                "noisy_tail_kernel")
            # the reads, accept and the carry's positions, normals, noisy
            # and spp: 98 B a pixel
            bounds["G into"] = bound(
                nbytes(planes[0:6], cur.noisy, cur.positions, cur.normals,
                       k1["accept"], *intos[0][:4]), 30 * n_px)
            dev_ms["F default"] = kernel_device_ms(run_f[0],
                                                   "filtered_tail_kernel")
            # no words: the reads and out, tone and result (~101 B a
            # pixel)
            bounds["F default"] = bound(
                nbytes(filtered, planes[4], planes[6:13], cur.albedo,
                       k1["spp"], pp) + 9 * 4 * n_px, 220 * n_px)
            continue
        for key, (kernel, plain), name in (
                ("H", run_h, "reproject_kernel"),
                ("G", run_g, "noisy_tail_kernel"),
                ("F", run_f, "filtered_tail_kernel")):
            ms[key] = (cuda_ms(kernel, 50), cuda_ms(plain, 10))
            dev_ms[key] = kernel_device_ms(kernel, name)
        # each input read once, each output written once; f32 operations
        # per pixel: H ~30 (three dot products, two divisions); G ~30;
        # F ~220 (K4 with three powf, the 3x3 and cross min/max, the clamp
        # and blend)
        bounds.update({
            "H": bound(nbytes(cur.positions, cams[0], offs[1], pp),
                       30 * n_px),
            "G": bound(nbytes(planes[0:6], cur.noisy, cur.positions,
                              cur.normals, k1["accum"], k1["spp"],
                              k1["accept"]) + 5 * 4 * n_px, 30 * n_px),
            "F": bound(nbytes(filtered, planes[4], planes[6:13], cur.albedo,
                              k1["spp"], pp) + (9 + 3) * 4 * n_px,
                       220 * n_px)})
    print(f"[tail kernels] the phase took {time.perf_counter() - t0:.1f} s")
    return errs, ms, dev_ms, bounds


def check_bits(name, label, got, want):
    """A kernel of I and J against its plain version: bit for bit where
    not NaN, NaN where NaN. Returns the largest |difference| (0 when
    equal)."""
    torch.cuda.synchronize()
    ints = {4: torch.int32, 2: torch.int16}[got.element_size()]
    nan = got.float().isnan() & want.float().isnan()
    differ = int((~((got.view(ints) == want.view(ints)) | nan)).sum())
    fin = torch.isfinite(got.float()) & torch.isfinite(want.float())
    err = float(torch.where(fin, (got.float() - want.float()).abs(),
                            0.0).max())
    print(f"[{name}] {label}: {differ} of {got.numel()} values differ from "
          f"the plain version's in their bits (NaN in both {int(nan.sum())})")
    require(differ == 0, f"{name} {label}: {differ} values differ")
    return err


def check_reconstruction(label, cfg, w, mm, planes, frame, blocks):
    """Kernel K against its plain version: NaN where NaN, elsewhere within
    ``K_TOL`` of the products' magnitudes. Returns the largest |err|."""
    n, pos, accum = planes
    args = (cfg, w, mm, n, pos, accum, frame)
    got = weighted_sum(*args, feature_blocks=blocks)
    want = weighted_sum_reference(*args, feature_blocks=blocks)
    basis = block_basis(cfg, mm, n, pos, frame, blocks)
    with highest_precision():
        mag = unblockify_planes(
            cfg, torch.einsum("bfe,bfc->bce", basis.abs(), w.abs()), frame)
    torch.cuda.synchronize()
    nan = want.isnan()
    same_nan = bool(torch.equal(got.isnan(), nan))
    diff = torch.where(nan, 0.0, (got - want).abs())
    bad = int((diff > K_TOL * torch.where(nan, 0.0, mag)).sum())
    err = float(diff.max())
    rel = float(torch.where(nan, 0.0, diff / mag.clamp_min(1e-30)).max())
    print(f"[weighted_sum] {label}: max |err| {err:.3e}, max |err| over the "
          f"products' magnitudes {rel:.3e} (tolerance {K_TOL:g}, off: {bad}),"
          f" NaN pixels {int(nan.sum())} (same in both: {same_nan})")
    require(same_nan and bad == 0, f"weighted_sum {label}: NaN equal "
            f"{same_nan}, {bad} values off tolerance")
    return err


def default_kernels_phase(exact, inputs, cams, offs, field):
    """[default kernels]: kernels I (warp_blend_planes), J
    (build_feature_blocks) and K (weighted_sum), the default path's stages
    XLA fuses in the TPU step, against their plain versions at 1280x720 on
    the orbit scene's frame 1 with the default path's state after frame
    0: I in each warp mode (and in float32 on ``field``, a reprojection
    with NaN and infinities, over a random state with NaN and infinite
    values) and J in each tmp dtype, bit for bit; K within ``K_TOL`` on
    the reused f32 blocks, with NaN positions (also at each of the 16
    jitter frames), and on f16 tmp (raw features, NaN kept), and its
    table instance on the first-order and 16-column bases of ``BASES``
    at four jitter frames on f32 and f16 tmp. Returns ``(errs, ms,
    dev_ms, bounds, library)`` by letter: the largest |err|, (wrapper, plain) ms per call, device ms
    per call, the bound, and K's library yardstick (``torch.einsum`` on
    the rescaled blocks)."""
    t0 = time.perf_counter()
    dev = inputs.noisy.device
    n_px = HEIGHT * WIDTH
    errs = dict.fromkeys("IJK", 0.0)
    ms, dev_ms, bounds = {}, {}, {}
    st0, _ = bt.denoise_frame(exact, bt.zero_state(exact, dev),
                              frame_of(inputs, 0), cams[0], offs[0], 0)
    cur = frame_of(inputs, 1)
    pp = reproject_coords(exact, cur.positions, cams[0], offs[1])
    pfx, pfy = pp

    # ---- I ----
    rng = np.random.default_rng(14)
    rs = torch.from_numpy(rng.standard_normal((15, HEIGHT, WIDTH)).astype(
        np.float32)).to(dev)
    flat = rs.view(-1)
    flat[::331], flat[7::503], flat[11::709] = (
        float("nan"), float("inf"), -float("inf"))
    rstate = bt.TemporalState(
        positions=rs[0:3], normals=rs[3:6], noisy=rs[6:9],
        spp=torch.from_numpy(rng.integers(0, 256, (HEIGHT, WIDTH)).astype(
            np.uint8)).to(dev), out=rs[9:12], result=rs[12:15])
    for mode in TAP_MODES:
        cases = [("orbit", st0, pfx, pfy), ("field, random state", rstate,
                                              field[0], field[1])]
        for label, st, fx, fy in cases:
            args = (exact.replace(warp_mode=mode), st, cur.positions,
                    cur.normals, fx, fy, mode)
            errs["I"] = max(errs["I"], check_bits(
                "warp_blend_planes", f"{mode} {label}",
                warp_blend_planes(*args), warp_blend_planes_reference(*args)))
    args_i = (exact, st0, cur.positions, cur.normals, pfx, pfy, "float32")
    ms["I"] = (cuda_ms(lambda: warp_blend_planes(*args_i), 50),
               cuda_ms(lambda: warp_blend_planes_reference(*args_i), 10))
    dev_ms["I"] = kernel_device_ms(lambda: warp_blend_planes(*args_i),
                                   "warp_taps_kernel")
    for mode in ("packed_bf16", "packed_x_bf16"):
        args_m = args_i[:-1] + (mode,)
        dev_ms[f"I {mode}"] = kernel_device_ms(
            lambda: warp_blend_planes(*args_m), "warp_taps_kernel")
    # in: the 16 state channels (15 f32 and the u8 spp), positions,
    # normals, pfx, pfy; out: 13 planes; ~200 operations per pixel
    bounds["I"] = bound(nbytes(*st0, cur.positions, cur.normals, pfx, pfy)
                        + 13 * 4 * n_px, 200 * n_px)

    # ---- J ----
    planes = warp_blend_planes(*args_i)
    accum = noisy_tail(exact, cur.noisy, pp, planes, cur.positions,
                       cur.normals, 1)["accum"]
    geo = (cur.normals, cur.positions, accum)
    for dtype in STORAGE_DTYPES:
        jcfg = exact.replace(tmp_data_dtype=dtype)
        for f in (1, 6, 12):
            errs["J"] = max(errs["J"], check_bits(
                "build_feature_blocks", f"{dtype} frame {f}",
                build_feature_blocks(jcfg, *geo, f),
                build_feature_blocks_reference(jcfg, *geo, f)))
        if dtype != "float32":
            dev_ms[f"J {dtype}"] = kernel_device_ms(
                lambda: build_feature_blocks(jcfg, *geo, 1),
                "feature_blocks_kernel")
    ms["J"] = (cuda_ms(lambda: build_feature_blocks(exact, *geo, 1), 50),
               cuda_ms(lambda: build_feature_blocks_reference(exact, *geo, 1),
                       10))
    dev_ms["J"] = kernel_device_ms(lambda: build_feature_blocks(
        exact, *geo, 1), "feature_blocks_kernel")
    tmp = build_feature_blocks(exact, *geo, 1)
    # in: the 9 raw planes; out: tmp; ~4 operations per stored value
    bounds["J"] = bound(nbytes(*geo, tmp), 4 * tmp.numel())

    # ---- K ----
    w, mm = fit_blocks_pallas(exact, tmp, 1)
    pos_nan = cur.positions.clone()
    pos_nan[0, HEIGHT // 2, WIDTH // 3:WIDTH // 3 + 60] = float("nan")
    pos_nan[2, 10:40, 7] = float("nan")
    geo_nan = (cur.normals, pos_nan, accum)
    f16 = exact.replace(tmp_data_dtype="float16")
    for label, kcfg, g, blocks in (
            ("f32 tmp, its blocks reused", exact, geo, tmp),
            ("f32 tmp, NaN positions", exact, geo_nan,
             build_feature_blocks(exact, *geo_nan, 1)),
            ("f16 tmp, NaN positions (raw features)", f16, geo_nan,
             build_feature_blocks(f16, *geo_nan, 1))):
        errs["K"] = max(errs["K"], check_reconstruction(
            label, kcfg, w, mm, g, 1, blocks))
    # every jitter frame: the tiles' windows and their blocks move with it
    for f in range(16):
        errs["K"] = max(errs["K"], check_reconstruction(
            f"f32 tmp, NaN positions, frame {f}", exact, w, mm, geo_nan, f,
            build_feature_blocks(exact, *geo_nan, f)))
    # the table's instance: any other basis, its weights fitted by D
    for name, fn in CROSS_FEATURES.items():
        bt.register_feature(name, fn)
    for bname in ("first_order", "16 columns"):
        for dtype in ("float32", "float16"):
            bcfg = exact.replace(tmp_data_dtype=dtype, **BASES[bname])
            require(not reconstruct_geometry(bcfg).default_basis,
                    f"weighted_sum {bname}: the register instance")
            bw, bmm = fit_blocks_pallas(
                bcfg, build_feature_blocks(bcfg, *geo_nan, 1), 1)
            for f in (0, 5, 10, 15):
                errs["K"] = max(errs["K"], check_reconstruction(
                    f"{bname}, {dtype} tmp, NaN positions, frame {f}", bcfg,
                    bw, bmm, geo_nan, f,
                    build_feature_blocks(bcfg, *geo_nan, f)))
    args_k = (exact, w, mm, *geo, 1)
    ms["K"] = (cuda_ms(lambda: weighted_sum(*args_k, feature_blocks=tmp),
                       50),
               cuda_ms(lambda: weighted_sum_reference(
                   *args_k, feature_blocks=tmp), 10))
    dev_ms["K"] = kernel_device_ms(lambda: weighted_sum(
        *args_k, feature_blocks=tmp), "block_reconstruct_kernel")
    basis = block_basis(exact, mm, cur.normals, cur.positions, 1, tmp)
    with highest_precision():
        library = cuda_ms(lambda: torch.einsum("bfe,bfc->bce", basis, w), 50)
    F, lo = exact.feature_count, exact.features_not_scaled_count
    # in: the 6 geometry planes of the default basis, weights, mins/maxs;
    # out: 3 planes; per pixel 2 operations a product, 4 a rescale
    bounds["K"] = bound(nbytes(cur.normals, cur.positions, w, mm)
                        + 3 * 4 * n_px, (6 * F + 4 * (F - lo)) * n_px)
    print(f"[library] torch.einsum('bfe,bfc->bce') on kernel K's rescaled "
          f"blocks (f32, highest precision): {library:.4f} ms per call")
    print(f"[default kernels] the phase took {time.perf_counter() - t0:.1f} s")
    return errs, ms, dev_ms, bounds, library


def steady_frames(cfg, inputs, cams, offs, mode):
    """Run frame 0 eagerly; return a closure running frames 1..15 on that
    state between two CUDA events, the events and the compiled step.
    ``mode``: ``"eager"`` (``denoise_frame``), ``"plain"`` (its plain
    versions) or ``"compiled"`` (replays of a ``CompiledStep``, which its
    first run captures). A packed state is updated in place, a raw one is
    rebuilt from frame 0's each run."""
    dev = inputs.noisy.device
    plain = mode == "plain"
    st0, _ = bt.denoise_frame(cfg, bt.zero_state(cfg, dev),
                              frame_of(inputs, 0), cams[0], offs[0], 0,
                              plain=plain)
    compiled = CompiledStep(cfg) if mode == "compiled" else None
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run():
        st = st0
        start.record()
        for t in range(1, FRAMES):
            args = (st, frame_of(inputs, t), cams[t - 1], offs[t], t)
            st = (compiled.run(*args) if compiled
                  else bt.denoise_frame(cfg, *args, plain=plain))[0]
        end.record()
    return run, start, end, compiled


def steady_ms(cfg, inputs, cams, offs, mode, runs=1):
    """Mean ms per warped frame of each of ``runs`` runs after a warm-up
    run (CUDA events around the host loop), the peak memory from before
    the warm-up, the compiled step's capture seconds and the profile of
    one more run."""
    run, start, end, compiled = steady_frames(cfg, inputs, cams, offs, mode)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run()
    ms = []
    for _ in range(runs):
        run()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / (FRAMES - 1))
    peak = torch.cuda.max_memory_allocated()
    capture_s = (sum(compiled.capture_seconds.values()) if compiled
                 else None)
    return dict(ms_per_frame=ms, max_memory_allocated=peak,
                capture_s=capture_s, run=run)


def run_path(label, cfg, sc, inputs, cams, offs, counters, expected):
    """Drive ``denoise_sequence`` over the scene with every kernel count
    set to 0 just before and read just after; hold the counts to
    ``expected``, the compiled frames to the eager step bit for bit and
    the output to the plain path and the clean render; time the steady
    frames eager and compiled; kernels H, G and F are held to one launch
    a frame beside ``expected``. Returns the path's record."""
    counters, expected = with_tails(counters, expected, FRAMES)
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = bt.denoise_sequence(cfg, inputs, cams, offs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[path {label}] denoise_sequence {FRAMES} frames (first run, "
          f"frame 1 captures the compiled step): {first_s:.2f} s; "
          f"launches {launches}")
    require(launches == expected, f"{label}: launch counts {launches}, "
            f"expected {expected}")
    require(tuple(out.shape) == (FRAMES, 3, HEIGHT, WIDTH),
            f"{label}: output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), f"{label}: non-finite output")
    require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
            f"{label}: output outside [0, 1]")
    eager = eager_sequence(cfg, inputs, cams, offs)
    again = bt.denoise_sequence(cfg, inputs, cams, offs)
    same = bool(torch.equal(out, eager)) and bool(torch.equal(again, eager))
    diff = float((out - eager).abs().max())
    print(f"[path {label}] compiled frames 1-{FRAMES - 1} (capture, then a "
          f"second call of replays only) bit-equal to the eager step: "
          f"{same} (max |diff| {diff})")
    require(same, f"{label}: the compiled step differs from the eager one "
            f"by {diff}")
    del eager, again
    plain = bt.denoise_sequence(cfg, inputs, cams, offs, plain=True)
    out_np, plain_np = out.cpu().numpy(), plain.cpu().numpy()
    dbs = [psnr(out_np[t], plain_np[t]) for t in range(FRAMES)]
    path_err = float(np.abs(out_np - plain_np).max())
    print(f"[path {label}] kernels vs plain, per-frame PSNR dB: "
          + ", ".join(f"{d:.2f}" for d in dbs)
          + f"; max |err| {path_err:.3e}")
    require(min(dbs) >= PATH_MIN_DB, f"{label}: path PSNR {min(dbs):.2f} dB")
    # fidelity as bmfr_tpu/fidelity.py measures it: tone-mapped output vs
    # the tone-mapped clean render, beside the tone-mapped noisy input
    clean = tone_map(sc["clean"])
    noisy = tone_map(sc["albedo"] * sc["noisy"])
    den_db = [psnr(np.moveaxis(out_np[t], 0, -1), clean[t])
              for t in range(FRAMES)]
    noisy_db = [psnr(noisy[t], clean[t]) for t in range(FRAMES)]
    print(f"[path {label}] PSNR vs clean render, denoised: "
          + ", ".join(f"{d:.2f}" for d in den_db) + "; noisy input: "
          + ", ".join(f"{d:.2f}" for d in noisy_db))
    require(all(d > n for d, n in zip(den_db, noisy_db)),
            f"{label}: a denoised frame is further from the clean render "
            "than its noisy input")
    del out, plain

    timing = {mode: steady_ms(cfg, inputs, cams, offs, mode, runs=3)
              for mode in ("eager", "compiled")}
    plain_ms = steady_ms(cfg, inputs, cams, offs, "plain")["ms_per_frame"][0]
    for mode, rec in timing.items():
        rec["profile"] = device_breakdown(f"{label} {mode}", rec.pop("run"),
                                          FRAMES - 1)
    eager, comp = timing["eager"], timing["compiled"]
    print(f"[time {label}] {gpu_line()}: steady ms/frame (3 runs) eager "
          + ", ".join(f"{m:.4f}" for m in eager["ms_per_frame"])
          + "; compiled " + ", ".join(f"{m:.4f}" for m in
                                      comp["ms_per_frame"])
          + f"; with plain versions {plain_ms:.4f}; capture + instantiate "
          f"{comp['capture_s']:.3f} s; max_memory_allocated eager "
          f"{eager['max_memory_allocated']} B, compiled "
          f"{comp['max_memory_allocated']} B")
    return dict(launches=launches, first_run_s=first_s,
                compiled_bit_equal=same,
                path_ms_per_frame=eager["ms_per_frame"],
                compiled_ms_per_frame=comp["ms_per_frame"],
                path_plain_ms_per_frame=plain_ms,
                capture_s=comp["capture_s"],
                max_memory_allocated=eager["max_memory_allocated"],
                compiled_max_memory_allocated=comp["max_memory_allocated"],
                profile=eager["profile"], compiled_profile=comp["profile"],
                path_psnr_db=dbs, clean_psnr_db=den_db,
                noisy_clean_psnr_db=noisy_db)


def stream_phase(sc, inputs, cams, offs, flagship, exact, dev, packed_kpf):
    """The stream phase, in a temporary directory it removes: export the
    orbit scene to disk (and a second scene of the same files with a
    tight position limit), stream the flagship and the default path from
    it, resume the flagship from a checkpoint, stream both scenes at
    once, and time the streamed flagship. Returns the phase's record."""
    root = tempfile.mkdtemp(prefix="bmfr_stream_")
    try:
        return _stream_phase(root, sc, inputs, cams, offs, flagship, exact,
                             dev, packed_kpf)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _stream_phase(root, sc, inputs, cams, offs, flagship, exact, dev,
                  packed_kpf):
    rec = {}
    free = shutil.disk_usage(root).free
    raw = 4 * sc["noisy"].nbytes
    print(f"[stream] {root}: {free} B free; IO library "
          f"{native.library_path().name}")
    require(free > 3 * raw, f"stream: {free} B free for {raw} B of frames")
    t0 = time.perf_counter()
    native.build()
    rec["io_build_s"] = time.perf_counter() - t0
    scene_dir = os.path.join(root, "orbit")
    t0 = time.perf_counter()
    export_scene(sc, scene_dir, **SCENE_LIMITS)
    rec["export_s"] = time.perf_counter() - t0
    exrs = sorted(f for f in os.listdir(scene_dir) if f.endswith(".exr"))
    rec["exr_files"] = len(exrs)
    rec["exr_bytes"] = sum(os.path.getsize(os.path.join(scene_dir, f))
                           for f in exrs)
    print(f"[stream] export_scene (ZIP, a thread per core): {len(exrs)} "
          f"files, {raw} B of f32 frames, {rec['exr_bytes']} B written in "
          f"{rec['export_s']:.2f} s (native build {rec['io_build_s']:.1f} s)")
    # a second scene: the same frames, its own header, a tight limit
    tight = os.path.join(root, "orbit-tight")
    os.makedirs(tight)
    for f in exrs:
        os.symlink(os.path.join(scene_dir, f), os.path.join(tight, f))
    write_camera_header(os.path.join(tight, "camera_matrices.h"),
                        sc["camera_matrices"], sc["pixel_offsets"], 1e-8,
                        SCENE_LIMITS["normal_limit_squared"])
    scenes = discover_scenes(root)
    require([(os.path.basename(s.path), s.frame_count, s.width, s.height)
             for s in scenes] == [(n, FRAMES, WIDTH, HEIGHT) for n in
                                  ("orbit", "orbit-tight")],
            f"stream: discover_scenes found {scenes}")
    t0 = time.perf_counter()
    data = scenes[0].load_frames()
    load_s = time.perf_counter() - t0
    same = all(np.array_equal(data[k], sc[k]) for k in
               ("noisy", "normals", "positions", "albedo", "camera_matrices",
                "pixel_offsets"))
    print(f"[stream] discover_scenes: 2 scenes; load_frames of {FRAMES} "
          f"frames {load_s:.2f} s, bit-equal to the in-memory arrays: {same}")
    require(same, "stream: load_frames differs from the in-memory scene")
    del data

    # ---- flagship and default path streamed, vs denoise_sequence ----
    outs, refs = {}, {}
    for label, cfg, counters, expected in (
            ("flagship", flagship, *TEMPORAL_FLAGSHIP),
            ("default", exact,
             {"fit_blocks_pallas": fit_blocks_pallas, "warp_rows": warp_rows,
              **DEFAULT_KERNELS},
             {"fit_blocks_pallas": FRAMES, "warp_rows": 0,
              **DEFAULT_LAUNCHES})):
        counters, expected = with_tails(counters, expected, FRAMES)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        outs[label] = bt.stream_scene(cfg, scenes[0],
                                      chunk_frames=STREAM_CHUNK, device=dev)
        first_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        refs[label] = bt.denoise_sequence(cfg, inputs, cams,
                                          offs).cpu().numpy()
        equal = bool(np.array_equal(outs[label], refs[label]))
        err = float(np.abs(outs[label] - refs[label]).max())
        print(f"[stream {label}] stream_scene chunks of {STREAM_CHUNK}, "
              f"compiled chunk runner (first run {first_s:.2f} s): launches "
              f"{launches}; bit-equal to denoise_sequence: {equal} (max "
              f"|diff| {err})")
        require(launches == expected, f"stream {label}: launches {launches}, "
                f"expected {expected}")
        require(equal, f"stream {label}: differs from denoise_sequence by "
                f"{err}")
        rec[label] = dict(launches=launches, bit_equal=equal,
                          first_run_s=first_s)

    # ---- checkpoint: frames 0-7 on a TemporalState, save, load, 8-15 ----
    step = bt.make_denoise_frame(flagship)
    state = bt.TemporalState.initial(flagship, dev)
    resumed = []
    ckpt = os.path.join(root, "state.npz")
    for t in range(FRAMES):
        if t == FRAMES // 2:
            bt.save_state(ckpt, state, t)
            state, t_next = bt.load_state(ckpt)
            require(t_next == t and state.out.device.type == "cuda",
                    "checkpoint: frame or device")
        state, res = step(state, frame_of(inputs, t), cams[max(t - 1, 0)],
                          offs[t], t)
        resumed.append(res.cpu().numpy())
    equal = bool(np.array_equal(np.stack(resumed), refs["flagship"]))
    print(f"[stream checkpoint] flagship saved after frame "
          f"{FRAMES // 2 - 1} ({os.path.getsize(ckpt)} B), loaded on the "
          f"card, frames {FRAMES // 2}-{FRAMES - 1} bit-equal to the "
          f"uninterrupted run: {equal}")
    require(equal, "checkpoint: the resumed run differs")
    rec["checkpoint_bit_equal"] = equal

    # ---- both scene directories at once on the one card ----
    both = bt.stream_scenes(flagship, scenes, chunk_frames=STREAM_CHUNK,
                            devices=[dev])
    equal = bool(np.array_equal(both[0], outs["flagship"]))
    diff = float(np.abs(both[1] - both[0]).max())
    print(f"[stream scenes] stream_scenes over 2 directories, one card: "
          f"scene 1 bit-equal to stream_scene: {equal}; scene 2 "
          f"(position_limit_squared 1e-8) differs by {diff:.4f}")
    require(equal and diff > 1e-3, "stream_scenes: per-scene results")
    rec["scenes"] = dict(first_bit_equal=equal, second_max_diff=diff)

    # ---- timing (the runs above were the warm pass) ----
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    bt.stream_scene(flagship, scenes[0], chunk_frames=STREAM_CHUNK,
                    device=dev, timings=timings)
    wall_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    ingest, compute = timings["ingest_s"], timings["compute_ms"]
    decode = timings["decode_s"]
    serial_s, overlap_s = sum(ingest) + sum(compute) / 1e3, max(
        sum(ingest), sum(compute) / 1e3)
    hidden = abs(wall_s - overlap_s) < abs(wall_s - serial_s)
    steady = steady_ms(flagship, inputs, cams, offs,
                       "compiled")["ms_per_frame"][0]
    st0, _ = bt.denoise_frame(flagship, bt.TemporalState.initial(flagship,
                                                                 dev),
                              frame_of(inputs, 0), cams[0], offs[0], 0)

    def temporal_run():
        st = st0
        for t in range(1, FRAMES):
            st, _ = bt.denoise_frame(flagship, st, frame_of(inputs, t),
                                     cams[t - 1], offs[t], t)

    profile = device_breakdown("flagship TemporalState carry", temporal_run,
                               FRAMES - 1)
    kpf = (profile or {}).get("kernels_per_frame")
    print(f"[stream time] {gpu_line()}: flagship stream_scene {FRAMES} "
          f"frames in chunks "
          f"of {STREAM_CHUNK}: wall {wall_s * 1e3 / FRAMES:.4f} ms/frame; "
          f"loader s/chunk " + ", ".join(f"{s:.4f}" for s in ingest)
          + " (decode " + ", ".join(f"{s:.4f}" for s in decode) + ")"
          + "; compute ms/chunk " + ", ".join(f"{m:.4f}" for m in compute)
          + f"; ingest {sum(ingest):.4f} s + compute "
          f"{sum(compute) / 1e3:.4f} s = {serial_s:.4f} s, max "
          f"{overlap_s:.4f} s, wall {wall_s:.4f} s: closer to the "
          + ("max (ingest overlapped)" if hidden else "sum (serial)")
          + f"; in-memory compiled steady {steady:.4f} ms/frame; eager "
          f"device kernels per frame {kpf} on the TemporalState carry vs "
          f"{packed_kpf} packed; "
          f"max_memory_allocated {peak} B")
    rec["timing"] = dict(
        wall_ms_per_frame=wall_s * 1e3 / FRAMES, ingest_s_per_chunk=ingest,
        decode_s_per_chunk=decode,
        compute_ms_per_chunk=compute, chunk_frames=STREAM_CHUNK,
        wall_s=wall_s, ingest_plus_compute_s=serial_s,
        max_ingest_compute_s=overlap_s, ingest_hidden=hidden,
        in_memory_compiled_ms_per_frame=steady,
        temporal_carry_kernels_per_frame=kpf,
        packed_carry_kernels_per_frame=packed_kpf,
        max_memory_allocated=peak, load_frames_s=load_s)
    return rec


def staging_phase(sc, flagship, exact, dev, zip_timing):
    """The [staging] phase, in a temporary directory it removes: stage the
    orbit scene with the EXR codec cycled per file, load it back bit for
    bit, stream the flagship and the default path from it, run the CLI on
    it to PNGs and time the decode of each codec. Returns its record."""
    root = tempfile.mkdtemp(prefix="bmfr_staging_")
    try:
        return _staging_phase(root, sc, flagship, exact, dev, zip_timing)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _staging_phase(root, sc, flagship, exact, dev, zip_timing):
    rec = {}
    zip_load_s = zip_timing["load_frames_s"]
    native.build()
    require(native.library_path().exists(),
            f"staging: no native IO library at {native.library_path()}")
    free = shutil.disk_usage(root).free
    require(free > 8 * sc["noisy"].nbytes,
            f"staging: {free} B free in {root}")
    series = dict(color="noisy", shading_normal="normals",
                  world_position="positions", albedo="albedo")

    # ---- one 1280x720 file at a time per codec, then the whole scene ----
    one = {k: sc[k][:1] for k in (*series.values(), "camera_matrices",
                                  "pixel_offsets")}
    write_s = {}
    for codec in STAGE_CODECS:
        t0 = time.perf_counter()
        stage_scene(os.path.join(root, "one", codec), one, codecs=(codec,),
                    threads=1)
        write_s[codec] = (time.perf_counter() - t0) / len(series)
    shutil.rmtree(os.path.join(root, "one"))
    print(f"[staging] {gpu_line()}: write s per {WIDTH}x{HEIGHT} f32 file, "
          "one thread (B44 with its read-back): " + ", ".join(
              f"{c} {s:.4f}" for c, s in write_s.items()))
    scene_dir = os.path.join(root, "scenes", "orbit")
    t0 = time.perf_counter()
    expected = stage_scene(scene_dir, sc)
    stage_s = time.perf_counter() - t0
    exrs = sorted(f for f in os.listdir(scene_dir) if f.endswith(".exr"))
    codec_of = {f"{buf}{t}.exr": STAGE_CODECS[(i * FRAMES + t)
                                              % len(STAGE_CODECS)]
                for i, buf in enumerate(series) for t in range(FRAMES)}
    per_codec = {c: sorted(f for f, k in codec_of.items() if k == c)
                 for c in STAGE_CODECS}
    file_bytes = {c: [os.path.getsize(os.path.join(scene_dir, f))
                      for f in fs] for c, fs in per_codec.items()}
    print(f"[staging] stage_scene {WIDTH}x{HEIGHT}x{FRAMES}: {len(exrs)} "
          f"files ({len(codec_of)} series files: " + ", ".join(
              f"{c} {len(fs)}" for c, fs in per_codec.items())
          + f"; {FRAMES} ZIP references) in {stage_s:.2f} s on "
          f"{os.cpu_count()} threads")
    rec.update(write_s_per_file=write_s, stage_s=stage_s,
               files_per_codec={c: len(fs) for c, fs in per_codec.items()},
               mean_bytes_per_file={c: float(np.mean(b))
                                    for c, b in file_bytes.items()})

    # ---- discover, load, bit-equal to what staging returned ----
    scenes = discover_scenes(os.path.dirname(scene_dir))
    require([(os.path.basename(s.path), s.frame_count, s.width, s.height)
             for s in scenes] == [("orbit", FRAMES, WIDTH, HEIGHT)],
            f"staging: discover_scenes found {scenes}")
    t0 = time.perf_counter()
    data = scenes[0].load_frames()
    load_s = time.perf_counter() - t0
    same = all(np.array_equal(data[key].view(np.uint32),
                              expected[buf].view(np.uint32))
               for buf, key in series.items()) and all(
        np.array_equal(data[k], sc[k]) for k in ("camera_matrices",
                                                 "pixel_offsets"))
    print(f"[staging] load_frames of {FRAMES} frames (every codec) "
          f"{load_s:.2f} s vs {zip_load_s:.2f} s for the [stream] phase's "
          f"ZIP scene; bit-equal to stage_scene's expected arrays: {same}")
    require(same, "staging: load_frames differs from the expected arrays")
    rec.update(load_frames_s=load_s, zip_load_frames_s=zip_load_s)
    del data
    inputs = bt.frame_inputs_from_numpy(
        expected["shading_normal"], expected["world_position"],
        expected["color"], expected["albedo"], dev)
    cams = torch.from_numpy(sc["camera_matrices"]).to(dev)
    offs = torch.from_numpy(sc["pixel_offsets"]).to(dev)

    # ---- the flagship and the default path streamed from the staged
    # scene, vs denoise_sequence on the expected arrays in memory ----
    for label, cfg, counters, want in (
            ("flagship", flagship, *TEMPORAL_FLAGSHIP),
            ("default", exact,
             {"fit_blocks_pallas": fit_blocks_pallas, "warp_rows": warp_rows,
              **DEFAULT_KERNELS},
             {"fit_blocks_pallas": FRAMES, "warp_rows": 0,
              **DEFAULT_LAUNCHES})):
        counters, want = with_tails(counters, want, FRAMES)
        for fn in counters.values():
            fn.launches = 0
        t0 = time.perf_counter()
        got = bt.stream_scene(cfg, scenes[0], chunk_frames=STREAM_CHUNK,
                              device=dev)
        run_s = time.perf_counter() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
        ref = bt.denoise_sequence(cfg, inputs, cams, offs).cpu().numpy()
        equal = bool(np.array_equal(got, ref))
        err = float(np.abs(got - ref).max())
        print(f"[staging {label}] stream_scene of the staged scene, chunks "
              f"of {STREAM_CHUNK} ({run_s:.2f} s): launches {launches}; "
              f"bit-equal to denoise_sequence on the expected arrays: "
              f"{equal} (max |diff| {err})")
        require(launches == want, f"staging {label}: launches {launches}, "
                f"expected {want}")
        require(equal, f"staging {label}: differs from denoise_sequence by "
                f"{err}")
        rec[label] = dict(launches=launches, bit_equal=equal, run_s=run_s)
    timings = {}
    t0 = time.perf_counter()
    bt.stream_scene(flagship, scenes[0], chunk_frames=STREAM_CHUNK,
                    device=dev, timings=timings)
    wall_ms = (time.perf_counter() - t0) * 1e3 / FRAMES
    print(f"[staging time] {gpu_line()}: flagship stream_scene of the "
          f"staged scene (every codec): wall {wall_ms:.4f} ms/frame, decode "
          f"s/chunk " + ", ".join(f"{d:.4f}" for d in timings["decode_s"])
          + f"; the [stream] phase's ZIP scene: wall "
          f"{zip_timing['wall_ms_per_frame']:.4f} ms/frame, decode s/chunk "
          + ", ".join(f"{d:.4f}" for d in zip_timing["decode_s_per_chunk"]))
    rec["timing"] = dict(wall_ms_per_frame=wall_ms,
                         decode_s_per_chunk=timings["decode_s"],
                         ingest_s_per_chunk=timings["ingest_s"])

    # ---- the CLI on the staged scene, its PNGs through both readers ----
    out_dir = os.path.join(root, "pngs")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "bmfr_tpu_torch.cli", "--scene", scene_dir,
         "--device", "0", "--output", out_dir], capture_output=True,
        text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    cli_s = time.perf_counter() - t0
    require(proc.returncode == 0, f"staging: the CLI exited "
            f"{proc.returncode}:\n{proc.stdout[-2000:]}{proc.stderr[-2000:]}")
    cam = scenes[0].load_camera()
    cli_cfg = exact.replace(
        position_limit_squared=cam["position_limit_squared"],
        normal_limit_squared=cam["normal_limit_squared"])
    res = bt.denoise_sequence(cli_cfg, inputs, cams, offs).cpu().numpy()
    want = (np.clip(np.moveaxis(res, 1, -1), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8) / np.float32(255.0)
    pngs = sorted(os.listdir(out_dir))
    require(pngs == sorted(f"output{t}.png" for t in range(FRAMES)),
            f"staging: the CLI wrote {pngs}")
    readers_equal = quantised_equal = True
    py_s = 0.0
    for t in range(FRAMES):
        path = os.path.join(out_dir, f"output{t}.png")
        a = png.read_png_rgb01(path)
        t0 = time.perf_counter()
        b = png.read_png_rgb01_py(path)
        py_s += time.perf_counter() - t0
        readers_equal &= bool(np.array_equal(a.view(np.uint32),
                                             b.view(np.uint32)))
        quantised_equal &= bool(np.array_equal(a, want[t]))
    print(f"[staging cli] python -m bmfr_tpu_torch.cli --scene <staged> "
          f"--device 0: {cli_s:.2f} s, {len(pngs)} PNGs; native and Python "
          f"PNG readers equal: {readers_equal} (Python reader "
          f"{py_s / FRAMES:.4f} s per PNG); equal to the in-memory default "
          f"path quantised as io/exr.py::write_png: {quantised_equal}; "
          + " ".join(line.strip() for line in proc.stdout.splitlines()
                     if "Full frame" in line))
    require(readers_equal, "staging: the PNG readers disagree")
    require(quantised_equal, "staging: the CLI's PNGs differ from the "
            "in-memory run")
    rec["cli"] = dict(s=cli_s, readers_equal=readers_equal,
                      quantised_equal=quantised_equal,
                      py_png_s=py_s / FRAMES)

    # ---- decode by codec: color<k>.exr, k = 0..4, holds codec k ----
    decode = {}
    print(f"[staging decode] {gpu_line()}")
    for k, codec in enumerate(STAGE_CODECS):
        path = os.path.join(scene_dir, f"color{k}.exr")
        times = []
        for _ in range(5):
            t0 = time.perf_counter()
            native.read_exr(path)
            times.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        py = exr_py.read_exr_py(path)
        py_s = time.perf_counter() - t0
        require(np.array_equal(py.view(np.uint32),
                               expected["color"][k].view(np.uint32)),
                f"staging: read_exr_py differs on {codec}")
        decode[codec] = dict(native_s=float(np.median(times)),
                             bytes=os.path.getsize(path), read_exr_py_s=py_s)
        print(f"[staging decode] {codec}: native read_exr "
              f"{decode[codec]['native_s']:.4f} s per {WIDTH}x{HEIGHT} file "
              f"(median of 5), {decode[codec]['bytes']} B on disk (mean "
              f"{rec['mean_bytes_per_file'][codec]:.0f} B over its "
              f"{len(per_codec[codec])} files; raw f32 "
              f"{sc['noisy'][0].nbytes} B); read_exr_py {py_s:.3f} s")
    rec["decode"] = decode
    return rec


def sweep_counters():
    """The launch counters of the kernels the sweep's configurations
    reach, by letter."""
    return {"A": warp_blend, "B": fit_reconstruct_cholesky,
            "C": fit_reconstruct_direct, "D": fit_blocks_pallas,
            "E": warp_rows, "F": filtered_tail, "G": noisy_tail,
            "H": reproject_coords, "I": warp_blend_planes,
            "J": build_feature_blocks, "K": weighted_sum}


def counted_sweep(label, scenes, base, dev):
    """``run_sweep`` over ``scenes`` on the card with every count set to
    0 just before and read just after, held to what ``SWEEP_KERNELS``
    says each configuration launches. Returns (rows, launches)."""
    counters = sweep_counters()
    for fn in counters.values():
        fn.launches = 0
    t0 = time.perf_counter()
    rows = run_sweep(scenes, base, device=dev)
    torch.cuda.synchronize()
    sweep_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    expected = dict.fromkeys(counters, 0)
    for sc in scenes.values():
        T = sc["noisy"].shape[0]
        for kernels in SWEEP_KERNELS.values():
            for k in kernels + "FGH":
                expected[k] += T - 1 if k in "AI" else T
    print(f"[{label}] run_sweep {len(rows)} rows on the card: {sweep_s:.1f} s"
          f"; launches {launches}")
    require(len(rows) == len(scenes) * len(SWEEP_KERNELS),
            f"{label}: {len(rows)} rows")
    require(launches == expected, f"{label}: launch counts {launches}, "
            f"expected {expected}")
    return rows, launches


def fidelity_r5_phase(dev):
    """``run_sweep`` over the four synthetic scenes at FIDELITY_r5.json's
    size, row by row against that record of the JAX package."""
    with open(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "FIDELITY_r5.json")) as f:
        record = json.load(f)
    meta = record["meta"]
    W, H, T = meta["width"], meta["height"], meta["frames"]
    t0 = time.perf_counter()
    scenes = synthetic_scenes(W, H, T)
    render_s = time.perf_counter() - t0
    base = bt.BMFRConfig(image_width=W, image_height=H, **SCENE_LIMITS)
    rows, launches = counted_sweep("fidelity r5", scenes, base, dev)
    want = {(r["scene"], r["config"]): r for r in record["rows"]}
    require(sorted(want) == sorted((r["scene"], r["config"]) for r in rows),
            "fidelity r5: the rows differ from FIDELITY_r5.json's")
    gaps, bad = {}, []
    for r in rows:
        w = want[(r["scene"], r["config"])]
        tol_db, tol_ssim = R5_TOL.get(r["config"], R5_TOL_DEFAULT)
        g = gaps.setdefault(r["config"], dict.fromkeys(
            ("noisy_psnr", "psnr_mean", "psnr_first", "psnr_last",
             "ssim_mean"), 0.0))
        for key, tol in (("noisy_psnr", R5_NOISY_TOL), ("psnr_mean", tol_db),
                         ("psnr_first", tol_db), ("psnr_last", tol_db),
                         ("ssim_mean", tol_ssim)):
            gap = abs(r[key] - w[key])
            g[key] = max(g[key], gap)
            if not gap <= tol:
                bad.append(f"{r['scene']} {r['config']} {key}: {r[key]} vs "
                           f"{w[key]} (tolerance {tol:g})")
    print(f"[fidelity r5] {gpu_line()}: {W}x{H}x{T}, aa_samples 8, render "
          f"{render_s:.1f} s; largest |gap| to FIDELITY_r5.json per config:")
    for cname, g in gaps.items():
        print(f"[fidelity r5]   {cname:<18}" + "  ".join(
            f"{k} {v:.3e}" for k, v in g.items()))
    for b in bad:
        print(f"[fidelity r5] OFF: {b}")
    require(not bad, f"fidelity r5: {len(bad)} values off tolerance")
    return dict(rows=rows, largest_gap=gaps, launches=launches,
                render_s=render_s)


def fidelity_fullres_phase(dev):
    """Corridor and swing at 1280x720, 4 frames, all 11 configurations:
    every row closer to the clean render than its noisy input, and the
    flagships within ``FLAGSHIP_GAP_DB`` of the default path."""
    T = 4
    t0 = time.perf_counter()
    scenes = {name: synthetic_sequence(width=WIDTH, height=HEIGHT, frames=T,
                                       seed=seed, aa_samples=2, scene=name)
              for seed, name in ((3, "corridor"), (5, "swing"))}
    render_s = time.perf_counter() - t0
    base = bt.BMFRConfig(image_width=WIDTH, image_height=HEIGHT,
                         **SCENE_LIMITS)
    rows, launches = counted_sweep("fidelity 1280x720", scenes, base, dev)
    print(f"[fidelity 1280x720] {gpu_line()}: {WIDTH}x{HEIGHT}x{T}, "
          f"aa_samples 2, render {render_s:.1f} s")
    print_report(rows)
    by = {(r["scene"], r["config"]): r for r in rows}
    for r in rows:
        require(r["psnr_mean"] > r["noisy_psnr"],
                f"fidelity 1280x720 {r['scene']} {r['config']}: "
                f"{r['psnr_mean']:.4f} dB, noisy {r['noisy_psnr']:.4f} dB")
    gaps = {}
    for sname in scenes:
        for cname in ("flagship", "flagship_cholesky"):
            gap = (by[(sname, cname)]["psnr_mean"]
                   - by[(sname, "default")]["psnr_mean"])
            gaps[f"{sname} {cname}"] = gap
            print(f"[fidelity 1280x720] {sname} {cname} - default: "
                  f"{gap:+.6f} dB")
            require(abs(gap) <= FLAGSHIP_GAP_DB, f"fidelity 1280x720 "
                    f"{sname} {cname}: {gap:+.4f} dB from default")
    return dict(rows=rows, flagship_gap_db=gaps, launches=launches,
                render_s=render_s)


def oracle_phase(dev):
    """The default path and the flagship on the card against the port's
    copy of the vectorized NumPy oracle, on orbit, corridor and swing
    (``bmfr_tpu_torch/parity.py``'s tolerances). The control, the oracle
    on a state truncated to bf16 in place of rounded, must miss the
    flagship's per-frame floor of equal accept bits on some scene."""
    cfg = bt.BMFRConfig(image_width=ORACLE_W, image_height=ORACLE_H,
                        **SCENE_LIMITS)
    counters = sweep_counters()
    rec, control = {}, {}
    for name in ("orbit", "corridor", "swing"):
        sc = synthetic_sequence(width=ORACLE_W, height=ORACLE_H,
                                frames=ORACLE_T, scene=name)
        t0 = time.perf_counter()
        oracle = parity.oracle_frames(cfg, sc)
        oracle_bf16 = parity.oracle_frames(cfg, sc,
                                           round_state=parity.bf16_round)
        oracle_s = time.perf_counter() - t0
        for label, pcfg, expected in (
                ("default", cfg, dict(D=ORACLE_T, F=ORACLE_T, G=ORACLE_T,
                                      H=ORACLE_T, I=ORACLE_T - 1,
                                      J=ORACLE_T, K=ORACLE_T)),
                ("flagship", cfg.replace(**bt.FLAGSHIP),
                 dict(A=ORACLE_T - 1, B=ORACLE_T, F=ORACLE_T, G=ORACLE_T,
                      H=ORACLE_T))):
            for fn in counters.values():
                fn.launches = 0
            port = parity.port_frames(pcfg, sc, dev)
            launches = {k: fn.launches for k, fn in counters.items()
                        if fn.launches}
            recs = [parity.compare(p, o) for p, o in zip(port, oracle)]
            if label == "default":
                faults = [f"frame {t}: {f}" for t, r in enumerate(recs)
                          for f in parity.default_faults(r)]
                bf16 = None
            else:
                bf16 = [parity.compare(p, o)
                        for p, o in zip(port, oracle_bf16)]
                faults = parity.flagship_faults(recs, bf16)
            cols = [("dB per frame", [f"{r['psnr_db']:.2f}" for r in recs]),
                    ("max |diff|", [f"{r['max_abs']:.2e}" for r in recs]),
                    ("accept bits equal", [f"{100 * r['accept_share']:.2f}%"
                                           for r in recs])]
            if bf16 is None:
                cols.append(("values off tolerance (weights/filtered/"
                             "result)", [f"{r['off_weights']}/"
                                         f"{r['off_filtered']}/"
                                         f"{r['off_result']}" for r in recs]))
            else:
                cols.append(("accept bits equal to the bf16-state oracle's",
                             [f"{100 * r['accept_share']:.2f}%"
                              for r in bf16]))
            print(f"[oracle] {name} {label} {ORACLE_W}x{ORACLE_H}x{ORACLE_T} "
                  f"(oracle {oracle_s:.1f} s), launches {launches}: "
                  + "; ".join(f"{k} {', '.join(v)}" for k, v in cols))
            require(launches == expected, f"oracle {name} {label}: launches "
                    f"{launches}, expected {expected}")
            require(not faults, f"oracle {name} {label}: {faults}")
            rec[f"{name} {label}"] = dict(frames=recs, bf16_state=bf16,
                                          launches=launches)
        trunc = parity.oracle_frames(cfg, sc, round_state=parity.bf16_truncate)
        control[name] = [parity.compare(c, o)["accept_share"]
                         for c, o in zip(trunc, oracle)]
        print(f"[oracle] {name} control (state truncated to bf16): accept "
              "bits equal " + ", ".join(f"{100 * a:.2f}%"
                                        for a in control[name]))
    require(any(min(c) < parity.FLAGSHIP_ACCEPT_SHARE
                for c in control.values()),
            f"oracle: the flagship's floor of "
            f"{parity.FLAGSHIP_ACCEPT_SHARE:.0%} equal accept bits rejects "
            f"no control run: {control}")
    rec["control"] = control
    return rec


#: [basis B] / [basis C]: the bases held against the plain versions (4, 7,
#: 10 and 16 columns); the 16-column one adds three cross terms that the
#: smoke registers, as a user would (``register_feature``)
CROSS_FEATURES = {
    "smoke_position_xy": lambda n, p: p[0] * p[1],
    "smoke_position_yz": lambda n, p: p[1] * p[2],
    "smoke_normal_xz": lambda n, p: n[0] * n[2],
}
BASES = {
    "4 columns": dict(features_not_scaled=("const",), features_scaled=()),
    "7 columns": dict(features_not_scaled=("const", "normal_x", "normal_y",
                                           "normal_z"), features_scaled=()),
    "first_order": dict(features_scaled=(
        "world_position_x", "world_position_y", "world_position_z")),
    "16 columns": dict(features_scaled=(
        "world_position_x", "world_position_y", "world_position_z",
        "world_position_x2", "world_position_y2", "world_position_z2",
        *CROSS_FEATURES)),
}
#: [basis B]: PSNR at and above this is the f32 rounding of values near 1:
#: two answers there are equally exact
EXACT_DB = 140.0
#: [scenes]: the scene counts per card and the mesh that repeats the card
SCENE_COUNTS = (1, 2, 4)
#: [dryrun]: the mesh that repeats the card
DRYRUN_PLACES = 4


def basis_bound(cfg, kernel, in_planes=None):
    """(ms, what bounds it) of a basis kernel: ``in_planes`` f32 planes in
    (by default the accumulated colour, the raw planes its features read
    and the extra planes of ``basis_plan``),
    the image and the weights out; per view cell the store, rescale and
    noise of each column (~10 operations) and B's Gram sums (2 a sum) or
    C's reflections; per image pixel 6 F of the reconstruction."""
    F, NB = cfg.feature_count, cfg.buffer_count
    H, W = cfg.image_height, cfg.image_width
    if in_planes is None:
        plan = basis_plan(cfg)
        in_planes = 3 + len(plan.geometry) + len(plan.planes)
    cells = cfg.n_blocks * cfg.block_pixels
    moved = 4 * (in_planes * H * W + 3 * H * W + cfg.n_blocks * F * 3)
    if kernel == "B":
        sums = F * NB - F * (F - 1) // 2
        ops = (10 * NB + 2 * sums) * cells
    else:
        ops = qr_flops(cfg.n_blocks, cfg.block_pixels, NB) + 10 * NB * cells
    return bound(moved, ops + 6 * F * H * W)


def check_basis_b(cfg, cur, accum, frame):
    """Kernel B on a basis against its plain version. f32: every value
    within FIT_TOL; f16/bf16 tmp: as tests/test_torch_gpu.py holds B on
    reduced precision, against the exact answer (the plain version with
    its Gram sums in f64 on the same rounded data) on all but 0.1 % of
    the values and no less accurate than the plain version (3 dB; both
    PSNRs capped at EXACT_DB).
    Returns (max |err| from plain, off-tolerance values)."""
    from bmfr_tpu_torch.ops import fitter as fitter_mod

    args = (cfg, cur.normals, cur.positions, accum, frame)
    got, w = fit_reconstruct_cholesky(*args)
    ref, wr = fit_reconstruct_cholesky_reference(*args)
    torch.cuda.synchronize()
    bad = off_tolerance(got, ref, FIT_TOL)
    err = float((got - ref).abs().max())
    zero = int((w == 0).all(dim=(1, 2)).sum())
    zero_ref = int((wr == 0).all(dim=(1, 2)).sum())
    line = (f"max |err| {err:.3e}, off-tolerance values {bad} of "
            f"{got.numel()}, zero-weight blocks {zero} (plain {zero_ref})")
    if cfg.tmp_data_dtype != "float32":
        gram = fitter_mod.gram
        fitter_mod.gram = lambda data, F: gram(data.double(), F).float()
        try:
            exact, _ = fit_reconstruct_cholesky_reference(*args)
        finally:
            fitter_mod.gram = gram
        off = float((got - exact).abs().gt(FIT_TOL + FIT_TOL * exact.abs())
                    .float().mean())
        db_got = psnr(got.cpu().numpy(), exact.cpu().numpy())
        db_ref = psnr(ref.cpu().numpy(), exact.cpu().numpy())
        line += (f"; vs the f64-sum answer: off {100 * off:.4f} %, "
                 f"{db_got:.2f} dB (plain {db_ref:.2f} dB)")
        ok = (off <= 1e-3 and zero == zero_ref
              and min(db_got, EXACT_DB) >= min(db_ref, EXACT_DB) - 3.0)
    else:
        ok = bad == 0 and zero == zero_ref
    print(f"[basis B] {line}")
    require(ok, f"basis B {cfg.all_features} {cfg.tmp_data_dtype}: {line}")
    require(bool(torch.isfinite(got).all()), "basis B: non-finite")
    return err, bad


def check_basis_c(cfg, cur, accum, frame):
    """Kernel C on a basis against its plain version, both entries: the
    reconstruction within FIT_TOL and the mins/maxs to MM_TOL; the
    weights to WEIGHT_TOL on f32 tmp (``check_weights``). On f16/bf16 tmp
    the storage rounding after every reflection makes single weights of
    ill-conditioned blocks move with the summation order alone (PERF.md,
    PR 2), so there the weights are held, as B's rule holds its
    reconstruction, to be no less exact than the plain version's: their
    relative distance from the f64 least-squares weights of the same
    stored system at most sqrt(2) (3 dB) times the plain version's.
    Returns (max |err| of the reconstruction, off-tolerance values)."""
    planes = (cur.normals, cur.positions, accum)
    got, _ = fit_reconstruct_direct(cfg, *planes, frame)
    ref, _ = fit_reconstruct_direct_reference(cfg, *planes, frame)
    w, mm = fit_blocks_direct(cfg, *planes, frame)
    wr, mmr = fit_blocks_direct_reference(cfg, *planes, frame)
    torch.cuda.synchronize()
    bad = off_tolerance(got, ref, FIT_TOL)
    err = float((got - ref).abs().max())
    print(f"[basis C] reconstruction max |err| {err:.3e}, off-tolerance "
          f"values {bad} of {got.numel()}")
    require(bad == 0, f"basis C {cfg.all_features} {cfg.tmp_data_dtype}: "
            f"{bad} values off tolerance")
    require(bool(torch.isfinite(got).all()), "basis C: non-finite")
    dtype = cfg.tmp_data_dtype
    if dtype == "float32":
        check_weights("basis C", "blocks entry", w, mm, wr, mmr, dtype)
        return err, bad
    bad_mm = off_tolerance(mm, mmr, MM_TOL)
    A, b = stored_system(cfg, build_feature_blocks(cfg, *planes, frame),
                         frame)
    exact = torch.linalg.lstsq(A.double(), b.double()).solution
    d_got = float((w.double() - exact).norm() / exact.norm())
    d_ref = float((wr.double() - exact).norm() / exact.norm())
    rel = float((w - wr).norm() / wr.norm())
    print(f"[basis C] blocks entry: weights' relative norm from plain "
          f"{rel:.3e}; from the f64 least-squares weights {d_got:.3e} "
          f"(plain {d_ref:.3e}); mins/maxs off {bad_mm}")
    require(bad_mm == 0, f"basis C {dtype}: {bad_mm} mins/maxs off")
    require(d_got <= 2 ** 0.5 * d_ref, f"basis C {cfg.all_features} "
            f"{dtype}: weights {d_got:.3e} from exact, plain {d_ref:.3e}")
    require(bool(torch.isfinite(w).all()), "basis C: non-finite weights")
    return err, bad


def basis_phase(flagship, cur, frame):
    """``[basis B]`` and ``[basis C]``: kernels B and C on every basis of
    BASES and every tmp dtype against their plain versions at 1280x720,
    with each kernel's device ms per call, its bound over the planes it
    reads (beside it once, on f32, the bound over the F + 3 planes that
    the earlier front read), the default-basis kernel's device ms in the
    same call and, for C, ``torch.linalg.lstsq`` on the same stored system
    at each column count; then ``[basis override]``."""
    for name, fn in CROSS_FEATURES.items():
        bt.register_feature(name, fn)
    accum = cur.noisy
    planes = (cur.normals, cur.positions, accum)
    rec = {}
    for kernel, solver, kname, default_name in (
            ("B", "cholesky", "fit_chol_basis_kernel", "fit_chol_kernel"),
            ("C", "householder", "fit_direct_basis_kernel",
             "fit_direct_kernel")):
        fit = (fit_reconstruct_cholesky if kernel == "B"
               else fit_reconstruct_direct)
        plain = (fit_reconstruct_cholesky_reference if kernel == "B"
                 else fit_reconstruct_direct_reference)
        check = check_basis_b if kernel == "B" else check_basis_c
        for dtype in ("float32", "float16", "bfloat16"):
            base = flagship.replace(solver=solver, tmp_data_dtype=dtype)
            default_ms = kernel_device_ms(
                lambda: fit(base, *planes, frame), default_name)
            for bname, kw in BASES.items():
                cfg = base.replace(**kw)
                print(f"[basis {kernel}] {bname} ({cfg.feature_count} "
                      f"features, {cfg.buffer_count} columns), {dtype}:")
                err, bad = check(cfg, cur, accum, frame)
                dev_ms = kernel_device_ms(lambda: fit(cfg, *planes, frame),
                                          kname)
                call_ms = cuda_ms(lambda: fit(cfg, *planes, frame), 20)
                b_ms, by = basis_bound(cfg, kernel)
                print(f"[basis {kernel}] {gpu_line()}: {bname} {dtype}: "
                      "kernel device "
                      + ("not measured" if dev_ms is None else
                         f"{dev_ms:.4f} ms ({100 * b_ms / dev_ms:.1f}% of "
                         f"the bound {b_ms:.4f} ms, {by})")
                      + f"; wrapper {call_ms:.4f} ms; default-basis kernel "
                      "in this call "
                      + ("not measured" if default_ms is None
                         else f"{default_ms:.4f} ms"))
                r = dict(max_abs_err=err, off_tolerance=bad,
                         device_ms=dev_ms, wrapper_ms=call_ms, bound_ms=b_ms,
                         bound_by=by, default_basis_device_ms=default_ms)
                if dtype == "float32":
                    old_ms, old_by = basis_bound(cfg, kernel,
                                                 cfg.buffer_count)
                    plain_ms = cuda_ms(lambda: plain(cfg, *planes, frame), 3)
                    print(f"[basis {kernel}] {bname}: the bound over F + 3 "
                          f"planes (the earlier front's) {old_ms:.4f} ms "
                          f"({old_by}); plain version {plain_ms:.4f} ms")
                    r.update(bound_f3_ms=old_ms, plain_ms=plain_ms)
                if kernel == "C" and dtype == "float32":
                    tmp = build_feature_blocks(cfg, *planes, frame)
                    w, _ = fit_blocks_direct(cfg, *planes, frame)
                    lib_ms, lib_rel = lstsq_yardstick(cfg, tmp, w, frame)
                    print(f"[basis C] {bname}: torch.linalg.lstsq on the "
                          f"same stored system {lib_ms:.4f} ms per call, "
                          f"weights' relative norm from the kernel's "
                          f"{lib_rel:.3e}")
                    r.update(library_ms=lib_ms, library_rel=lib_rel)
                rec[f"{kernel} {bname} {dtype}"] = r
    rec["override"] = override_phase(flagship, cur, frame)
    return rec


def override_phase(flagship, cur, frame):
    """``[basis override]``: ``normal_x`` registered anew (as -n[0]) on the
    default basis. Kernels B and C must take the basis front (the name no
    longer holds its built-in function), equal their plain versions, which
    evaluate the registry, and differ from the built-in basis's output.
    The registry is restored after."""
    from bmfr_tpu_torch import features

    builtin = features.FEATURE_REGISTRY["normal_x"]
    planes = (cur.normals, cur.positions, cur.noisy)
    rec = {}
    bt.register_feature("normal_x", lambda n, p: -n[0])
    try:
        for kernel, solver, fit, plain in (
                ("B", "cholesky", fit_reconstruct_cholesky,
                 fit_reconstruct_cholesky_reference),
                ("C", "householder", fit_reconstruct_direct,
                 fit_reconstruct_direct_reference)):
            cfg = flagship.replace(solver=solver)
            plan = basis_plan(cfg)
            require(not plan.default and plan.planes == ("normal_x",),
                    f"override {kernel}: plan {plan}")
            n0 = fit.launches
            got, w = fit(cfg, *planes, frame)
            ref, wr = plain(cfg, *planes, frame)
            torch.cuda.synchronize()
            launched = fit.launches - n0
            bad = off_tolerance(got, ref, FIT_TOL)
            err = float((got - ref).abs().max())
            features.FEATURE_REGISTRY["normal_x"] = builtin
            try:
                builtin_img, _ = fit(cfg, *planes, frame)
            finally:
                bt.register_feature("normal_x", lambda n, p: -n[0])
            moved = float((builtin_img - ref).abs().max())
            print(f"[basis override] {kernel}: normal_x registered as "
                  f"-n[0]: kernel vs plain max |err| {err:.3e}, "
                  f"off-tolerance values {bad} of {got.numel()}, launches "
                  f"{launched}; the built-in basis's image differs from "
                  f"plain's by {moved:.3e}")
            require(bad == 0 and launched == 1,
                    f"override {kernel}: {bad} values off tolerance")
            require(moved > FIT_TOL, f"override {kernel}: the override "
                    "does not move the image, so the check shows nothing")
            if kernel == "C":
                wb, mm = fit_blocks_direct(cfg, *planes, frame)
                wbr, mmr = fit_blocks_direct_reference(cfg, *planes, frame)
                check_weights("basis override", "C blocks entry", wb, mm,
                              wbr, mmr, "float32")
            rec[kernel] = dict(max_abs_err=err, off_tolerance=bad,
                               builtin_moves=moved)
    finally:
        features.FEATURE_REGISTRY["normal_x"] = builtin
    return rec


def render_scenes(sc):
    """The [scenes] phase's four distinct 1280x720x16 scenes: the orbit
    scene of the earlier phases, another orbit seed, corridor and swing
    (the three new ones rendered on host threads at once)."""
    from concurrent.futures import ThreadPoolExecutor

    specs = (("orbit seed 1", dict(seed=1)),
             ("corridor", dict(seed=3, scene="corridor")),
             ("swing", dict(seed=5, scene="swing")))
    with ThreadPoolExecutor(max_workers=len(specs)) as ex:
        new = list(ex.map(lambda kw: synthetic_sequence(
            width=WIDTH, height=HEIGHT, frames=FRAMES, **kw[1]), specs))
    return [("orbit", sc)] + [(n, s) for (n, _), s in zip(specs, new)]


def scene_batch(scenes, dev):
    """The scenes as the scene-parallel entry takes them: FrameInputs of
    ``[S, T, 3, H, W]``, cameras ``[S, T, 4, 4]``, offsets ``[S, T, 2]``."""
    ups = [(bt.frame_inputs_from_numpy(s["normals"], s["positions"],
                                       s["noisy"], s["albedo"], dev),
            s["camera_matrices"], s["pixel_offsets"]) for _, s in scenes]
    inputs = bt.FrameInputs(*(torch.stack([u[0][k] for u in ups])
                              for k in range(4)))
    cams = torch.from_numpy(np.stack([u[1] for u in ups])).to(dev)
    offs = torch.from_numpy(np.stack([u[2] for u in ups])).to(dev)
    return inputs, cams, offs


def scenes_steady(cfg, inputs, cams, offs, S):
    """Frames 1..15 of the first S scenes, each frame one
    ``CompiledStep.run_scenes`` (one graph of S steps): ms per card-frame
    (3 runs after a warm-up that captures), peak memory, capture seconds
    and the device profile of one more run."""
    dev = inputs.noisy.device
    st0 = [bt.denoise_frame(cfg, bt.zero_state(cfg, dev),
                            frame_of(bt.FrameInputs(*(x[s] for x in inputs)),
                                     0), cams[s, 0], offs[s, 0], 0)[0]
           for s in range(S)]
    step = CompiledStep(cfg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run():
        sts = list(st0)
        start.record()
        for t in range(1, FRAMES):
            outs = step.run_scenes([
                (sts[s], bt.FrameInputs(*(x[s, t] for x in inputs)),
                 cams[s, t - 1], offs[s, t], t) for s in range(S)])
            sts = [o[0] for o in outs]
        end.record()

    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    run()
    ms = []
    for _ in range(3):
        run()
        torch.cuda.synchronize()
        ms.append(start.elapsed_time(end) / (FRAMES - 1))
    peak = torch.cuda.max_memory_allocated()
    prof = device_breakdown(f"scenes {cfg.fitter_impl} S={S}", run,
                            FRAMES - 1)
    return dict(ms_per_card_frame=ms, max_memory_allocated=peak,
                above_resident=peak - resident,
                capture_s=sum(step.capture_seconds.values()),
                profile=prof)


def scenes_phase(sc, flagship, exact, dev):
    """``[scenes]``: the flagship and the default path over 1, 2 and 4
    distinct 1280x720x16 scenes on the card, and 4 on a mesh that names
    the card twice: every scene bit-equal to its own ``denoise_sequence``,
    launch counts held, and per card-frame the steady ms, device busy
    ms, kernels, capture seconds and peak memory."""
    t0 = time.perf_counter()
    scenes = render_scenes(sc)
    render_s = time.perf_counter() - t0
    inputs, cams, offs = scene_batch(scenes, dev)
    print(f"[scenes] {', '.join(n for n, _ in scenes)} at {WIDTH}x{HEIGHT}x"
          f"{FRAMES}: rendered in {render_s:.1f} s")
    rec = dict(render_s=render_s)
    for label, cfg, counters, per_frame in (
            ("flagship", flagship,
             {"warp_blend": warp_blend,
              "fit_reconstruct_cholesky": fit_reconstruct_cholesky},
             {"warp_blend": FRAMES - 1, "fit_reconstruct_cholesky": FRAMES}),
            ("default", exact, {"fit_blocks_pallas": fit_blocks_pallas,
                                **DEFAULT_KERNELS},
             {"fit_blocks_pallas": FRAMES, **DEFAULT_LAUNCHES})):
        refs = torch.stack([bt.denoise_sequence(
            cfg, bt.FrameInputs(*(x[s] for x in inputs)), cams[s], offs[s])
            for s in range(len(scenes))])
        counters, per_frame = with_tails(counters, per_frame, FRAMES)
        for S, places in [(S, 1) for S in SCENE_COUNTS] + [(4, 2)]:
            mesh = bt.make_scene_mesh([dev] * places)
            batch = (bt.FrameInputs(*(x[:S] for x in inputs)), cams[:S],
                     offs[:S])
            for fn in counters.values():
                fn.launches = 0
            t1 = time.perf_counter()
            out = bt.denoise_scenes_sharded(cfg, mesh, *batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t1
            launches = {k: fn.launches for k, fn in counters.items()}
            want = {k: S * n for k, n in per_frame.items()}
            same = bool(torch.equal(out, refs[:S]))
            print(f"[scenes] {label} S={S} over {places} place(s) of "
                  f"{dev}: {wall:.2f} s (first run: frame 0 and the "
                  f"captures), launches {launches}, bit-equal to the "
                  f"per-scene denoise_sequence: {same}")
            require(launches == want, f"scenes {label} S={S}: launches "
                    f"{launches}, expected {want}")
            require(same, f"scenes {label} S={S} x{places}: differs from "
                    f"the per-scene runs by "
                    f"{float((out - refs[:S]).abs().max())}")
            rec[f"{label} S={S} places={places}"] = dict(
                launches=launches, first_run_s=wall, bit_equal=same)
        for S in SCENE_COUNTS:
            r = scenes_steady(cfg, inputs, cams, offs, S)
            busy = (r["profile"] or {}).get("busy_ms_per_frame")
            kpf = (r["profile"] or {}).get("kernels_per_frame")
            print(f"[scenes] {gpu_line()}: {label} S={S}: steady ms per "
                  "card-frame (3 runs) "
                  + ", ".join(f"{m:.4f}" for m in r["ms_per_card_frame"])
                  + f" ({min(r['ms_per_card_frame']) / S:.4f} a scene); "
                  f"device busy {busy} ms, {kpf} kernels per card-frame; "
                  f"capture {r['capture_s']:.3f} s; max_memory_allocated "
                  f"{r['max_memory_allocated']} B, of it "
                  f"{r['above_resident']} B above the resident scenes")
            rec[f"{label} S={S} steady"] = r
        del refs
    rec["phase_s"] = time.perf_counter() - t0
    print(f"[scenes] the phase took {rec['phase_s']:.1f} s")
    return rec


def entry_phase():
    """``[entry]``: ``graft_entry.entry()``'s step at 1280x720 on the
    card, once eagerly (``denoise_frame``) and twice through ``fn`` (the
    capture, then a replay), all three results equal."""
    fn, args = graft_entry.entry()
    cfg = graft_entry.entry_config()
    eager = bt.denoise_frame(cfg, *args, history="always")[1]["result"]
    # a TemporalState: kernel I in packed_bf16, not A
    counted = (warp_blend, warp_blend_planes, fit_reconstruct_direct,
               *TAILS.values())
    for k in counted:
        k.launches = 0
    t0 = time.perf_counter()
    _, first = fn(*args)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    _, again = fn(*args)
    torch.cuda.synchronize()
    launches = tuple(k.launches for k in counted)
    same = bool(torch.equal(first, eager)) and bool(torch.equal(again, eager))
    ms = cuda_ms(lambda: fn(*args), 20)
    print(f"[entry] {gpu_line()}: fn at {cfg.image_width}x"
          f"{cfg.image_height} ({cfg.warp_mode} warp, {cfg.fitter_impl} "
          f"{cfg.solver}): eager, captured ({capture_s:.2f} s with the "
          f"capture) and replayed equal: {same}; launches A, I, C, H, G, "
          f"F {launches}; "
          f"{ms:.4f} ms a replayed call")
    require(same, "entry: the captured step differs from the eager one")
    require(launches == (0,) + (2,) * 5, f"entry: launches {launches}")
    require(tuple(first.shape) == (3, 720, 1280)
            and bool(torch.isfinite(first).all()), "entry: result")
    return dict(bit_equal=same, launches=launches, capture_s=capture_s,
                ms_per_call=ms)


def dryrun_phase(dev):
    """``[dryrun]``: ``dryrun_multichip`` on the card alone, and on a mesh
    that names it DRYRUN_PLACES times; every scene must equal its
    per-scene run (0, below the JAX package's 1e-5)."""
    rec = {}
    for label, n, devices in (("1 card", 1, None),
                              (f"{dev} x{DRYRUN_PLACES}", DRYRUN_PLACES,
                               [dev] * DRYRUN_PLACES)):
        t0 = time.perf_counter()
        errs = graft_entry.dryrun_multichip(n, devices=devices)
        s = time.perf_counter() - t0
        print(f"[dryrun] {label}: max |diff| per config (xla, flagship "
              f"householder, flagship cholesky bf16) {errs}; {s:.1f} s")
        require(errs == [0.0, 0.0, 0.0], f"dryrun {label}: {errs}")
        rec[label] = dict(max_abs_diff=errs, s=s)
    return rec


#: the bench's sequence (``python -m bmfr_tpu_torch.bench``'s default)
BENCH_FRAMES = 60
#: the keys of ``bench.py``'s result line (``tests/test_torch_bench.py``
#: holds the port's bench to ``bench.py``'s source)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "spread_ms",
              "reps_ms", "config", "device_span_ms_per_frame",
              "warp_kernel_served_pct", "warp_fallback_frames")
BENCH_LAUNCHES = re.compile(r"^\[bench\] launches per run: (\{.*\})$", re.M)
#: a bench's trace check (``profile_stages.check_launches`` through
#: ``bench.profiled_run``): the trace's number, events and launches
BENCH_TRACE = re.compile(r"^\[bench\] profiled run \(trace (\d+)\): (\d+) "
                         r"device events of the port's kernels for (\d+) "
                         r"launches counted", re.M)


def bench_trace_check(label, log, expected):
    """The trace check of one ``[bench]`` cell, read from its log and
    printed: its last trace must hold one device event of the port's
    kernels per launch of one run (``expected``). A bench whose traces all
    lost or gained events has raised before this."""
    found = BENCH_TRACE.findall(log)
    require(found, f"[bench] {label}: no trace check in its log")
    trace, events, launches = map(int, found[-1])
    want = sum(expected.values())
    require(events == launches == want,
            f"[bench] {label}: the profiled run's trace holds {events} "
            f"device events of the port's kernels for {launches} launches "
            f"({want} a run)")
    print(f"[bench] {label}: trace check {events} device events of the "
          f"port's kernels for {launches} launches of one run, trace "
          f"{trace} of at most {TRACE_ATTEMPTS}")
    return dict(trace=trace, events=events, launches=launches)


def bench_command(flagship):
    """``python -m bmfr_tpu_torch.bench`` once, as a user runs it (no
    ``BENCH_*`` set: the 60-frame 1280x720 orbit flagship); its last line
    parsed and checked, and the launches of one of its runs read from its
    log. Returns ``(record, launches)``."""
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "bmfr_tpu_torch.bench"],
                          env=env, capture_output=True, text=True,
                          timeout=600)
    for line in proc.stderr.splitlines():
        print(f"[bench command] {line}")
    require(proc.returncode == 0, f"python -m bmfr_tpu_torch.bench exited "
            f"{proc.returncode}")
    last = proc.stdout.strip().splitlines()[-1]
    print(f"[bench command] {last}")
    rec = json.loads(last)
    require(set(rec) == set(BENCH_KEYS) | set(bench.ADDED_KEYS),
            f"bench keys {sorted(rec)}")
    require(rec["metric"] == f"denoise_ms_per_frame_{WIDTH}x{HEIGHT}",
            f"bench metric {rec['metric']}")
    require(rec["config"] == "scene=orbit warp=pallas fitter=pallas_direct "
            "solver=cholesky residual=bfloat16 tier=steady_cond",
            f"bench config {rec['config']}")
    require(len(rec["reps_ms"]) == 5 and rec["value"] == round(
        float(np.median(rec["reps_ms"])), 4), "bench: the median of 5 runs")
    for key in ("value", "device_span_ms_per_frame", "busy_ms_per_frame",
                "steady_ms_per_frame"):
        require(isinstance(rec[key], float) and np.isfinite(rec[key])
                and rec[key] > 0,
                f"bench {key}: {rec[key]}")
    require(rec["device"] == gpu_line(), f"bench device {rec['device']}")
    require(rec["warp_kernel_served_pct"] == 100.0
            and rec["warp_fallback_frames"] == 0, "bench warp record")
    found = BENCH_LAUNCHES.search(proc.stderr)
    require(found is not None, "bench: no launch line")
    launches = json.loads(found.group(1))
    require(launches == bench.expected_launches(flagship, BENCH_FRAMES),
            f"bench launches {launches}")
    return rec, launches, bench_trace_check("flagship orbit (command)",
                                            proc.stderr, launches)


def bench_phase(flagship, exact, hh_flagship, dev):
    """[bench]: the bench command once, while host threads render the
    60-frame swing and orbit scenes; then, in this process, the bench's
    ``run_bench`` on the swing flagship, the reference-exact default path
    and the householder flagship (orbit) at 60 frames, with every count
    set to 0 just before each and read just after (``run_bench`` also
    holds each of its runs to ``expected_launches``). Returns the phase's
    record and the orbit scene on the card (for ``[bench trace]``)."""
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=2) as ex:
        renders = {name: ex.submit(synthetic_sequence, width=WIDTH,
                                   height=HEIGHT, frames=BENCH_FRAMES,
                                   scene=name)
                   for name in ("swing", "orbit")}
        rec, launches, trace = bench_command(flagship)
        command_s = time.perf_counter() - t0
        scenes = {name: f.result() for name, f in renders.items()}
    render_s = time.perf_counter() - t0
    print(f"[bench] the command {command_s:.1f} s; the 60-frame swing and "
          f"orbit scenes rendered on host threads beside it by "
          f"{render_s:.1f} s")
    runs = {"flagship orbit (command)": dict(record=rec, launches=launches,
                                             trace=trace)}
    on_card = {}
    for label, cfg, name in (("flagship swing", flagship, "swing"),
                             ("default", exact, "orbit"),
                             ("householder flagship", hh_flagship, "orbit")):
        if name not in on_card:     # one scene on the card at a time
            on_card.clear()
            on_card[name] = bench.scene_inputs(scenes.pop(name), dev)
        inputs, cams, offs = on_card[name]
        for fn in bench.COUNTERS.values():
            fn.launches = 0
        t1 = time.perf_counter()
        log = io.StringIO()
        try:    # a bench that raises fails the phase: its log is printed
            record, out, expected = bench.run_bench(
                cfg, inputs, cams, offs, reps=5, scene=name, log=log)
        finally:
            print(log.getvalue(), end="")
        got = {k: fn.launches for k, fn in bench.COUNTERS.items()}
        require(got == expected, f"[bench] {label}: launches {got}, "
                f"expected {expected}")
        require(tuple(out.shape) == (BENCH_FRAMES, 3, HEIGHT, WIDTH),
                f"[bench] {label}: output shape {tuple(out.shape)}")
        trace = bench_trace_check(label, log.getvalue(), expected)
        print(f"[bench] {label}: {json.dumps(record)}; launches of one run "
              f"{got}; {time.perf_counter() - t1:.1f} s")
        runs[label] = dict(record=record, launches=got, trace=trace)
        del out
    print(f"[bench] the phase took {time.perf_counter() - t0:.1f} s")
    return runs, on_card["orbit"]


def bench_trace_phase(flagship, inputs, cams, offs, dev):
    """[bench trace]: the flagship's 60-frame bench sequence split by
    stage (``sequence_trace_report``), its eager stage total with the
    compiled step's copies within 5 % of the compiled sequence's busy
    time, and every launch of the port's kernels in each trace."""
    t0 = time.perf_counter()
    print(f"[bench trace] {gpu_line()}")
    try:
        rows = sequence_trace_report(flagship, inputs, cams, offs, dev)
    except RuntimeError as e:
        require(False, f"[bench trace] {e}")
    print(f"[bench trace] the phase took {time.perf_counter() - t0:.1f} s")
    return rows


#: the [carry] phase's timed runs of each whole sequence
CARRY_REPS = 5


def carry_launches(cfg, frames, state_type):
    """Each counted wrapper's launches in one ``denoise_sequence`` of
    ``frames`` frames from a ``state_type`` carry: the bench's
    (``bench.expected_launches``, a PackedState on the fused warp), with
    kernel I in packed_bf16 in place of kernel A on the fused warp's
    TemporalState."""
    n = bench.expected_launches(cfg, frames)
    if state_type is bt.TemporalState and cfg.warp_mode == "pallas":
        n["warp_blend_planes"], n["warp_blend"] = n["warp_blend"], 0
    return n


def carry_cell(label, cfg, inputs, cams, offs, state_type, reps=CARRY_REPS):
    """One configuration on one carry over the whole sequence on the card,
    through ``denoise_sequence`` from ``state_type``'s zero state (frame 0
    eager, the compiled step replayed): the first run's results and the
    launches of each counted wrapper (every count set to 0 just before);
    the headline-style ms/frame of ``reps`` more runs (host clock up to the
    checksum's host read, as the bench times a run), their median; and
    one more run through ``profile_stages.checked_trace`` (the same
    frames eagerly and the run first, in the trace; one device event of
    the port's kernels per launch): busy ms/frame, device operations a
    frame and copies a frame inside the run's range, and the run's
    launches. It uses only what the port has had since its checked bench
    trace, so ``scripts/torch_carry_ab.py`` runs it on an older tree."""
    from torch.profiler import ProfilerActivity

    from bmfr_tpu_torch.profile_stages import checked_trace

    dev = inputs.noisy.device
    T = inputs.noisy.shape[0]

    def initial():
        return (bt.TemporalState.initial(cfg, dev)
                if state_type is bt.TemporalState
                else bt.PackedState.initial(cfg, dev))

    def run():
        return bt.denoise_sequence(cfg, inputs, cams, offs,
                                   initial_state=initial()).sum().item()

    def warm():
        st = initial()
        for t in range(T):
            st, _ = bt.denoise_frame(cfg, st, frame_of(inputs, t),
                                     cams[max(t - 1, 0)], offs[t], t)
        run()

    for fn in bench.COUNTERS.values():
        fn.launches = 0
    t0 = time.perf_counter()
    out = bt.denoise_sequence(cfg, inputs, cams, offs,
                              initial_state=initial())
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in bench.COUNTERS.items()}
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append((time.perf_counter() - t0) / T * 1e3)
    tally = {}
    log = io.StringIO()
    events = checked_trace(f"[carry] {label} {state_type.__name__}",
                           [ProfilerActivity.CPU, ProfilerActivity.CUDA],
                           run, dev, warm=warm, log=log, launches=tally)
    work = device_events(events, within=RUN_RANGE)
    del events
    return dict(
        out=out, launches=launches, first_run_s=first_s,
        ms_per_frame=float(np.median(times)), reps_ms=times,
        busy_ms_per_frame=sum(e.time_range.elapsed_us() for e in work)
        / T / 1e3,
        ops_per_frame=len(work) / T,
        copies_per_frame=sum("Memcpy" in e.name for e in work) / T,
        trace_launches={k: tally.get(fn, 0)
                        for k, fn in bench.COUNTERS.items()},
        trace_check=log.getvalue().strip())


def carry_configs(flagship, exact):
    """The [carry] phase's configurations: the graft entry's (the
    Householder flagship on a TemporalState, ``graft_entry.entry()``), the
    Cholesky flagship (the stream's, the checkpoint's, the CLI's with
    ``--warp-mode pallas``) and the default path."""
    return (("graft entry", graft_entry.entry_config()),
            ("flagship", flagship), ("default", exact))


def carry_phase(flagship, exact, inputs, cams, offs):
    """[carry]: each of :func:`carry_configs` over the 60-frame orbit scene
    on a TemporalState carry and, on the fused warp, on a PackedState
    (:func:`carry_cell`): each run's launches held to
    :func:`carry_launches` (the fused warp's TemporalState: kernel I 59,
    kernel A 0), each trace to one device event a launch, the flagships'
    60 results on the two carries equal bit for bit, every result finite
    and of the scene's shape."""
    t0 = time.perf_counter()
    print(f"[carry] {gpu_line()}")
    T = inputs.noisy.shape[0]
    rec = {}
    for label, cfg in carry_configs(flagship, exact):
        carries = ((bt.TemporalState, bt.PackedState)
                   if cfg.warp_mode == "pallas" else (bt.TemporalState,))
        outs = {}
        for state_type in carries:
            name = state_type.__name__
            cell = carry_cell(label, cfg, inputs, cams, offs, state_type)
            out = outs[name] = cell.pop("out")
            expected = carry_launches(cfg, T, state_type)
            print(f"[carry] {label} on a {name}: "
                  f"{cell['ms_per_frame']:.4f} ms/frame (median of "
                  f"{CARRY_REPS} runs: "
                  + ", ".join(f"{m:.4f}" for m in cell["reps_ms"])
                  + f"), checked busy {cell['busy_ms_per_frame']:.4f} "
                  f"ms/frame, {cell['ops_per_frame']:.1f} device operations "
                  f"a frame ({cell['copies_per_frame']:.1f} copies); "
                  f"launches {cell['launches']}; first run "
                  f"{cell['first_run_s']:.2f} s")
            print(cell["trace_check"])
            require(cell["launches"] == expected
                    and cell["trace_launches"] == expected,
                    f"[carry] {label} {name}: launches {cell['launches']}, "
                    f"traced {cell['trace_launches']}, expected {expected}")
            require(tuple(out.shape) == (T, 3, HEIGHT, WIDTH)
                    and bool(torch.isfinite(out).all()),
                    f"[carry] {label} {name}: result")
            rec[f"{label} {name}"] = cell
        if len(outs) == 2:
            same = bool(torch.equal(outs["TemporalState"],
                                    outs["PackedState"]))
            print(f"[carry] {label}: the {T} results on the TemporalState "
                  f"carry bit-equal to the PackedState carry's: {same}")
            require(same, f"[carry] {label}: the carries differ")
            rec[f"{label} bit_equal"] = same
        del outs
    print(f"[carry] the phase took {time.perf_counter() - t0:.1f} s")
    return rec


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAIL: no CUDA device")
    t_main = time.perf_counter()
    dev = torch.device("cuda:0")
    smi = gpu_line()
    print(f"[gpu] {smi}")
    print(f"[versions] python {sys.version.split()[0]} torch "
          f"{torch.__version__} cuda {torch.version.cuda} device "
          f"{torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    # ---- build ----
    t0 = time.perf_counter()
    _lib.build(verbose=True)
    _lib.library()
    build_s = time.perf_counter() - t0
    print(f"[build] nvcc sm_90a, {len(_lib.SOURCES)} sources in parallel: "
          f"{build_s:.1f} s")

    # ---- scene ----
    t0 = time.perf_counter()
    sc = synthetic_sequence(width=WIDTH, height=HEIGHT, frames=FRAMES)
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], dev)
    cams = torch.from_numpy(sc["camera_matrices"]).to(dev)
    offs = torch.from_numpy(sc["pixel_offsets"]).to(dev)
    print(f"[scene] orbit {WIDTH}x{HEIGHT}x{FRAMES}: "
          f"{time.perf_counter() - t0:.1f} s")
    flagship = bt.BMFRConfig(image_width=WIDTH, image_height=HEIGHT,
                             **SCENE_LIMITS, **bt.FLAGSHIP)
    exact = bt.BMFRConfig(image_width=WIDTH, image_height=HEIGHT,
                          **SCENE_LIMITS)
    hh_flagship = flagship.replace(solver="householder")
    errs, ms = {}, {}

    # ---- kernel A vs plain ----
    cfg = flagship
    state = bt.PackedState.initial(cfg, dev)
    state, _ = bt.denoise_frame(cfg, state, frame_of(inputs, 0), cams[0],
                                offs[0], 0)
    cur = frame_of(inputs, 1)
    pfx, pfy = reproject_coords(cfg, cur.positions, cams[0], offs[1])
    errs["A"] = check_warp(cfg, state, cur, pfx, pfy, "orbit frame 1")
    yy = torch.arange(HEIGHT, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(WIDTH, device=dev, dtype=torch.float32)[None, :]
    # sweeps ix through -2, -1 (left edge), W-1 and W (right edge), and
    # iy off the bottom: on-screen, edge and fully off-screen pixels
    sx = xx * (1.0 + 3.0 / WIDTH) - 1.6 + yy * (1.5 / HEIGHT)
    sy = yy * 1.01 + 2.3 - xx * (2.0 / WIDTH)
    rnd = np.random.default_rng(0).standard_normal(
        (16, HEIGHT, WIDTH)).astype(np.float32)
    rstate = bt.PackedState(pack_pairs_bf16(torch.from_numpy(rnd).to(dev)))
    ix_s = floor_int(sx)
    require(bool((ix_s == -1).any() & (ix_s == -2).any()
                 & (ix_s == WIDTH - 1).any() & (ix_s >= WIDTH).any()),
            "synthetic field misses an edge case")
    errs["A"] = max(errs["A"], check_warp(cfg, state, cur, sx, sy,
                                          "synthetic field, real state"))
    errs["A"] = max(errs["A"], check_warp(cfg, rstate, cur, sx, sy,
                                          "synthetic field, random state"))
    ms["A"] = (cuda_ms(lambda: warp_blend(
        cfg, state.src8, cur.positions, cur.normals, pfx, pfy), 50),
        cuda_ms(lambda: warp_blend_reference(
            cfg, state.src8, cur.positions, cur.normals, pfx, pfy), 10))
    dev_ms, bounds = {}, {}
    dev_ms["A"] = kernel_device_ms(lambda: warp_blend(
        cfg, state.src8, cur.positions, cur.normals, pfx, pfy),
        "warp_blend_kernel")
    # in: the 8 state words, positions, normals, pfx, pfy; out: 13 planes;
    # ~200 operations per pixel (4 taps x 16 channels, the tests)
    bounds["A"] = bound(nbytes(state.src8, cur.positions, cur.normals, pfx,
                               pfy) + 13 * 4 * HEIGHT * WIDTH,
                        200 * HEIGHT * WIDTH)

    # ---- kernel B vs plain (two jitter offsets; f32 and f16 tmp) ----
    errs["B"] = 0.0
    for f, dtype in ((0, "float32"), (5, "float32"), (5, "float16")):
        c = frame_of(inputs, f)
        errs["B"] = max(errs["B"], check_reconstruct(
            "fit_reconstruct_cholesky", fit_reconstruct_cholesky,
            fit_reconstruct_cholesky_reference,
            flagship.replace(tmp_data_dtype=dtype), c, c.noisy, f))
    c5 = frame_of(inputs, 5)
    ms["B"] = (cuda_ms(lambda: fit_reconstruct_cholesky(
        cfg, c5.normals, c5.positions, c5.noisy, 5), 50),
        cuda_ms(lambda: fit_reconstruct_cholesky_reference(
            cfg, c5.normals, c5.positions, c5.noisy, 5), 5))
    dev_ms["B"] = kernel_device_ms(lambda: fit_reconstruct_cholesky(
        cfg, c5.normals, c5.positions, c5.noisy, 5), "fit_chol_kernel")
    for dtype in ("float16", "bfloat16"):
        bcfg = cfg.replace(tmp_data_dtype=dtype)
        dev_ms[f"B {dtype}"] = kernel_device_ms(
            lambda: fit_reconstruct_cholesky(bcfg, c5.normals, c5.positions,
                                             c5.noisy, 5), "fit_chol_kernel")
    # in: 9 raw planes; out: the image and the weights. Per view cell ~30
    # operations of features and 170 of the 85 Gram and rhs sums, per
    # image pixel 60 of the reconstruction
    planes_bytes = nbytes(c5.normals, c5.positions, c5.noisy)
    cells = flagship.n_blocks * flagship.block_pixels
    direct_out = 3 * 4 * HEIGHT * WIDTH + flagship.n_blocks * 30 * 4
    bounds["B"] = bound(planes_bytes + direct_out,
                        200 * cells + 60 * HEIGHT * WIDTH)

    # ---- kernel C vs plain: both entries, frames 0, 5, 13 ----
    errs["C"] = 0.0
    for f in (0, 5, 13):
        c = frame_of(inputs, f)
        planes = (c.normals, c.positions, c.noisy)
        errs["C"] = max(errs["C"], check_reconstruct(
            "fit_reconstruct_direct", fit_reconstruct_direct,
            fit_reconstruct_direct_reference, hh_flagship, c, c.noisy, f))
        w, mm = fit_blocks_direct(hh_flagship, *planes, f)
        wr, mmr = fit_blocks_direct_reference(hh_flagship, *planes, f)
        errs["C"] = max(errs["C"], check_weights(
            "fit_blocks_direct", f"frame {f}", w, mm, wr, mmr, "float32"))
    ms["C"] = (cuda_ms(lambda: fit_reconstruct_direct(
        hh_flagship, c5.normals, c5.positions, c5.noisy, 5), 50),
        cuda_ms(lambda: fit_reconstruct_direct_reference(
            hh_flagship, c5.normals, c5.positions, c5.noisy, 5), 5))
    ms["C blocks"] = (cuda_ms(lambda: fit_blocks_direct(
        hh_flagship, c5.normals, c5.positions, c5.noisy, 5), 50),
        cuda_ms(lambda: fit_blocks_direct_reference(
            hh_flagship, c5.normals, c5.positions, c5.noisy, 5), 5))
    dev_ms["C"] = kernel_device_ms(lambda: fit_reconstruct_direct(
        hh_flagship, c5.normals, c5.positions, c5.noisy, 5),
        "fit_direct_kernel")
    dev_ms["C blocks"] = kernel_device_ms(lambda: fit_blocks_direct(
        hh_flagship, c5.normals, c5.positions, c5.noisy, 5),
        "fit_direct_kernel")
    # as B, with the reflections in place of the Gram sums (~40 per view
    # cell of features, rescale and noise)
    bounds["C"] = bound(planes_bytes + direct_out,
                        qr_flops(flagship.n_blocks, flagship.block_pixels,
                                 flagship.buffer_count) + 40 * cells
                        + 60 * HEIGHT * WIDTH)

    # ---- kernel D vs plain: the orbit frame's feature blocks ----
    errs["D"] = 0.0
    for dtype, be in (("float32", 32), ("float16", 32), ("bfloat16", 32),
                      ("float32", 8), ("float32", 16), ("float32", 48),
                      ("float32", 64)):
        dcfg = exact.replace(tmp_data_dtype=dtype, block_edge=be)
        tmp = build_feature_blocks(dcfg, c5.normals, c5.positions, c5.noisy,
                                   5)
        require(tmp.dtype == STORAGE_DTYPES[dtype], f"tmp dtype {tmp.dtype}")
        w, mm = fit_blocks_pallas(dcfg, tmp, 5)
        wr, mmr = fit_blocks_pallas_reference(dcfg, tmp, 5)
        errs["D"] = max(errs["D"], check_weights(
            "fit_blocks_pallas", f"{dtype} block_edge {be}, "
            f"{dcfg.n_blocks} blocks", w, mm, wr, mmr, dtype))
        dev_ms[f"D {dtype} block_edge {be}"] = kernel_device_ms(
            lambda: fit_blocks_pallas(dcfg, tmp, 5), "fit_blocks")
        if (dtype, be) == ("float32", 32):
            ms["D"] = (cuda_ms(lambda: fit_blocks_pallas(dcfg, tmp, 5), 50),
                       cuda_ms(lambda: fit_blocks_pallas_reference(
                           dcfg, tmp, 5), 5))
            dev_ms["D"] = dev_ms[f"D {dtype} block_edge {be}"]
            # in: the blocks; out: weights and mins/maxs; the reflections
            # and ~10 operations per value of the rescale and noise
            bounds["D"] = bound(nbytes(tmp, w, mm),
                                qr_flops(dcfg.n_blocks, dcfg.block_pixels,
                                         dcfg.buffer_count)
                                + 10 * tmp.numel())
            library_ms, lib_rel = lstsq_yardstick(dcfg, tmp, w, 5)

    # ---- kernel E vs the two clipped gathers ----
    src = pack_x_pairs_bf16(torch.from_numpy(rnd).to(dev))
    ix, iy = floor_int(pfx), floor_int(pfy)
    errs["E"] = check_rows(src, iy, ix, "orbit frame 1, 16 channels")
    sx2, sy2 = sx.clone(), sy.clone()
    extreme = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                            -1e30, 2.0**31, -(2.0**31)], device=dev)
    sx2[0, :7] = extreme
    sy2[1:8, 0] = extreme
    sy2[9, :7] = extreme
    errs["E"] = check_rows(src, floor_int(sy2), floor_int(sx2),
                           "edges and saturated coordinates")
    ms["E"] = (cuda_ms(lambda: warp_rows(src, iy, ix), 50),
               cuda_ms(lambda: warp_rows_reference(src, iy, ix), 10))
    dev_ms["E"] = kernel_device_ms(lambda: warp_rows(src, iy, ix),
                                   "warp_rows_kernel")
    row0, row1 = warp_rows(src, iy, ix)
    bounds["E"] = bound(nbytes(src, iy, ix, row0, row1), 0)
    del row0, row1

    # ---- kernels F, G and H vs plain ----
    field = torch.stack([sx2, sy2]).contiguous()
    t_errs, t_ms, t_dev, t_bounds = tail_phase(flagship, exact, inputs, cams,
                                               offs, field)
    errs.update(t_errs)
    ms.update(t_ms)
    dev_ms.update(t_dev)
    bounds.update(t_bounds)

    # ---- kernels I, J and K vs plain ----
    d_errs, d_ms, d_dev, d_bounds, k_library_ms = default_kernels_phase(
        exact, inputs, cams, offs, field)
    errs.update(d_errs)
    ms.update(d_ms)
    dev_ms.update(d_dev)
    bounds.update(d_bounds)
    print(f"[library] torch.linalg.lstsq on kernel D's f32 system "
          f"(block_edge 32, frame 5): {library_ms:.4f} ms per call, "
          f"weights' relative norm from kernel D {lib_rel:.3e}")
    for k, (b_ms, by) in bounds.items():
        print(f"[bound] kernel {k}: {b_ms:.4f} ms ({by}); device "
              + ("not measured" if dev_ms[k] is None
                 else f"{dev_ms[k]:.4f} ms, {100 * b_ms / dev_ms[k]:.1f}% "
                 "of the bound"))
    for k, (m, p) in ms.items():
        print(f"[time] kernel {k}: wrapper {m:.4f} ms, plain {p:.4f} ms")
    for k, m in dev_ms.items():
        print(f"[time] kernel {k}: device "
              + ("not measured" if m is None else f"{m:.4f} ms per call"))

    # ---- kernels B and C on other feature bases ----
    t0 = time.perf_counter()
    basis = basis_phase(flagship, c5, 5)
    print(f"[basis] the phases took {time.perf_counter() - t0:.1f} s")

    # ---- the paths ----
    paths = {}
    paths["flagship"] = run_path(
        "flagship", flagship, sc, inputs, cams, offs,
        {"warp_blend": warp_blend,
         "fit_reconstruct_cholesky": fit_reconstruct_cholesky},
        {"warp_blend": FRAMES - 1, "fit_reconstruct_cholesky": FRAMES})
    paths["default"] = run_path(
        "default", exact, sc, inputs, cams, offs,
        {"fit_blocks_pallas": fit_blocks_pallas, "warp_rows": warp_rows,
         **DEFAULT_KERNELS},
        {"fit_blocks_pallas": FRAMES, "warp_rows": 0, **DEFAULT_LAUNCHES})
    paths["householder_flagship"] = run_path(
        "householder_flagship", hh_flagship, sc, inputs, cams, offs,
        {"warp_blend": warp_blend,
         "fit_reconstruct_direct": fit_reconstruct_direct},
        {"warp_blend": FRAMES - 1, "fit_reconstruct_direct": FRAMES})
    paths["flagship first_order"] = run_path(
        "flagship first_order", flagship.replace(**BASES["first_order"]),
        sc, inputs, cams, offs,
        {"warp_blend": warp_blend,
         "fit_reconstruct_cholesky": fit_reconstruct_cholesky},
        {"warp_blend": FRAMES - 1, "fit_reconstruct_cholesky": FRAMES})
    # kernel C's basis front at 16 columns: ten built-in codes and the three
    # cross terms as extra planes
    for name, fn in CROSS_FEATURES.items():
        bt.register_feature(name, fn)
    hh16 = hh_flagship.replace(**BASES["16 columns"])
    require(len(basis_plan(hh16).planes) == 3, "16 columns: 3 extra planes")
    paths["householder flagship 16 columns"] = run_path(
        "householder flagship 16 columns", hh16, sc, inputs, cams, offs,
        {"warp_blend": warp_blend,
         "fit_reconstruct_direct": fit_reconstruct_direct},
        {"warp_blend": FRAMES - 1, "fit_reconstruct_direct": FRAMES})

    # launches per frame that the in-kernel hash saves: one torch noise
    # field per fitter launch before (B, D and C each made one per call)
    cfg0 = exact
    saved = kernels_launched(lambda: feature_noise(
        5, cfg0.feature_count, cfg0.block_pixels, cfg0.buffer_count,
        cfg0.noise_amount, dev))
    for label, rec in paths.items():
        after = (rec["profile"] or {}).get("kernels_per_frame")
        rec["noise_kernels_saved_per_frame"] = saved
        print(f"[launches] {label}: {after} device kernels per steady frame "
              f"with the noise hashed in the kernel; the torch noise field "
              f"took {saved} more per frame")

    # ---- the per-stage device split (profile_stages --trace) ----
    for label, cfg in (("flagship", flagship), ("default", exact)):
        print(f"[stages {label}] {gpu_line()}")
        per, other, total = trace_report(cfg, *steady_setup(cfg, dev), 5,
                                         dev)
        paths[label]["stages_ms_per_frame"] = dict(
            per, unattributed=other, total=total)

    # ---- the stream phase: the scene from disk, streamed and resumed ----
    paths["stream"] = stream_phase(
        sc, inputs, cams, offs, flagship, exact, dev,
        (paths["flagship"]["profile"] or {}).get("kernels_per_frame"))

    # ---- [staging]: the scene staged in every EXR codec, loaded, streamed
    # and run through the CLI ----
    t0 = time.perf_counter()
    paths["staging"] = staging_phase(sc, flagship, exact, dev,
                                     paths["stream"]["timing"])
    print(f"[staging] the phase took {time.perf_counter() - t0:.1f} s")

    # ---- scene-parallel denoising, and the __graft_entry__ counterparts
    paths["scenes"] = scenes_phase(sc, flagship, exact, dev)
    paths["entry"] = entry_phase()
    paths["dryrun"] = dryrun_phase(dev)

    # ---- kernel E's path: gather_taps(mode="pallas") over the default
    # path's warped states (no pipeline configuration reaches kernel E) ----
    step = bt.make_denoise_frame(exact)
    st = bt.zero_state(exact, dev)
    taps_in = []
    for t in range(FRAMES):
        cur_t = frame_of(inputs, t)
        if t > 0:
            px, py = reproject_coords(exact, cur_t.positions, cams[t - 1],
                                      offs[t])
            taps_in.append((st.stacked(), floor_int(py), floor_int(px)))
        st, _ = step(st, cur_t, cams[max(t - 1, 0)], offs[t], t)
    warp_rows.launches = 0
    taps = [gather_taps(s, y, x, mode="pallas") for s, y, x in taps_in]
    e_launches = warp_rows.launches
    same = all(torch.equal(g, gather_taps(s, y, x, mode="packed_x_bf16"))
               for g, (s, y, x) in zip(taps, taps_in))
    print(f"[path taps] gather_taps(mode='pallas') over {len(taps_in)} "
          f"warped states: launches {e_launches}, equal to "
          f"mode='packed_x_bf16': {same}")
    require(e_launches == FRAMES - 1 and same, "kernel E's tap path")
    del taps, taps_in, step, st

    # ---- fidelity and the oracle: the sweep of bmfr_tpu_torch/fidelity.py
    # against the JAX package's TPU record, at full size, and the default
    # path and the flagship against the NumPy oracle ----
    paths["fidelity_r5"] = fidelity_r5_phase(dev)
    paths["fidelity_1280x720"] = fidelity_fullres_phase(dev)
    paths["oracle"] = oracle_phase(dev)

    # ---- [bench]: python -m bmfr_tpu_torch.bench, the swing flagship and
    # the reference-exact path at 60 frames; [bench trace]: the benched
    # sequence split by stage ----
    paths["bench"], orbit60 = bench_phase(flagship, exact, hh_flagship, dev)
    paths["bench trace"] = bench_trace_phase(flagship, *orbit60, dev)
    # ---- [carry]: the TemporalState carry on the card, beside the
    # PackedState, at 60 frames ----
    paths["carry"] = carry_phase(flagship, exact, *orbit60)
    del orbit60
    bench_runs = paths["bench"]

    no_library = {
        "A": "none: no single call computes the clipped 4-tap blend of the "
             "packed state",
        "B": "none: no single call computes the Gram sums, the Cholesky "
             "solve and the reconstruction",
        "E": "none: no single call computes the two clipped row loads",
        **dict.fromkeys("FGHIJ", "none: no single call computes the fused "
                                 "stage")}
    libraries = {"C": (library_ms, "torch.linalg.lstsq"),
                 "D": (library_ms, "torch.linalg.lstsq"),
                 "K": (k_library_ms, "torch.einsum('bfe,bfc->bce') on the "
                                     "rescaled blocks")}

    def entry(key, name, source, replaces, launches, bench_run):
        b_ms, by = bounds[key]
        lib, lib_name = libraries.get(key, (None, no_library.get(key)))
        wrapper = {"A": "warp_blend", "B": "fit_reconstruct_cholesky",
                   "C": "fit_reconstruct_direct", "D": "fit_blocks_pallas",
                   "E": "warp_rows", "F": "filtered_tail", "G": "noisy_tail",
                   "H": "reproject_coords", "I": "warp_blend_planes",
                   "J": "build_feature_blocks", "K": "weighted_sum"}[key]
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches,
                    bench_launches=bench_runs[bench_run]["launches"][wrapper],
                    max_abs_err=errs[key], ms=ms[key][0],
                    plain_ms=ms[key][1], bound_ms=b_ms, bound_by=by,
                    library_ms=lib, device_ms=dev_ms[key], library=lib_name)

    def basis_entry(key, name, source, replaces, launches):
        # the basis kernel at its main path's basis, f32 tmp; max |err|
        # over every basis and tmp dtype of [basis B] / [basis C]
        r = basis[key]
        err = max(v["max_abs_err"] for k, v in basis.items()
                  if k.startswith(key[0] + " "))
        lib = r.get("library_ms")
        return dict(name=name, route="cuda", source=source,
                    replaces=replaces, launches=launches, max_abs_err=err,
                    ms=r["wrapper_ms"], plain_ms=r["plain_ms"],
                    bound_ms=r["bound_ms"], bound_by=r["bound_by"],
                    library_ms=lib, device_ms=r["device_ms"],
                    library=("torch.linalg.lstsq" if lib is not None
                             else no_library["B"]))

    kernels = [
        entry("A", "warp_blend", "bmfr_tpu_torch/csrc/warp_blend.cu",
              "bmfr_tpu/ops/warp_pallas.py:745",
              paths["flagship"]["launches"]["warp_blend"],
              "flagship orbit (command)"),
        entry("B", "fit_reconstruct_cholesky",
              "bmfr_tpu_torch/csrc/fitter_chol.cu",
              "bmfr_tpu/ops/fitter_direct.py:512",
              paths["flagship"]["launches"]["fit_reconstruct_cholesky"],
              "flagship orbit (command)"),
        entry("C", "fit_reconstruct_direct",
              "bmfr_tpu_torch/csrc/householder_direct.cu",
              "bmfr_tpu/ops/fitter_direct.py:255",
              paths["householder_flagship"]["launches"][
                  "fit_reconstruct_direct"], "householder flagship"),
        entry("D", "fit_blocks_pallas",
              "bmfr_tpu_torch/csrc/householder_blocks.cu",
              "bmfr_tpu/ops/fitter_pallas.py:92",
              paths["default"]["launches"]["fit_blocks_pallas"], "default"),
        entry("E", "warp_rows", "bmfr_tpu_torch/csrc/warp_rows.cu",
              "bmfr_tpu/ops/warp_pallas.py:276", e_launches, "default"),
        entry("F", "filtered_tail", "bmfr_tpu_torch/csrc/filtered_tail.cu",
              "bmfr_tpu/ops/accumulate.py:16 + bmfr_tpu/ops/taa.py:29 + "
              "bmfr_tpu/pipeline/denoise.py:272 (w_out), fused by XLA",
              paths["flagship"]["launches"]["filtered_tail"],
              "flagship orbit (command)"),
        entry("G", "noisy_tail", "bmfr_tpu_torch/csrc/noisy_tail.cu",
              "bmfr_tpu/ops/reproject.py:40 + bmfr_tpu/pipeline/denoise.py:"
              "267 (w_geo, w_acc), fused by XLA",
              paths["flagship"]["launches"]["noisy_tail"],
              "flagship orbit (command)"),
        entry("H", "reproject_coords", "bmfr_tpu_torch/csrc/reproject.cu",
              "bmfr_tpu/ops/reproject.py:22, fused by XLA",
              paths["flagship"]["launches"]["reproject_coords"],
              "flagship orbit (command)"),
        entry("I", "warp_blend_planes", "bmfr_tpu_torch/csrc/warp_taps.cu",
              "bmfr_tpu/pipeline/denoise.py:115 (stack_state) + "
              "bmfr_tpu/ops/warp.py:65 (gather_taps) + the tap branches "
              "bmfr_tpu/ops/reproject.py:78, accumulate.py:32, taa.py:72, "
              "fused by XLA",
              paths["default"]["launches"]["warp_blend_planes"], "default"),
        entry("J", "build_feature_blocks",
              "bmfr_tpu_torch/csrc/feature_blocks.cu",
              "bmfr_tpu/ops/blockify.py:181, fused by XLA",
              paths["default"]["launches"]["build_feature_blocks"],
              "default"),
        entry("K", "weighted_sum", "bmfr_tpu_torch/csrc/block_reconstruct.cu",
              "bmfr_tpu/ops/weighted_sum.py:27, fused by XLA",
              paths["default"]["launches"]["weighted_sum"], "default"),
        basis_entry("B first_order float32",
                    "fit_reconstruct_cholesky (any basis)",
                    "bmfr_tpu_torch/csrc/fitter_chol_basis.cu",
                    "bmfr_tpu/ops/fitter_direct.py:512",
                    paths["flagship first_order"]["launches"][
                        "fit_reconstruct_cholesky"]),
        basis_entry("C 16 columns float32",
                    "fit_reconstruct_direct (any basis)",
                    "bmfr_tpu_torch/csrc/householder_direct_basis.cu",
                    "bmfr_tpu/ops/fitter_direct.py:255",
                    paths["householder flagship 16 columns"]["launches"][
                        "fit_reconstruct_direct"]),
    ]
    # F's TMA-fed variant ran at 1280x720 ([tail kernels]); its default
    # path's time and bound beside the flagship's
    next(k for k in kernels if k["name"] == "filtered_tail").update(
        loader="tma", default_device_ms=dev_ms["F default"],
        default_bound_ms=bounds["F default"][0])
    # G storing into the default path's TemporalState carry ([tail
    # kernels]), the compiled step's destination since the raw carry is
    # written in place
    next(k for k in kernels if k["name"] == "noisy_tail").update(
        into_device_ms=dev_ms["G into"], into_bound_ms=bounds["G into"][0])
    print(json.dumps({"paths": paths, "build_s": build_s, "basis": basis,
                      "kernel_device_ms": dev_ms,
                      "fit_blocks_direct_ms": ms["C blocks"]}))
    print(json.dumps({"kernels": kernels}))
    print(f"[smoke] {time.perf_counter() - t_main:.1f} s, the build included")
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
