"""Chip smoke test of the PyTorch/CUDA port (bmfr_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds the five CUDA kernels from ``bmfr_tpu_torch/csrc/`` with nvcc
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
compiled step: launch counts, bit-equal to ``denoise_sequence``),
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
(``bmfr_tpu_torch/parity.py``). The last line is
the JSON contract ``{"ok": true, "device": {...}}``; any failed check
exits non-zero before it. Without a CUDA device it exits non-zero at
once.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch.io import native
from bmfr_tpu_torch.io.dataset import discover_scenes
from bmfr_tpu_torch.io.export import export_scene, write_camera_header
from bmfr_tpu_torch import parity
from bmfr_tpu_torch.fidelity import (device_name, print_report, run_sweep,
                                     synthetic_scenes)
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.metrics import psnr
from bmfr_tpu_torch.ops import _lib
from bmfr_tpu_torch.ops.blockify import STORAGE_DTYPES, build_feature_blocks
from bmfr_tpu_torch.ops.fitter import scale_blocks, storage_roundtrip
from bmfr_tpu_torch.ops.fitter_direct import (
    fit_blocks_direct, fit_blocks_direct_reference, fit_reconstruct_cholesky,
    fit_reconstruct_cholesky_reference, fit_reconstruct_direct,
    fit_reconstruct_direct_reference)
from bmfr_tpu_torch.ops.fitter_pallas import (fit_blocks_pallas,
                                              fit_blocks_pallas_reference)
from bmfr_tpu_torch.ops.gather import floor_int
from bmfr_tpu_torch.ops.reproject import reproject_coords
from bmfr_tpu_torch.ops.warp import (gather_taps, pack_pairs_bf16,
                                     pack_x_pairs_bf16, warp_rows,
                                     warp_rows_reference)
from bmfr_tpu_torch.ops.warp_blend import warp_blend, warp_blend_reference
from bmfr_tpu_torch.pipeline.graph import CompiledStep
from bmfr_tpu_torch.profile_stages import steady_setup, trace_report
from bmfr_tpu_torch.profiling import device_events
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
#: with the plain Cholesky solve, as JAX's falls back to XLA)
SWEEP_KERNELS = {
    "default": "D", "cholesky": "", "tmp_f16": "D", "warp_packed": "D",
    "warp_pallas": "AD", "flagship": "AC", "flagship_cholesky": "AB",
    "flagship_f32res": "AC", "residual_bf16": "D", "no_taa": "D",
    "first_order": "D"}
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
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = device_events(prof.events())
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
    ``kernel`` (torch.profiler), or None when no device event was
    recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in device_events(prof.events())
          if kernel in e.name]
    return sum(us) / calls / 1e3 if us else None


def kernels_launched(fn):
    """Device kernels one call of ``fn`` launches (torch.profiler), or
    None when no device event was recorded."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    n = len(device_events(prof.events()))
    return n or None


def lstsq_yardstick(cfg, tmp, w_kernel, frame):
    """Time ``torch.linalg.lstsq`` on the rescaled, noised f32 system that
    kernel D fits (A ``[n_blocks, bp, F]``, b ``[n_blocks, bp, 3]``), the
    one PyTorch call that computes the same least-squares weights. Returns
    (ms per call, relative norm of its weights from the kernel's)."""
    F = cfg.feature_count
    data, _ = scale_blocks(cfg, tmp.float())
    data = storage_roundtrip(cfg, data)
    noise = feature_noise(frame, F, cfg.block_pixels, cfg.buffer_count,
                          cfg.noise_amount, tmp.device)
    A = (data[:, :F] + noise[None]).transpose(1, 2).contiguous()
    b = data[:, F:].transpose(1, 2).contiguous()
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
    err_mm = float((mm - mmr).abs().max())
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


def eager_sequence(cfg, inputs, cams, offs):
    """The scene through the eager ``denoise_frame``, frame by frame: the
    reference the compiled frames are held to bit for bit."""
    st, out = bt.zero_state(cfg, inputs.noisy.device), []
    for t in range(FRAMES):
        st, o = bt.denoise_frame(cfg, st, frame_of(inputs, t),
                                 cams[max(t - 1, 0)], offs[t], t)
        out.append(o["result"])
    return torch.stack(out)


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
    frames eager and compiled. Returns the path's record."""
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
            ("flagship", flagship,
             {"warp_blend": warp_blend,
              "fit_reconstruct_cholesky": fit_reconstruct_cholesky},
             {"warp_blend": FRAMES - 1, "fit_reconstruct_cholesky": FRAMES}),
            ("default", exact,
             {"fit_blocks_pallas": fit_blocks_pallas, "warp_rows": warp_rows},
             {"fit_blocks_pallas": FRAMES, "warp_rows": 0})):
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


def sweep_counters():
    """The launch counters of the kernels the sweep's configurations
    reach, by letter."""
    return {"A": warp_blend, "B": fit_reconstruct_cholesky,
            "C": fit_reconstruct_direct, "D": fit_blocks_pallas,
            "E": warp_rows}


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
            for k in kernels:
                expected[k] += T - 1 if k == "A" else T
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
                ("default", cfg, dict(D=ORACLE_T)),
                ("flagship", cfg.replace(**bt.FLAGSHIP),
                 dict(A=ORACLE_T - 1, B=ORACLE_T))):
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


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke FAIL: no CUDA device")
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

    # ---- the three paths ----
    paths = {}
    paths["flagship"] = run_path(
        "flagship", flagship, sc, inputs, cams, offs,
        {"warp_blend": warp_blend,
         "fit_reconstruct_cholesky": fit_reconstruct_cholesky},
        {"warp_blend": FRAMES - 1, "fit_reconstruct_cholesky": FRAMES})
    paths["default"] = run_path(
        "default", exact, sc, inputs, cams, offs,
        {"fit_blocks_pallas": fit_blocks_pallas, "warp_rows": warp_rows},
        {"fit_blocks_pallas": FRAMES, "warp_rows": 0})
    paths["householder_flagship"] = run_path(
        "householder_flagship", hh_flagship, sc, inputs, cams, offs,
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

    no_library = {
        "A": "none: no single call computes the clipped 4-tap blend of the "
             "packed state",
        "B": "none: no single call computes the Gram sums, the Cholesky "
             "solve and the reconstruction",
        "E": "none: no single call computes the two clipped row loads"}

    def entry(key, name, source, replaces, launches):
        b_ms, by = bounds[key]
        lib = library_ms if key in ("C", "D") else None
        return dict(name=name, route="cuda", source=source, replaces=replaces,
                    launches=launches, max_abs_err=errs[key], ms=ms[key][0],
                    plain_ms=ms[key][1], bound_ms=b_ms, bound_by=by,
                    library_ms=lib, device_ms=dev_ms[key],
                    library=("torch.linalg.lstsq" if lib is not None
                             else no_library[key]))

    kernels = [
        entry("A", "warp_blend", "bmfr_tpu_torch/csrc/warp_blend.cu",
              "bmfr_tpu/ops/warp_pallas.py:745",
              paths["flagship"]["launches"]["warp_blend"]),
        entry("B", "fit_reconstruct_cholesky",
              "bmfr_tpu_torch/csrc/fitter_chol.cu",
              "bmfr_tpu/ops/fitter_direct.py:512",
              paths["flagship"]["launches"]["fit_reconstruct_cholesky"]),
        entry("C", "fit_reconstruct_direct",
              "bmfr_tpu_torch/csrc/householder_direct.cu",
              "bmfr_tpu/ops/fitter_direct.py:255",
              paths["householder_flagship"]["launches"][
                  "fit_reconstruct_direct"]),
        entry("D", "fit_blocks_pallas",
              "bmfr_tpu_torch/csrc/householder_blocks.cu",
              "bmfr_tpu/ops/fitter_pallas.py:92",
              paths["default"]["launches"]["fit_blocks_pallas"]),
        entry("E", "warp_rows", "bmfr_tpu_torch/csrc/warp_rows.cu",
              "bmfr_tpu/ops/warp_pallas.py:276", e_launches),
    ]
    print(json.dumps({"paths": paths, "build_s": build_s,
                      "kernel_device_ms": dev_ms,
                      "fit_blocks_direct_ms": ms["C blocks"]}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
