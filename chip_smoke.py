"""Chip smoke test of the PyTorch/CUDA port (bmfr_tpu_torch) on one GPU.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

It builds both CUDA kernels from ``bmfr_tpu_torch/csrc/`` with nvcc,
holds each against its plain PyTorch version at 1280x720, drives the
port's main path (``denoise_sequence``) over 16 frames of the 1280x720
orbit scene, checks that the path launched the kernels (15 warps, 16
fits), agrees with the same path on the plain versions and brings every
frame closer to the clean render than its noisy input, times the kernels
and the path with CUDA events, profiles the device time of the steady
frames by kernel, and prints as its last line the
JSON contract ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before that line. Without a CUDA device it exits non-zero at
once.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.metrics import psnr
from bmfr_tpu_torch.ops import _lib
from bmfr_tpu_torch.ops.fitter_direct import (
    fit_reconstruct_cholesky, fit_reconstruct_cholesky_reference)
from bmfr_tpu_torch.ops.gather import floor_int
from bmfr_tpu_torch.ops.reproject import reproject_coords
from bmfr_tpu_torch.ops.warp import pack_pairs_bf16
from bmfr_tpu_torch.ops.warp_blend import warp_blend, warp_blend_reference

WIDTH, HEIGHT, FRAMES = 1280, 720, 16
#: kernel A: accept plane equal on this share of pixels (flips only from
#: rounding at the limit compare); other planes to 1e-5 (rtol = atol)
ACCEPT_SHARE, WARP_TOL = 0.9999, 1e-5
#: kernel B: |err| <= 5e-3 + 5e-3 |ref| (tests/test_fitter_direct.py:146)
FIT_TOL = 5e-3
#: main path with kernels vs with plain versions, per frame
PATH_MIN_DB = 60.0


def require(cond, msg):
    if not cond:
        raise SystemExit(f"chip_smoke FAIL: {msg}")


def gpu_line():
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    require(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr}")
    return proc.stdout.strip().splitlines()[0]


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


def device_breakdown(run, frames):
    """Profile ``run()`` (``frames`` steady frames) and print device
    time by kernel, launches per frame and the device's busy share of
    the span from its first to its last kernel. Returns a dict, or None
    when the profiler recorded no device events."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kern:
        print("[profile] no device events recorded: not measured")
        return None
    by_name = {}
    for e in kern:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    busy = sum(us for _, us in by_name.values())
    span = (max(e.time_range.end for e in kern)
            - min(e.time_range.start for e in kern))
    rows = sorted(by_name.items(), key=lambda kv: -kv[1][1])
    print(f"[profile] {frames} steady frames: {len(kern) / frames:.1f} "
          f"device kernels/frame, device busy {busy / frames / 1e3:.4f} "
          f"ms/frame = {100 * busy / span:.1f}% of the kernel span "
          f"{span / frames / 1e3:.4f} ms/frame")
    for name, (n, us) in rows[:12]:
        print(f"[profile]   {us / frames / 1e3:8.4f} ms/frame "
              f"{100 * us / busy:5.1f}%  x{n / frames:4.1f}  {name[:90]}")
    return dict(kernels_per_frame=len(kern) / frames,
                busy_ms_per_frame=busy / frames / 1e3,
                span_ms_per_frame=span / frames / 1e3)


def tone_map(a):
    """Gamma 1/2.2 and clamp, as K4 tone-maps (opencl/bmfr.cl:852-856)."""
    return np.clip(np.power(np.maximum(a, 0.0), 0.454545), 0.0, 1.0)


def frame_of(inputs, t):
    return bt.FrameInputs(*(x[t] for x in inputs))


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


def check_fit(cfg, cur, accum, frame):
    """Kernel B vs its plain version at one frame. Returns max |err|."""
    got, w = fit_reconstruct_cholesky(cfg, cur.normals, cur.positions,
                                      accum, frame)
    ref, wr = fit_reconstruct_cholesky_reference(
        cfg, cur.normals, cur.positions, accum, frame)
    torch.cuda.synchronize()
    diff = (got - ref).abs()
    bad = int((diff > FIT_TOL + FIT_TOL * ref.abs()).sum())
    err = float(diff.max())
    zero = int((w == 0).all(dim=(1, 2)).sum())
    zero_ref = int((wr == 0).all(dim=(1, 2)).sum())
    print(f"[fit_reconstruct_cholesky] frame {frame}: max |err| {err:.3e}, "
          f"off-tolerance values {bad}, zero-weight blocks {zero} "
          f"(plain {zero_ref}) of {w.shape[0]}")
    require(bad == 0, f"fit frame {frame}: {bad} values off tolerance")
    require(zero == zero_ref, f"fit frame {frame}: zero-weight blocks "
            f"{zero} vs {zero_ref}")
    require(bool(torch.isfinite(got).all()), f"fit frame {frame}: "
            "non-finite")
    return err


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
    print(f"[build] nvcc sm_90a, both kernels: {build_s:.1f} s")

    # ---- scene ----
    t0 = time.perf_counter()
    sc = synthetic_sequence(width=WIDTH, height=HEIGHT, frames=FRAMES)
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], dev)
    cams = torch.from_numpy(sc["camera_matrices"]).to(dev)
    offs = torch.from_numpy(sc["pixel_offsets"]).to(dev)
    print(f"[scene] orbit {WIDTH}x{HEIGHT}x{FRAMES}: "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = bt.BMFRConfig(image_width=WIDTH, image_height=HEIGHT,
                        position_limit_squared=0.03,
                        normal_limit_squared=0.5, **bt.FLAGSHIP)

    # ---- kernel A vs plain ----
    state = bt.PackedState.initial(cfg, dev)
    state, _ = bt.denoise_frame(cfg, state, frame_of(inputs, 0), cams[0],
                                offs[0], 0)
    cur = frame_of(inputs, 1)
    pfx, pfy = reproject_coords(cfg, cur.positions, cams[0], offs[1])
    warp_err = check_warp(cfg, state, cur, pfx, pfy, "orbit frame 1")
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
    warp_err = max(warp_err, check_warp(cfg, state, cur, sx, sy,
                                        "synthetic field, real state"))
    warp_err = max(warp_err, check_warp(cfg, rstate, cur, sx, sy,
                                        "synthetic field, random state"))

    # ---- kernel B vs plain (two jitter offsets) ----
    fit_err = 0.0
    for f in (0, 5):
        c = frame_of(inputs, f)
        fit_err = max(fit_err, check_fit(cfg, c, c.noisy, f))

    # ---- the main path ----
    warp_blend.launches = 0
    fit_reconstruct_cholesky.launches = 0
    t0 = time.perf_counter()
    out = bt.denoise_sequence(cfg, inputs, cams, offs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {"warp_blend": warp_blend.launches,
                "fit_reconstruct_cholesky": fit_reconstruct_cholesky.launches}
    print(f"[path] denoise_sequence {FRAMES} frames (first run): "
          f"{first_s:.2f} s; launches {launches}")
    require(launches == {"warp_blend": FRAMES - 1,
                         "fit_reconstruct_cholesky": FRAMES},
            f"launch counts {launches}")
    require(tuple(out.shape) == (FRAMES, 3, HEIGHT, WIDTH),
            f"output shape {tuple(out.shape)}")
    require(bool(torch.isfinite(out).all()), "non-finite output")
    require(float(out.min()) >= 0.0 and float(out.max()) <= 1.0,
            "output outside [0, 1]")
    plain = bt.denoise_sequence(cfg, inputs, cams, offs, plain=True)
    out_np, plain_np = out.cpu().numpy(), plain.cpu().numpy()
    dbs = [psnr(out_np[t], plain_np[t]) for t in range(FRAMES)]
    path_err = float(np.abs(out_np - plain_np).max())
    print("[path] kernels vs plain, per-frame PSNR dB: "
          + ", ".join(f"{d:.2f}" for d in dbs)
          + f"; max |err| {path_err:.3e}")
    require(min(dbs) >= PATH_MIN_DB, f"path PSNR {min(dbs):.2f} dB")
    # fidelity as bmfr_tpu/fidelity.py measures it: tone-mapped output vs
    # the tone-mapped clean render, beside the tone-mapped noisy input
    clean = tone_map(sc["clean"])
    noisy = tone_map(sc["albedo"] * sc["noisy"])
    den_db = [psnr(np.moveaxis(out_np[t], 0, -1), clean[t])
              for t in range(FRAMES)]
    noisy_db = [psnr(noisy[t], clean[t]) for t in range(FRAMES)]
    print("[path] PSNR vs clean render, denoised: "
          + ", ".join(f"{d:.2f}" for d in den_db) + "; noisy input: "
          + ", ".join(f"{d:.2f}" for d in noisy_db))
    require(all(d > n for d, n in zip(den_db, noisy_db)),
            "a denoised frame is further from the clean render than its "
            "noisy input")

    # ---- times (CUDA events, after warm-up) ----
    warp_ms = cuda_ms(lambda: warp_blend(
        cfg, state.src8, cur.positions, cur.normals, pfx, pfy), 50)
    warp_plain_ms = cuda_ms(lambda: warp_blend_reference(
        cfg, state.src8, cur.positions, cur.normals, pfx, pfy), 10)
    c5 = frame_of(inputs, 5)
    fit_ms = cuda_ms(lambda: fit_reconstruct_cholesky(
        cfg, c5.normals, c5.positions, c5.noisy, 5), 50)
    fit_plain_ms = cuda_ms(lambda: fit_reconstruct_cholesky_reference(
        cfg, c5.normals, c5.positions, c5.noisy, 5), 5)
    print(f"[time] warp_blend {warp_ms:.4f} ms (plain {warp_plain_ms:.4f}); "
          f"fit_reconstruct_cholesky {fit_ms:.4f} ms "
          f"(plain {fit_plain_ms:.4f})")

    def steady_frames(plain_path):
        """Run frame 0 of the per-frame step; return a closure running the
        warped frames 1..15 on that state (in place) between two CUDA
        events, and the events."""
        step = bt.make_denoise_frame(cfg, plain=plain_path)
        st, _ = step(bt.PackedState.initial(cfg, dev), frame_of(inputs, 0),
                     cams[0], offs[0], 0)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)

        def run():
            start.record()
            for t in range(1, FRAMES):
                step(st, frame_of(inputs, t), cams[t - 1], offs[t], t)
            end.record()
        return run, start, end

    def steady_ms(plain_path):
        """Mean ms per warped frame, CUDA events around the host loop."""
        run, start, end = steady_frames(plain_path)
        run()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (FRAMES - 1)

    steady_ms(False)                                   # warm-up
    torch.cuda.reset_peak_memory_stats()
    path_ms = [steady_ms(False) for _ in range(3)]
    peak = torch.cuda.max_memory_allocated()
    path_plain_ms = steady_ms(True)
    print("[time] main path steady ms/frame (3 runs): "
          + ", ".join(f"{m:.4f}" for m in path_ms)
          + f"; with plain versions {path_plain_ms:.4f}; "
          f"max_memory_allocated {peak} B ({peak / 2**20:.1f} MiB)")
    profile = device_breakdown(steady_frames(False)[0], FRAMES - 1)

    kernels = [
        dict(name="warp_blend", route="cuda",
             source="bmfr_tpu_torch/csrc/warp_blend.cu",
             replaces="bmfr_tpu/ops/warp_pallas.py:745",
             launches=launches["warp_blend"], max_abs_err=warp_err,
             ms=warp_ms, plain_ms=warp_plain_ms),
        dict(name="fit_reconstruct_cholesky", route="cuda",
             source="bmfr_tpu_torch/csrc/fitter_chol.cu",
             replaces="bmfr_tpu/ops/fitter_direct.py:512",
             launches=launches["fit_reconstruct_cholesky"],
             max_abs_err=fit_err, ms=fit_ms, plain_ms=fit_plain_ms),
    ]
    print(json.dumps({"path_ms_per_frame": path_ms,
                      "path_plain_ms_per_frame": path_plain_ms,
                      "max_memory_allocated": peak, "profile": profile,
                      "build_s": build_s, "path_psnr_db": dbs,
                      "clean_psnr_db": den_db,
                      "noisy_clean_psnr_db": noisy_db}))
    print(json.dumps({"kernels": kernels}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
