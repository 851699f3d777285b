"""Fidelity harness — PSNR/SSIM sweeps across scenes and configurations.

Port of :mod:`bmfr_tpu.fidelity` (BASELINE config 3): a matrix of
configurations (solver, storage precision, warp mode, stage bypasses)
over a set of scenes, each scored against the scene's clean reference
(and the OpenCL implementation's own outputs, where a scene ships them),
printed as a table and written as JSON. Each scene is uploaded once;
each configuration runs :func:`~bmfr_tpu_torch.pipeline.denoise.
denoise_sequence` (frame 0 eagerly, then the compiled step on a card)
and is scored on the device, so only a row's numbers reach the host.
The noisy input's PSNR is scored on the host with numpy, as the JAX
harness scores it.

Usage:
    python -m bmfr_tpu_torch.fidelity --synthetic --frames 8 --width 128 --height 96
    python -m bmfr_tpu_torch.fidelity --scenes-root /data/bmfr  # TUNI layout
    python -m bmfr_tpu_torch.fidelity --synthetic --device cpu   # plain versions
"""

from __future__ import annotations

import argparse
import json
import subprocess

import numpy as np
import torch

from .cli import device_arg, resolve_device
from .config import BMFRConfig, check_supported
from .metrics import psnr, psnr_frames, ssim_frames
from .pipeline.denoise import denoise_sequence, frame_inputs_from_numpy
from .pipeline.graph import compiled_step

_PLANES = ("normals", "positions", "noisy", "albedo")


def default_config_matrix(base: BMFRConfig):
    """The standard sweep axes (the JAX harness's eleven)."""
    return {
        "default": base,
        "cholesky": base.replace(solver="cholesky"),
        "tmp_f16": base.replace(tmp_data_dtype="float16"),
        "warp_packed": base.replace(warp_mode="packed_x_bf16"),
        "warp_pallas": base.replace(warp_mode="pallas"),
        "flagship": base.replace(warp_mode="pallas",
                                 fitter_impl="pallas_direct",
                                 residual_dtype="bfloat16"),
        # the JAX bench's headline: the flagship datapath with the fused
        # Gram/Cholesky solver — the same least-squares contract as
        # Householder (opencl/bmfr.cl:549-699 is the means, the LS
        # solution is the contract)
        "flagship_cholesky": base.replace(warp_mode="pallas",
                                          fitter_impl="pallas_direct",
                                          solver="cholesky",
                                          residual_dtype="bfloat16"),
        # the flagship with an f32 residual: isolates the residual_dtype
        # choice at the flagship operating point
        "flagship_f32res": base.replace(warp_mode="pallas",
                                        fitter_impl="pallas_direct"),
        "residual_bf16": base.replace(residual_dtype="bfloat16"),
        "no_taa": base.replace(skip_taa=True),
        "first_order": base.replace(
            features_scaled=("world_position_x", "world_position_y",
                             "world_position_z")),
    }


def upload_scene(scene, device):
    """The scene's four planes as channels-first :class:`FrameInputs`,
    its camera matrices and its pixel offsets, on ``device`` (made once
    per scene, run by every configuration)."""
    inputs = frame_inputs_from_numpy(*(scene[k] for k in _PLANES), device)
    return (inputs, torch.as_tensor(scene["camera_matrices"], device=device),
            torch.as_tensor(scene["pixel_offsets"], device=device))


def run_scene(cfg, uploaded):
    """Run the full pipeline on one scene from :func:`upload_scene`;
    returns the tone-mapped output, f32 ``[T, H, W, 3]`` in [0, 1] (the
    comparison domain), on the scene's device."""
    return denoise_sequence(cfg, *uploaded).permute(0, 2, 3, 1)


def _series_metrics(out, ref, prefix=""):
    """PSNR (mean, first, last) and mean SSIM of a ``[T, H, W, 3]``
    series against its reference, scored on their device."""
    p, s = psnr_frames(out, ref), ssim_frames(out, ref)
    vals = torch.stack([p.mean(), p[0], p[-1], s.mean()]).tolist()
    return dict(zip((f"{prefix}psnr_mean", f"{prefix}psnr_first",
                     f"{prefix}psnr_last", f"{prefix}ssim_mean"), vals))


def evaluate_scene(cfg, uploaded, clean_tone, opencl=None):
    """Metrics of one config on one scene from :func:`upload_scene`: vs
    the tone-mapped clean reference, and (when present) vs the OpenCL
    implementation's own output PNGs — the BASELINE "within 0.1 dB of the
    OpenCL reference" axis. The references are ``[T, H, W, 3]`` tensors
    on the scene's device."""
    out = run_scene(cfg, uploaded)
    m = _series_metrics(out, clean_tone) if clean_tone is not None else {}
    if opencl is not None:
        m.update(_series_metrics(out, opencl, prefix="opencl_"))
    return m


def _scene_cfg(base_cfg, scene):
    """Per-scene config: geometry + the scene's own reprojection discard
    thresholds (the reference bakes them per scene,
    opencl/bmfr.cpp:226-227)."""
    c = base_cfg.replace(
        image_width=scene["noisy"].shape[2],
        image_height=scene["noisy"].shape[1])
    if "position_limit_squared" in scene:
        c = c.replace(
            position_limit_squared=float(scene["position_limit_squared"]),
            normal_limit_squared=float(scene["normal_limit_squared"]))
    return c


def _tone(a):
    """Gamma 1/2.2 and clamp, as K4 tone-maps (opencl/bmfr.cl:852-856)."""
    return np.clip(np.power(np.maximum(0.0, a), 0.454545), 0, 1)


def run_sweep(scenes, base_cfg, configs=None, device="cuda"):
    """scenes: dict name -> scene data dict with a 'clean' (and optionally
    'clean_aa' / 'opencl') reference. Scenes without any reference are
    reported as skipped rows. Returns list of report rows.

    Each configuration's compiled step is released after its row, so
    the sweep holds one configuration's graph at a time."""
    device = torch.device(device)
    rows = []
    for sname, scene in scenes.items():
        scfg = _scene_cfg(base_cfg, scene)
        sweep = configs or default_config_matrix(scfg)
        # prefer the supersampled reference when available — TAA output is
        # antialiased, so comparing against an aliased render understates it
        clean = scene.get("clean_aa", scene.get("clean"))
        opencl = scene.get("opencl")
        if clean is None and opencl is None:
            rows.append(dict(scene=sname, config="-", skipped=True,
                             note="no clean/opencl reference on disk"))
            continue
        clean_tone = base_p = None
        if clean is not None:
            clean_tone = _tone(clean)
            noisy_tone = _tone(scene["albedo"] * scene["noisy"])
            base_p = float(np.mean(
                [psnr(noisy_tone[t], clean_tone[t])
                 for t in range(clean_tone.shape[0])]))
            clean_tone = torch.as_tensor(clean_tone, device=device)
        if opencl is not None:
            opencl = torch.as_tensor(opencl, device=device)
        uploaded = upload_scene(scene, device)
        for cname, cfg in sweep.items():
            m = evaluate_scene(check_supported(cfg), uploaded, clean_tone,
                               opencl)
            compiled_step.cache_clear()
            rows.append(dict(scene=sname, config=cname,
                             noisy_psnr=base_p, **m))
    return rows


def print_report(rows):
    hdr = (f"{'scene':<14}{'config':<18}{'noisy dB':>9}{'PSNR dB':>9}"
           f"{'first':>8}{'last':>8}{'SSIM':>8}{'vs-OCL dB':>10}")
    print(hdr)
    print("-" * len(hdr))

    def fmt(r, key, width, prec):
        v = r.get(key)
        return f"{v:>{width}.{prec}f}" if v is not None else " " * width

    for r in rows:
        if r.get("skipped"):
            print(f"{r['scene']:<14}{'(skipped)':<18}{r['note']}")
            continue
        print(f"{r['scene']:<14}{r['config']:<18}"
              + fmt(r, "noisy_psnr", 9, 2) + fmt(r, "psnr_mean", 9, 2)
              + fmt(r, "psnr_first", 8, 2) + fmt(r, "psnr_last", 8, 2)
              + fmt(r, "ssim_mean", 8, 3) + fmt(r, "opencl_psnr_mean", 10, 2))


def device_name(device):
    """``cpu``, or the card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (raises when it cannot read them)."""
    if device.type != "cuda":
        return "cpu"
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "-i", str(device.index or 0)],
        capture_output=True, text=True, timeout=60, check=True)
    return proc.stdout.strip().splitlines()[0]


def synthetic_scenes(width, height, frames):
    """The four synthetic scenes of the sweep (the JAX harness's seeds),
    each with its 8-sample antialiased clean render."""
    from .io.fixtures import synthetic_sequence

    return {name: synthetic_sequence(width=width, height=height,
                                     frames=frames, seed=seed, aa_samples=8,
                                     scene=sctype)
            for seed, sctype, name in [(0, "orbit", "orbit-a"),
                                       (7, "orbit", "orbit-b"),
                                       (3, "corridor", "corridor"),
                                       (5, "swing", "swing")]}


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--synthetic", action="store_true")
    p.add_argument("--scenes-root")
    p.add_argument("--width", type=int, default=128)
    p.add_argument("--height", type=int, default=96)
    p.add_argument("--frames", type=int, default=8)
    p.add_argument("--json-out")
    p.add_argument("--device", type=device_arg, default=0,
                   help="card index or 'cpu'")
    args = p.parse_args(argv)
    device = resolve_device(args.device)
    if device is None:
        return 1

    scenes = {}
    if args.scenes_root:
        from .io.dataset import discover_scenes

        frames = list(range(args.frames)) if args.frames else None
        for sd in discover_scenes(args.scenes_root):
            data = sd.load_frames(frames=frames)
            # 4096-spp clean EXRs and/or the OpenCL implementation's output
            # PNGs, whichever the mirror ships (README.md:10-12); scenes
            # with neither are reported as skipped by run_sweep.
            data.update(sd.load_references(frames=frames))
            scenes[sd.path.rstrip("/").split("/")[-1]] = data
    else:
        scenes = synthetic_scenes(args.width, args.height, args.frames)

    base = BMFRConfig(
        image_width=args.width, image_height=args.height,
        position_limit_squared=0.03, normal_limit_squared=0.5)
    rows = run_sweep(scenes, base, device=device)
    print_report(rows)
    if args.json_out:
        # the capture conditions, so the record describes itself (a CPU
        # small-size sweep must not read as the card's full-size record)
        meta = dict(width=args.width, height=args.height,
                    frames=args.frames, device=device_name(device))
        with open(args.json_out, "w") as f:
            json.dump({"meta": meta, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
