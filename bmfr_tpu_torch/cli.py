"""Command-line runner of the port: scene in, denoised PNGs out.

Port of :mod:`bmfr_tpu.cli`, with its flags and behaviour: load a scene
(a TUNI scene directory or the synthetic orbit scene), run the 5-stage
chain over its frames, print the profiling report in the reference's
mean/min/max/total format (opencl/bmfr.cpp:489-517) and the PSNR against
the clean render when there is one, and write one PNG per frame:

    python -m bmfr_tpu_torch.cli --scene /data/classroom --output outputs/
    python -m bmfr_tpu_torch.cli --synthetic --frames 60 --mode stream
    python -m bmfr_tpu_torch.cli --scenes-root /data --chunk-frames 10

``--mode frame`` runs the per-frame step, ``scan`` :func:`~bmfr_tpu_torch.
pipeline.denoise.denoise_sequence` and ``stream`` the chunked streaming
of :mod:`~bmfr_tpu_torch.pipeline.streaming` (with ``--scene``, straight
from the directory, chunk by chunk); on a card each replays the compiled
step (:mod:`~bmfr_tpu_torch.pipeline.graph`) for every frame after the
first, as the JAX CLI jits both modes. ``--device`` takes a card index, as
in the JAX package, or ``cpu``: the port runs on the card unless asked
for the CPU, and a card index that is not there is an error.
"""

from __future__ import annotations

import argparse
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .config import BMFRConfig
from .io.dataset import discover_scenes, probe_scene
from .io.exr import write_png
from .io.fixtures import synthetic_sequence
from .metrics import psnr
from .pipeline.denoise import (FrameInputs, denoise_sequence,
                               frame_inputs_from_numpy, make_denoise_frame,
                               zero_state)
from .pipeline.streaming import stream_scene, stream_scenes
from .profiling import CPUTimer, ProfilingInfo, device_timer, print_report

_KEYS = ("normals", "positions", "noisy", "albedo", "camera_matrices",
         "pixel_offsets")


def _positive(text):
    n = int(text)
    if n < 1:
        raise argparse.ArgumentTypeError(f"must be >= 1, got {n}")
    return n


def _device_arg(text):
    if text == "cpu":
        return text
    try:
        index = int(text)
    except ValueError:
        raise argparse.ArgumentTypeError(
            f"a card index or 'cpu', got {text!r}") from None
    if index < 0:
        raise argparse.ArgumentTypeError(f"a card index is >= 0, got {index}")
    return index


def _build_argparser():
    p = argparse.ArgumentParser(
        description="BMFR denoiser (PyTorch/CUDA port)")
    p.add_argument("--scene", help="scene directory (TUNI layout)")
    p.add_argument("--synthetic", action="store_true",
                   help="run on the built-in synthetic scene")
    p.add_argument("--synthetic-scene", default="orbit",
                   choices=["orbit", "corridor"],
                   help="synthetic scene type (orbit: lateral flow; "
                        "corridor: forward-dolly disocclusion)")
    p.add_argument("--width", type=_positive, default=1280)
    p.add_argument("--height", type=_positive, default=720)
    p.add_argument("--frames", type=_positive, default=60)
    p.add_argument("--output", default="outputs",
                   help="output directory for PNGs")
    p.add_argument("--no-output", action="store_true")
    p.add_argument("--solver", default="householder",
                   choices=["householder", "cholesky"])
    p.add_argument("--fitter-impl", default="auto",
                   choices=["auto", "xla", "pallas", "pallas_direct"])
    p.add_argument("--tmp-dtype", default="float32",
                   choices=["float32", "float16", "bfloat16"])
    p.add_argument("--warp-mode", default="float32",
                   choices=["float32", "packed_bf16", "packed_x_bf16",
                            "pallas"])
    p.add_argument("--residual-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--block-edge", type=int, default=32)
    p.add_argument("--mode", default="frame",
                   choices=["frame", "scan", "stream"],
                   help="per-frame steps, one denoise_sequence, or chunked "
                        "streaming with overlapped ingest")
    p.add_argument("--chunk-frames", type=_positive, default=10,
                   help="frames per streaming chunk")
    p.add_argument("--scenes-root",
                   help="denoise every scene under this directory "
                        "concurrently (TUNI layout, streaming mode)")
    p.add_argument("--device", type=_device_arg, default=0,
                   help="card index (the reference's PLATFORM_INDEX/"
                        "DEVICE_INDEX, bmfr.cpp:33-34) or 'cpu'")
    p.add_argument("--skip-fitting", action="store_true")
    p.add_argument("--skip-second-accum", action="store_true")
    p.add_argument("--skip-taa", action="store_true")
    return p


def load_inputs(args):
    """``(data, limits, scene)``: the frames as channels-last arrays and
    the scene's discard limits; with ``--scene --mode stream`` no frame
    is read here (``data`` is None) and ``scene`` is the descriptor to
    stream from."""
    if args.scene:
        sd = probe_scene(args.scene)  # size and frame count from the files
        args.width, args.height = sd.width, sd.height
        sd.frame_count = min(sd.frame_count, args.frames)
        if args.mode == "stream":
            cam = sd.load_camera()
            data = None
        else:
            data = cam = sd.load_frames()
        limits = dict(position_limit_squared=cam["position_limit_squared"],
                      normal_limit_squared=cam["normal_limit_squared"])
        return data, limits, sd
    if args.synthetic_scene != "orbit":
        raise NotImplementedError(
            f"synthetic scene {args.synthetic_scene!r}: the port carries "
            "only the orbit scene; the corridor and swing fixtures are "
            "ROADMAP Queue 1 #13")
    data = synthetic_sequence(width=args.width, height=args.height,
                              frames=args.frames)
    return data, dict(position_limit_squared=0.03,
                      normal_limit_squared=0.5), None


def _write_outputs_parallel(outdir, named_frames):
    """Parallel PNG writes (the reference uses an OpenMP parallel-for,
    opencl/bmfr.cpp:521-547)."""
    os.makedirs(outdir, exist_ok=True)

    def write_one(item):
        name, chw = item
        write_png(os.path.join(outdir, name), np.moveaxis(chw, 0, -1))

    with ThreadPoolExecutor(max_workers=os.cpu_count() or 8) as ex:
        list(ex.map(write_one, named_frames))
    print(f"Wrote {len(named_frames)} PNGs to {outdir}/")


def main(argv=None):
    args = _build_argparser().parse_args(argv)
    print("Initialize.")
    if args.device == "cpu":
        device = torch.device("cpu")
    else:
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if args.device >= count:
            print(f"Device index {args.device} out of range ({count} "
                  "available; --device cpu runs on the CPU)")
            return 1
        device = torch.device("cuda", args.device)
        torch.cuda.set_device(device)
    print("Using device: " + (torch.cuda.get_device_name(device)
                              if device.type == "cuda" else "cpu"))

    def make_cfg(limits):
        return BMFRConfig(
            image_width=args.width, image_height=args.height,
            solver=args.solver, fitter_impl=args.fitter_impl,
            tmp_data_dtype=args.tmp_dtype, block_edge=args.block_edge,
            warp_mode=args.warp_mode,
            residual_dtype=args.residual_dtype,
            skip_fitting=args.skip_fitting,
            skip_second_accum=args.skip_second_accum,
            skip_taa=args.skip_taa, **limits).validate()

    if args.scenes_root:
        cfg = make_cfg(dict(position_limit_squared=0.03,
                            normal_limit_squared=0.5))
        scenes = discover_scenes(args.scenes_root)
        if not scenes:
            print(f"No scenes found under {args.scenes_root}")
            return 1
        # size and discard limits come from each scene's own files inside
        # stream_scenes (the reference bakes them per scene, bmfr.cpp:
        # 39-42, :226-227)
        devices = ([device] if device.type == "cpu" else None)
        first = scenes[0]
        print(f"Streaming {len(scenes)} scenes ({first.width}x"
              f"{first.height}, {first.frame_count} frames) concurrently on "
              + ("the CPU." if devices else
                 f"{torch.cuda.device_count()} card(s)."))
        t1 = time.perf_counter()
        outs = stream_scenes(cfg, scenes, chunk_frames=args.chunk_frames,
                             devices=devices)
        dt = time.perf_counter() - t1
        frames = sum(o.shape[0] for o in outs)
        print(f"{frames} frames in {dt:.2f}s "
              f"({dt / max(frames, 1) * 1e3:.2f} ms/frame aggregate)")
        if not args.no_output:
            _write_outputs_parallel(
                args.output,
                [(f"{os.path.basename(sd.path.rstrip('/'))}_output{t}.png",
                  res[t]) for sd, res in zip(scenes, outs)
                 for t in range(res.shape[0])])
        return 0

    print("Loading input data.")
    timer = CPUTimer().start()
    data, limits, scene = load_inputs(args)
    print(f"  loaded in {timer.stop() / 1e3:.2f}s")
    cfg = make_cfg(limits)
    T = scene.frame_count if data is None else data["noisy"].shape[0]

    print("Run and profile kernels.")
    prof = ProfilingInfo("Full frame (all 5 stages)")
    if args.mode == "stream":
        timings = {}
        loader = None if data is None else (
            lambda frames: {k: data[k][frames] for k in _KEYS})
        t1 = time.perf_counter()
        res = stream_scene(cfg, scene, chunk_frames=args.chunk_frames,
                           device=device, loader=loader, frame_count=T,
                           timings=timings)
        prof.append((time.perf_counter() - t1) * 1e3 / T)
        results = list(res)
        infos = [prof, ProfilingInfo("Stream ingest per chunk (loader)",
                                     [s * 1e3 for s in timings["ingest_s"]]),
                 ProfilingInfo("Stream compute per chunk",
                               timings["compute_ms"])]
    else:
        seq = frame_inputs_from_numpy(data["normals"], data["positions"],
                                      data["noisy"], data["albedo"], device)
        cams = torch.from_numpy(data["camera_matrices"]).to(device)
        offs = torch.from_numpy(data["pixel_offsets"]).to(device)
        if args.mode == "scan":
            denoise_sequence(cfg, seq, cams, offs)     # warm-up run
            times = []
            with device_timer(times, device):
                out = denoise_sequence(cfg, seq, cams, offs)
            prof.append(times[0] / T)
            results = list(out.cpu().numpy())
        else:
            step = make_denoise_frame(cfg)
            state = zero_state(cfg, device)
            results = []
            for t in range(T):
                times = []
                with device_timer(times, device):
                    state, result = step(
                        state, FrameInputs(*(x[t] for x in seq)),
                        cams[max(t - 1, 0)], offs[t], t)
                if t > 0:   # frame 0 runs no warp
                    prof.append(times[0])
                results.append(result.cpu().numpy())
        infos = [prof]

    print_report(infos)

    if "clean" in (data or {}):
        # compare in the output (tone-mapped) domain, like for like
        vals = []
        for t, r in enumerate(results):
            clean_tone = np.clip(
                np.power(np.maximum(0.0, data["clean"][t]), 0.454545), 0, 1)
            vals.append(psnr(np.moveaxis(r, 0, -1), clean_tone))
        print(f"PSNR vs clean reference (tone-mapped): mean "
              f"{np.mean(vals):.2f} dB "
              f"(first {vals[0]:.2f}, last {vals[-1]:.2f})")

    if not args.no_output:
        _write_outputs_parallel(
            args.output,
            [(f"output{t}.png", r) for t, r in enumerate(results)])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
