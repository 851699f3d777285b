"""Chunked streaming of scenes from disk, ingest overlapped with compute.

Port of :mod:`bmfr_tpu.pipeline.streaming` (BASELINE config 5). The
reference loads all 60 frames before its first kernel
(opencl/bmfr.cpp:252-313); here a scene is denoised in chunks of frames
while a loader thread reads the next chunk:

- the loader thread decodes chunk k+1 through the native threaded loader
  (which releases the interpreter lock) straight into pinned host memory,
  uploads it with ``non_blocking=True`` on a copy stream of its own,
  turns it channels-first on that stream and records an event;
- the compute stream waits on that event and runs chunk k+1 frame by
  frame through :func:`~bmfr_tpu_torch.pipeline.denoise.step_frames`,
  each frame after the first a replay of the compiled step
  (:func:`make_chunk_runner`), carrying a
  :class:`~bmfr_tpu_torch.pipeline.state.TemporalState` across chunks,
  as the JAX package does, whatever the configuration (the fused warp
  reads it through bf16 taps, kernel I, and kernels G and F write the
  compiled step's carry in place);
- ``record_stream`` keeps the caching allocator from handing an uploaded
  tensor to other work while the compute stream still reads it;
- each chunk's results go back into one pinned host buffer on the compute
  stream.

The reference's one-frame camera lag (frame N is reprojected with the
matrix of frame N-1, opencl/bmfr.cpp:440-444, :class:`~bmfr_tpu_torch.
pipeline.denoise.PreviousCameras`) holds across chunk boundaries, so a
streamed scene equals :func:`~bmfr_tpu_torch.pipeline.
denoise.denoise_sequence` of the same frames bit for bit.

:func:`stream_scenes` streams several scenes at once, one thread each,
round-robin over the cards, each scene with its own stream pair and its
own reprojection limits. On ``device="cpu"`` the same logic runs without
streams or pinned memory.
"""

from __future__ import annotations

import contextlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .denoise import FrameInputs, PreviousCameras, step_frames
from .graph import CompiledStep
from .state import TemporalState

_BUFFERS = FrameInputs._fields        # normals, positions, noisy, albedo


def _chunk_ranges(total, chunk):
    return [(s, min(s + chunk, total)) for s in range(0, total, chunk)]


def resolve_device(device):
    """``device`` as a torch device; None is the first card. Raises for a
    card when there is none (no silent CPU fallback) and for any device
    other than the CPU or a card."""
    dev = torch.device("cuda:0" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


@contextlib.contextmanager
def on_device(dev, stream=None):
    """Make ``dev`` and ``stream`` (None: the card's current stream)
    current in this thread (nothing on the CPU): the kernels launch on
    the current stream of the current device."""
    if dev.type != "cuda":
        yield
        return
    with torch.cuda.device(dev), torch.cuda.stream(stream):
        yield


def make_chunk_runner(cfg):
    """A chunk runner ``(state, inputs, cams_ext, offs, t0) -> (state,
    results)`` with ``cfg`` bound, reused across chunks (the counterpart
    of the JAX package's jitted chunk scan): ``inputs`` a
    :class:`FrameInputs` of ``[T, 3, H, W]``, ``cams_ext[i]`` the matrix
    of frame ``t0 + i - 1`` (the camera lag), ``offs`` f32 ``[T, 2]``,
    ``t0`` the host frame number of the chunk's first frame; ``results``
    f32 ``[T, 3, H, W]``. The state type is carried through
    (:func:`~bmfr_tpu_torch.pipeline.denoise.denoise_frame`). The frames
    go through :func:`~bmfr_tpu_torch.pipeline.denoise.step_frames` and
    the runner's step object (:class:`~bmfr_tpu_torch.pipeline.graph.
    CompiledStep`): on a card every frame after frame 0 replays its
    compiled step (donated carry: the returned state is the runner's own,
    and a runner serves one scene at a time)."""
    H, W = cfg.image_height, cfg.image_width
    step = CompiledStep(cfg)

    def run_chunk(state, inputs, cams_ext, offs, t0):
        results = torch.empty((inputs.noisy.shape[0], 3, H, W),
                              dtype=torch.float32, device=inputs.noisy.device)
        (state,) = step_frames(step, [state],
                               FrameInputs(*(x[None] for x in inputs)),
                               [cams_ext], offs[None], t0,
                               {"result": results[None]})
        return state, results

    return run_chunk


def _upload(a, dev):
    """A host array on ``dev``, from pinned memory without blocking on a
    card (an array not in pinned memory is pinned first)."""
    t = torch.from_numpy(np.ascontiguousarray(a, np.float32))
    if dev.type == "cuda" and not t.is_pinned():
        t = t.pin_memory()
    return t.to(dev, non_blocking=True)


def stream_scene(cfg, scene=None, chunk_frames=10, device=None, loader=None,
                 frame_count=None, runner=None, timings=None):
    """Denoise one scene in chunks of ``chunk_frames`` frames, the next
    chunk read while this one runs.

    Pass a :class:`~bmfr_tpu_torch.io.dataset.SceneDescriptor`
    (``scene``, read from disk into pinned memory) or a ``loader(frames)
    -> dict`` of the standard keys (``normals``/``positions``/``noisy``/
    ``albedo`` channels-last ``[T, H, W, 3]``, ``camera_matrices``,
    ``pixel_offsets``) with ``frame_count``. ``device``: a card (default
    the first; raises without one) or ``"cpu"``. ``runner``: a
    :func:`make_chunk_runner` of ``cfg`` to reuse. ``timings``: a dict
    that receives, per chunk, ``ingest_s`` (the loader thread: decode and
    upload), ``decode_s`` (its decode alone) and ``compute_ms`` (the
    chunk's work on the compute stream, CUDA events; the host clock on
    the CPU).

    Returns the TAA results, a numpy f32 ``[T, 3, H, W]``.
    """
    if chunk_frames < 1:
        raise ValueError(f"chunk_frames must be >= 1, got {chunk_frames}")
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    T = frame_count if frame_count is not None else scene.frame_count
    H, W = cfg.image_height, cfg.image_width
    run_chunk = runner or make_chunk_runner(cfg)
    if cuda:
        compute, copy = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
    else:
        compute = copy = None

    def fetch(rng):
        t0 = time.perf_counter()
        frames = list(range(*rng))
        if loader is not None:
            data = loader(frames)
        elif cuda:
            host = torch.empty((4, len(frames), H, W, 3),
                               dtype=torch.float32, pin_memory=True)
            data = scene.load_frames(frames=frames, out=host.numpy())
        else:
            data = scene.load_frames(frames=frames)
        decode_s = time.perf_counter() - t0
        with on_device(dev, copy):
            # channels-first on the copy stream: the host only decodes
            up = [_upload(data[k], dev).permute(0, 3, 1, 2).contiguous()
                  for k in _BUFFERS]
            up += [_upload(data[k], dev)
                   for k in ("camera_matrices", "pixel_offsets")]
            ready = None
            if cuda:
                for t in up:
                    t.record_stream(compute)
                ready = torch.cuda.Event()
                ready.record(copy)
                # the upload has read the pinned buffer before the
                # buffer is freed (a view of it carries no event)
                ready.synchronize()
        return (FrameInputs(*up[:4]), up[4], up[5], ready,
                (decode_s, time.perf_counter() - t0))

    ranges = _chunk_ranges(T, chunk_frames)
    events = []
    with ThreadPoolExecutor(max_workers=1) as ex, on_device(dev, compute):
        out = torch.empty((T, 3, H, W), dtype=torch.float32,
                          pin_memory=cuda)
        state = TemporalState.initial(cfg, dev)
        last_cam = None
        pending = ex.submit(fetch, ranges[0]) if ranges else None
        for idx, (s, e) in enumerate(ranges):
            inputs, cams, offs, ready, ingest = pending.result()
            if idx + 1 < len(ranges):
                pending = ex.submit(fetch, ranges[idx + 1])
            if cuda:
                compute.wait_event(ready)
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record(compute)
            else:
                start = time.perf_counter()
            state, res = run_chunk(state, inputs,
                                   PreviousCameras(cams, last_cam), offs, s)
            last_cam = cams[-1]
            out[s:e].copy_(res, non_blocking=True)
            if cuda:
                end.record(compute)
                events.append((ingest, start, end))
            else:
                events.append((ingest, start, time.perf_counter()))
        if cuda:
            compute.synchronize()
    if timings is not None:
        for (decode_s, ingest_s), start, end in events:
            timings.setdefault("decode_s", []).append(decode_s)
            timings.setdefault("ingest_s", []).append(ingest_s)
            timings.setdefault("compute_ms", []).append(
                start.elapsed_time(end) if cuda else (end - start) * 1e3)
    return out.numpy()


def stream_scenes(cfg, scenes, chunk_frames=10, devices=None,
                  per_scene_limits=True):
    """Stream several scenes at once, one thread per scene, each on its
    own streams, round-robin over ``devices`` (default every visible
    card; raises without one; ``["cpu"]`` runs on the CPU). Returns the
    list of per-scene results.

    Each scene runs at its own size and, with ``per_scene_limits``, with
    its own position and normal discard limits from its
    ``camera_matrices.h``: the reference bakes them per scene at compile
    time (opencl/bmfr.cpp:226-227). Each scene has its own runner: a
    runner's compiled step carries one scene's state.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass devices=['cpu'] to run "
                               "on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]

    def scene_cfg(sd):
        c = cfg
        if getattr(sd, "width", None) and getattr(sd, "height", None):
            c = c.replace(image_width=sd.width, image_height=sd.height)
        if per_scene_limits and hasattr(sd, "load_camera"):
            cam = sd.load_camera()
            if "position_limit_squared" in cam:
                c = c.replace(
                    position_limit_squared=cam["position_limit_squared"],
                    normal_limit_squared=cam["normal_limit_squared"])
        return c.validate()

    cfgs = [scene_cfg(sd) for sd in scenes]

    def work(i):
        return stream_scene(
            cfgs[i], scenes[i], chunk_frames=chunk_frames,
            device=devices[i % len(devices)])

    with ThreadPoolExecutor(max_workers=max(len(scenes), 1)) as ex:
        return list(ex.map(work, range(len(scenes))))
