"""Scene-parallel denoising: a batch of scenes split over devices.

Port of :mod:`bmfr_tpu.parallel.sharding`. The JAX package's one
scale-out axis is data parallelism over scenes (SURVEY.md §2.4): each
chip runs the frame-serial recurrence of its scenes, ``jax.vmap`` over
them inside its ``lax.scan``, under a ``shard_map`` over a 1-D mesh with
the scene axis sharded. The recurrence needs no collective; reading the
result gathers it.

Here the mesh is an ordered tuple of devices (:func:`make_scene_mesh`),
and scene ``s`` of ``S`` runs on ``mesh[s // (S // n)]``: contiguous
shards, ``P("scenes")``. A card's scenes advance frame by frame through
:func:`~bmfr_tpu_torch.pipeline.denoise.step_frames`, the loop of
:func:`~bmfr_tpu_torch.pipeline.denoise.denoise_sequence`, and one step
object (:meth:`~bmfr_tpu_torch.pipeline.graph.CompiledStep.run_scenes`):
frame 0 eagerly, then one CUDA graph per frame that holds the card's
per-scene steps back to back, each scene with its own static buffers and
carry (the counterpart of the ``vmap``). On the CPU every frame runs
eagerly. The same kernels run
on the same inputs in the same order as the per-scene
``denoise_sequence``, so the result equals it bit for bit (JAX holds its
two programs to 1e-5 only because they fuse differently).

Several cards run one host thread each, on the card's current stream
(captures are serialised, ``pipeline/graph.py``). A mesh may name one
card more than once: each place has a compiled step of its own, and the
card's thread runs its places one after another (two host threads on
one card's default stream once diverged from the per-scene runs in a
test session; one thread a card never has). The result is gathered on
``mesh[0]``.
"""

from __future__ import annotations

import functools
import threading
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import check_supported
from ..pipeline.denoise import (FrameInputs, PreviousCameras, step_frames,
                                zero_state)
from ..pipeline.graph import CompiledStep
from ..pipeline.streaming import on_device, resolve_device


def make_scene_mesh(devices=None):
    """The ordered tuple of devices the scenes are split over: by default
    every visible card (raises without one: there is no CPU fallback);
    or ``devices`` as given, repeats included (``["cpu"] * 4``,
    ``[cuda:0] * 2``)."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass the devices (e.g. "
                               "['cpu'] * 4) to split scenes on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    mesh = tuple(resolve_device(d) for d in devices)
    if not mesh:
        raise ValueError("a scene mesh needs at least one device")
    return mesh


class _SceneRunner:
    """The scene-parallel run of ``cfg`` over ``mesh``, with one compiled
    step per place of the mesh (kept across calls)."""

    def __init__(self, cfg, mesh):
        self.cfg = check_supported(cfg)
        self.mesh = make_scene_mesh(mesh)
        self.steps = [CompiledStep(cfg) for _ in self.mesh]

    def _check(self, inputs, camera_matrices, pixel_offsets):
        H, W = self.cfg.image_height, self.cfg.image_width
        S, T = inputs.noisy.shape[:2]
        for name, x in zip(FrameInputs._fields, inputs):
            if tuple(x.shape) != (S, T, 3, H, W):
                raise ValueError(f"{name}: expected [S, T, 3, {H}, {W}] = "
                                 f"{(S, T, 3, H, W)}, got {tuple(x.shape)}")
        for name, x, tail in (("camera_matrices", camera_matrices, (4, 4)),
                              ("pixel_offsets", pixel_offsets, (2,))):
            if tuple(x.shape) != (S, T) + tail:
                raise ValueError(f"{name}: expected {(S, T) + tail}, got "
                                 f"{tuple(x.shape)}")
        n = len(self.mesh)
        if S % n:
            raise ValueError(f"{S} scenes do not split evenly over a mesh "
                             f"of {n} devices")
        return S, T, S // n

    def _shard(self, i, per, inputs, cams, offs):
        """Scenes ``i * per ..`` on ``mesh[i]``, frame by frame; returns
        their results ``[per, T, 3, H, W]`` there."""
        dev, cfg = self.mesh[i], self.cfg
        sl = slice(i * per, (i + 1) * per)
        with on_device(dev):
            xs = FrameInputs(*(x[sl].to(dev) for x in inputs))
            cams, offs = cams[sl].to(dev), offs[sl].to(dev)
            results = torch.empty((per, xs.noisy.shape[1], 3,
                                   cfg.image_height, cfg.image_width),
                                  dtype=torch.float32, device=dev)
            step_frames(self.steps[i],
                        [zero_state(cfg, dev) for _ in range(per)], xs,
                        [PreviousCameras(c) for c in cams], offs, 0,
                        {"result": results})
        return results

    def __call__(self, inputs, camera_matrices, pixel_offsets):
        _, _, per = self._check(inputs, camera_matrices, pixel_offsets)
        cards = {}      # each device's places, in mesh order
        for i, d in enumerate(self.mesh):
            cards.setdefault(d, []).append(i)

        def run(places):
            return [(i, self._shard(i, per, inputs, camera_matrices,
                                    pixel_offsets)) for i in places]

        if len(cards) > 1 and any(d.type == "cuda" for d in cards):
            with ThreadPoolExecutor(max_workers=len(cards)) as ex:
                done = list(ex.map(run, cards.values()))
        else:
            done = [run(places) for places in cards.values()]
        parts = dict(kv for card in done for kv in card)
        home = self.mesh[0]
        with on_device(home):
            return torch.cat([parts[i].to(home)
                              for i in range(len(self.mesh))])


@functools.lru_cache(maxsize=None)
def _cached_runner(cfg, mesh, thread):
    return _SceneRunner(cfg, mesh)


def denoise_scenes_sharded(cfg, mesh, inputs: FrameInputs, camera_matrices,
                           pixel_offsets):
    """Denoise a batch of scenes split over ``mesh``
    (:func:`make_scene_mesh`).

    ``inputs``: :class:`~bmfr_tpu_torch.pipeline.denoise.FrameInputs` of
    ``[S, T, 3, H, W]`` (S scenes, T frames); ``camera_matrices`` f32
    ``[S, T, 4, 4]``; ``pixel_offsets`` f32 ``[S, T, 2]``. ``S`` must be
    divisible by the mesh size (else ``ValueError``, as ``shard_map``
    raises). Returns the TAA results ``f32[S, T, 3, H, W]`` on ``mesh[0]``,
    each scene equal bit for bit to its own ``denoise_sequence``. The
    compiled steps are kept for later calls with the same ``cfg`` and mesh
    from the same thread (``denoise_scenes_sharded.cache_clear()`` frees
    them).
    """
    return _cached_runner(cfg, make_scene_mesh(mesh),
                          threading.get_ident())(inputs, camera_matrices,
                                                 pixel_offsets)


denoise_scenes_sharded.cache_clear = _cached_runner.cache_clear


def denoise_scenes_jit(cfg, mesh):
    """A runner ``(inputs, camera_matrices, pixel_offsets) -> results``
    of :func:`denoise_scenes_sharded` with ``cfg`` and ``mesh`` bound,
    which keeps its compiled steps across calls (the JAX package's jitted
    entry, ``sharding.py:80-86``). One call at a time."""
    return _SceneRunner(cfg, mesh)
