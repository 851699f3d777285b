"""The counterparts of the JAX package's driver entry points
(``__graft_entry__.py``): one full-size capturable step, and a dry run of
scene-parallel denoising held to the per-scene runs.

- :func:`entry` returns ``(fn, example_args)``: the flagship datapath with
  the Householder solver at 1280x720 (kernels A and C on a
  :class:`~bmfr_tpu_torch.pipeline.state.TemporalState`), ``fn`` the
  compiled step on a card (its first call runs the frame eagerly and
  captures it, every later call replays it) and ``denoise_frame`` on the
  CPU.
- :func:`dryrun_multichip` runs the JAX dry run's three 64x64
  configurations (XLA fitter; the flagship with Householder; the
  flagship with Cholesky and a bf16 residual) on ``n`` scenes of 2
  frames split over ``n`` devices, and holds every scene to its own
  ``denoise_sequence``.

Both draw their inputs from ``np.random.RandomState(0)`` in the JAX
package's order, so the two packages see the same numbers.
"""

from __future__ import annotations

import numpy as np
import torch

from .config import BMFRConfig
from .parallel import denoise_scenes_sharded, make_scene_mesh
from .pipeline.denoise import (FrameInputs, denoise_sequence,
                               make_denoise_frame)
from .pipeline.state import TemporalState
from .pipeline.streaming import resolve_device

#: the dry run's bar on each scene's max |diff| from its per-scene run
#: (``__graft_entry__.py:146-149``); the port's two runs are bit-equal
DRYRUN_TOL = 1e-5
LIMITS = dict(position_limit_squared=0.03, normal_limit_squared=0.5)


def entry_config():
    """:func:`entry`'s configuration: the flagship datapath (fused warp,
    direct fitter) at the default solver, Householder, 1280x720."""
    return BMFRConfig(**LIMITS, warp_mode="pallas",
                      fitter_impl="pallas_direct").validate()


def entry(device=None):
    """``(fn, example_args)``: ``fn(state, inputs, prev_cam, pixel_offset,
    frame) -> (new_state, result)`` with :func:`entry_config` bound, a
    frame with history, on the card unless ``device`` says otherwise.
    ``example_args``: the all-zero ``TemporalState``, four ``[3, 720,
    1280]`` planes of ``RandomState(0).rand`` f32 draws, the identity
    camera, offset 0.5 and frame 1 as a 0-d int32 tensor. ``result`` is
    the caller's own tensor; the returned state is the step's carry
    (donated, as :func:`~bmfr_tpu_torch.pipeline.denoise.
    make_denoise_frame` donates it)."""
    dev = resolve_device(device)
    cfg = entry_config()
    H, W = cfg.image_height, cfg.image_width
    state = TemporalState.initial(cfg, dev)
    rng = np.random.RandomState(0)

    def mk(shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(dev)

    inputs = FrameInputs(normals=mk((3, H, W)), positions=mk((3, H, W)),
                         noisy=mk((3, H, W)), albedo=mk((3, H, W)))
    prev_cam = torch.eye(4, dtype=torch.float32, device=dev)
    pixel_offset = torch.full((2,), 0.5, dtype=torch.float32, device=dev)
    frame = torch.ones((), dtype=torch.int32, device=dev)
    step = make_denoise_frame(cfg)

    def fn(state, inputs, prev_cam, pixel_offset, frame):
        return step(state, inputs, prev_cam, pixel_offset, frame,
                    history="always")

    return fn, (state, inputs, prev_cam, pixel_offset, frame)


def dryrun_configs():
    """The dry run's three configurations (``__graft_entry__.py:89-106``)."""
    base = BMFRConfig(image_width=64, image_height=64, **LIMITS)
    return (base.replace(fitter_impl="xla").validate(),
            base.replace(warp_mode="pallas",
                         fitter_impl="pallas_direct").validate(),
            base.replace(warp_mode="pallas", fitter_impl="pallas_direct",
                         solver="cholesky",
                         residual_dtype="bfloat16").validate())


def dryrun_multichip(n_devices: int, devices=None):
    """Run each of :func:`dryrun_configs` on ``n_devices`` scenes of 2
    frames split over a mesh of ``n_devices`` devices
    (:func:`~bmfr_tpu_torch.parallel.denoise_scenes_sharded`), after the
    per-scene ``denoise_sequence`` references, and raise unless the
    shape is right, the values finite and every scene within
    :data:`DRYRUN_TOL` of its reference. ``devices``: the mesh's devices (``["cpu"] * 4``, a card
    repeated); by default the first ``n_devices`` cards (raises when
    fewer are visible). Returns each configuration's largest max |diff|
    over the scenes."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < n_devices:
            raise RuntimeError(f"need {n_devices} cards, have {have}")
        devices = [torch.device("cuda", i) for i in range(n_devices)]
    if len(devices) != n_devices:
        raise ValueError(f"{len(devices)} devices for a mesh of "
                         f"{n_devices}")
    mesh = make_scene_mesh(devices)
    home = mesh[0]
    S, T = n_devices, 2
    rng = np.random.RandomState(0)

    def mk(shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32)).to(home)

    cases = []
    for cfg in dryrun_configs():
        H, W = cfg.image_height, cfg.image_width
        inputs = FrameInputs(
            normals=mk((S, T, 3, H, W)), positions=mk((S, T, 3, H, W)),
            noisy=mk((S, T, 3, H, W)), albedo=mk((S, T, 3, H, W)))
        cams = torch.eye(4, dtype=torch.float32,
                         device=home).repeat(S, T, 1, 1)
        offs = torch.full((S, T, 2), 0.5, dtype=torch.float32, device=home)
        # the per-scene references first, as the JAX dry run orders them
        refs = [denoise_sequence(cfg, FrameInputs(*(x[s] for x in inputs)),
                                 cams[s], offs[s]) for s in range(S)]
        cases.append((cfg, inputs, cams, offs, refs))

    errs = []
    for cfg, inputs, cams, offs, refs in cases:
        H, W = cfg.image_height, cfg.image_width
        out = denoise_scenes_sharded(cfg, mesh, inputs, cams, offs)
        label = f"{cfg.warp_mode} {cfg.fitter_impl} {cfg.solver}"
        if tuple(out.shape) != (S, T, 3, H, W):
            raise RuntimeError(f"dry run ({label}): output shape "
                               f"{tuple(out.shape)}")
        if not bool(torch.isfinite(out).all()):
            raise RuntimeError(f"dry run ({label}): non-finite output")
        worst = 0.0
        for s in range(S):
            err = float((out[s] - refs[s]).abs().max())
            if not err <= DRYRUN_TOL:
                raise RuntimeError(f"dry run ({label}): scene {s} diverges "
                                   f"from its per-scene run: max|diff|="
                                   f"{err}")
            worst = max(worst, err)
        errs.append(worst)
    return errs
