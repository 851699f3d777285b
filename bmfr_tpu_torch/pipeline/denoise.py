"""The per-frame denoise step and the frame-sequence loop.

Port of :mod:`bmfr_tpu.pipeline.denoise` for the flagship configuration
(the fused warp with the bf16 channel-pair state and the fused Cholesky
fitter). Per frame (opencl/bmfr.cpp:417-485):

1. reproject (torch);
2. kernel A: the 13 blend planes of the previous state
   (:func:`~bmfr_tpu_torch.ops.warp_blend.warp_blend`);
3. the K1 tail (torch);
4. kernel B: the filtered image
   (:func:`~bmfr_tpu_torch.ops.fitter_direct.fit_reconstruct_cholesky`);
5. K4 and 6. K5 (torch);
7. pack the new state into the state buffer, in place.

Frame 0 has no history: the warp is not launched and its planes are
zero. The reference's one-frame matrix lag (frame N is reprojected with
``camera_matrices[N-1]``, opencl/bmfr.cpp:440-444) is kept in
:func:`denoise_sequence`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import check_supported
from ..ops.accumulate import accumulate_filtered_data
from ..ops.fitter_direct import (fit_reconstruct_cholesky,
                                 fit_reconstruct_cholesky_reference)
from ..ops.reproject import accumulate_noisy_data, reproject_coords
from ..ops.taa import taa
from ..ops.warp import pack_pairs_bf16
from ..ops.warp_blend import BLEND_PLANES, warp_blend, warp_blend_reference

#: Top and left padding of the JAX package's padded state layout
#: (``bmfr_tpu/ops/warp_pallas.py`` ``P_T3`` and ``P_L``); the port's
#: state is unpadded.
JAX_STATE_PAD = (16, 256)


class FrameInputs(NamedTuple):
    """One frame of path-tracer outputs (opencl/bmfr.cpp:49-52),
    channels-first f32 ``[3, H, W]`` each (``[T, 3, H, W]`` for a
    sequence)."""

    normals: torch.Tensor
    positions: torch.Tensor
    noisy: torch.Tensor
    albedo: torch.Tensor


class PackedState(NamedTuple):
    """The recurrent state: all 16 recurrent channels (positions 3,
    normals 3, accumulated noisy 3, spp 1, out 3, result 3) as the bf16
    channel-pair pack, an unpadded i32 ``[8, H, W]`` (29.5 MB at
    1280x720). Every consumer reads the previous frame through bf16
    taps, so rounding at the store gives the same values as rounding at
    the read. :func:`denoise_frame` overwrites it in place."""

    src8: torch.Tensor

    @classmethod
    def initial(cls, cfg, device="cpu"):
        """An all-zero state (frame 0 never reads it)."""
        return cls(torch.zeros((8, cfg.image_height, cfg.image_width),
                               dtype=torch.int32, device=device))


def denoise_frame(cfg, state, inputs: FrameInputs, prev_cam, pixel_offset,
                  frame: int, *, plain=False):
    """Run the 5-stage chain for frame number ``frame`` (a host int).

    ``state`` is a :class:`PackedState`; its buffer is overwritten with
    the next state (the warp reads the old words before the pack writes
    them, in stream order, so one buffer suffices). ``prev_cam``: f32
    ``[4, 4]``; ``pixel_offset``: f32 ``[2]``. ``plain=True`` runs the
    plain PyTorch versions of the two kernels instead of the kernels
    (for checking the kernels on the card).

    Returns ``(state, outputs)``; outputs holds the final ``result`` and
    the intermediates (``tone``, ``out``, ``filtered``, ``accum``,
    ``spp``, ``prev_pixels``, ``accept``, ``weights``, ``warp_stats``).
    """
    check_supported(cfg)
    H, W = cfg.image_height, cfg.image_width
    dev = inputs.noisy.device

    pfx, pfy = reproject_coords(cfg, inputs.positions, prev_cam,
                                pixel_offset)
    if frame > 0:
        warp = warp_blend_reference if plain else warp_blend
        planes = warp(cfg, state.src8, inputs.positions, inputs.normals,
                      pfx, pfy)
        # no tiers on the GPU: the kernel serves every pixel
        warp_stats = torch.tensor([0, 0, 0, 0, 0, H * W], dtype=torch.int32)
    else:
        planes = torch.zeros((BLEND_PLANES, H, W), dtype=torch.float32,
                             device=dev)
        warp_stats = torch.zeros(6, dtype=torch.int32)

    k1 = accumulate_noisy_data(cfg, inputs.noisy, pfx, pfy, planes, frame)

    weights = None
    if cfg.skip_fitting:
        filtered = k1["accum"]
    else:
        fit = (fit_reconstruct_cholesky_reference if plain
               else fit_reconstruct_cholesky)
        filtered, weights = fit(cfg, inputs.normals, inputs.positions,
                                k1["accum"], frame)

    out, tone = accumulate_filtered_data(cfg, filtered, planes,
                                         inputs.albedo, k1["spp"], frame)
    result = taa(cfg, k1["prev_pixels"], tone, planes, frame)

    # the next state, packed per channel straight into the state buffer
    # (words 0:3 geometry, 3:5 accumulated colour + spp, 5:8 out + result)
    s = state.src8
    pack_pairs_bf16([*inputs.positions, *inputs.normals], out=s[0:3])
    pack_pairs_bf16([*k1["accum"], k1["spp"].float()], out=s[3:5])
    pack_pairs_bf16([*out, *result], out=s[5:8])

    outputs = dict(
        result=result, tone=tone, out=out, filtered=filtered,
        accum=k1["accum"], spp=k1["spp"], prev_pixels=k1["prev_pixels"],
        accept=k1["accept"], weights=weights, warp_stats=warp_stats)
    return state, outputs


def make_denoise_frame(cfg, *, plain=False):
    """A per-frame step ``(state, inputs, prev_cam, pixel_offset, frame)
    -> (state, result)`` with ``cfg`` bound; the state buffer is updated
    in place, the counterpart of the JAX step's donated carry and the
    reference's double-buffer swap (opencl/bmfr.cpp:482-484)."""
    check_supported(cfg)

    def step(state, inputs, prev_cam, pixel_offset, frame):
        state, outputs = denoise_frame(cfg, state, inputs, prev_cam,
                                       pixel_offset, frame, plain=plain)
        return state, outputs["result"]

    return step


def denoise_sequence(cfg, inputs: FrameInputs, camera_matrices,
                     pixel_offsets, lite_outputs=True, return_stats=False, *,
                     plain=False):
    """Denoise a stacked animation, frame by frame.

    inputs: :class:`FrameInputs` with a leading time axis ``[T, 3, H, W]``;
    camera_matrices f32 ``[T, 4, 4]``; pixel_offsets f32 ``[T, 2]``, all
    on one device. Returns the stacked TAA results ``f32[T, 3, H, W]``
    (plus the tone-mapped frames when ``lite_outputs`` is False, and the
    i32 ``[T, 6]`` warp record when ``return_stats``: every warped frame
    records ``[0, 0, 0, 0, 0, H*W]``, frame 0 zeros). The sequence starts
    at frame 0, which reads no history, so it takes no initial state.
    """
    check_supported(cfg)
    T = inputs.noisy.shape[0]
    H, W = cfg.image_height, cfg.image_width
    dev = inputs.noisy.device
    state = PackedState.initial(cfg, dev)

    results = torch.empty((T, 3, H, W), dtype=torch.float32, device=dev)
    tones = None if lite_outputs else torch.empty_like(results)
    stats = torch.zeros((T, 6), dtype=torch.int32)
    for t in range(T):
        frame_in = FrameInputs(inputs.normals[t], inputs.positions[t],
                               inputs.noisy[t], inputs.albedo[t])
        state, outputs = denoise_frame(
            cfg, state, frame_in, camera_matrices[max(t - 1, 0)],
            pixel_offsets[t], t, plain=plain)
        results[t] = outputs["result"]
        if tones is not None:
            tones[t] = outputs["tone"]
        stats[t] = outputs["warp_stats"]

    ys = (results,) if lite_outputs else (results, tones)
    if return_stats:
        ys = ys + (stats,)
    return ys if len(ys) > 1 else ys[0]


def packed_state_from_jax(cfg, src8, device="cpu"):
    """The port's state from the JAX package's padded
    ``PackedState.src8`` (i32 ``[8, Hp, Wp]``, any array-like): the
    image window ``[:, 16:16+H, 256:256+W]``."""
    top, left = JAX_STATE_PAD
    H, W = cfg.image_height, cfg.image_width
    win = np.asarray(src8)[:, top:top + H, left:left + W]
    return PackedState(torch.from_numpy(
        np.ascontiguousarray(win, dtype=np.int32)).to(device))


def frame_inputs_from_numpy(normals, positions, noisy, albedo,
                            device="cpu"):
    """:class:`FrameInputs` from channels-last numpy arrays
    (``[H, W, 3]`` or ``[T, H, W, 3]``, as the fixtures return them)."""
    def chw(a):
        a = np.moveaxis(np.asarray(a, np.float32), -1, -3)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FrameInputs(chw(normals), chw(positions), chw(noisy), chw(albedo))
