"""bmfr_tpu_torch — the BMFR denoiser on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of the JAX package :mod:`bmfr_tpu`, which stays the reference.
The public surface is the same: channels-first ``[3, H, W]`` f32 planes
and ``[T, 3, H, W]`` sequences, :class:`BMFRConfig`, :class:`FrameInputs`,
:class:`PackedState`, :func:`denoise_frame`, :func:`make_denoise_frame`
and :func:`denoise_sequence`. It runs the JAX package's flagship
configuration (:data:`config.FLAGSHIP`). This package imports neither
JAX nor :mod:`bmfr_tpu`.
"""

from .config import FLAGSHIP, BMFRConfig, config_from_jax
from .pipeline.denoise import (FrameInputs, PackedState, denoise_frame,
                               denoise_sequence, frame_inputs_from_numpy,
                               make_denoise_frame, packed_state_from_jax)

__all__ = [
    "BMFRConfig",
    "FLAGSHIP",
    "FrameInputs",
    "PackedState",
    "config_from_jax",
    "denoise_frame",
    "denoise_sequence",
    "frame_inputs_from_numpy",
    "make_denoise_frame",
    "packed_state_from_jax",
]
