"""bmfr_tpu_torch — the BMFR denoiser on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of the JAX package :mod:`bmfr_tpu`, which stays the reference.
The public surface is the same: channels-first ``[3, H, W]`` f32 planes
and ``[T, 3, H, W]`` sequences, :class:`BMFRConfig`, :class:`FrameInputs`,
:class:`TemporalState` and :class:`PackedState`, :func:`denoise_frame`,
:func:`make_denoise_frame` and :func:`denoise_sequence`. It runs every
configuration of the JAX package but two (:func:`config.check_supported`):
the default ``BMFRConfig()`` (the reference-exact Householder path) and
the JAX package's flagship (:data:`config.FLAGSHIP`) among them.

It also runs the user journey of the reference binary: TUNI scene
directories read from disk (:mod:`.io.dataset` over the native C++ IO
library, :mod:`.io.native`), chunked streaming with the next chunk's
ingest overlapped with compute (:func:`stream_scene`,
:func:`stream_scenes`), checkpoint and resume of the recurrence in the
JAX package's file format (:func:`save_state`, :func:`load_state`), and
the command line ``python -m bmfr_tpu_torch.cli`` (PNGs out).

Fidelity: ``python -m bmfr_tpu_torch.fidelity`` (:mod:`.fidelity`) is
the JAX package's PSNR/SSIM sweep of eleven configurations over the
synthetic orbit, corridor and swing scenes or a TUNI scenes root (clean
renders and OpenCL output PNGs found by
:meth:`~.io.dataset.SceneDescriptor.load_references`), scored on the
device (:mod:`.metrics`). :mod:`.oracle` is a copy of the JAX package's
NumPy oracle, the literal restatement of ``opencl/bmfr.cl``, and
:mod:`.parity` holds the port to it frame by frame; neither is on the
denoise path. This package imports neither JAX nor :mod:`bmfr_tpu`.
"""

from .checkpoint import load_state, save_state
from .config import FLAGSHIP, BMFRConfig, config_from_jax
from .pipeline.denoise import (FrameInputs, PackedState, denoise_frame,
                               denoise_sequence, frame_inputs_from_numpy,
                               make_denoise_frame, packed_state_from_jax,
                               zero_state)
from .pipeline.state import TemporalState, temporal_state_from_jax
from .pipeline.streaming import (make_chunk_runner, stream_scene,
                                 stream_scenes)

__all__ = [
    "BMFRConfig",
    "FLAGSHIP",
    "FrameInputs",
    "PackedState",
    "TemporalState",
    "config_from_jax",
    "denoise_frame",
    "denoise_sequence",
    "frame_inputs_from_numpy",
    "load_state",
    "make_chunk_runner",
    "make_denoise_frame",
    "packed_state_from_jax",
    "save_state",
    "stream_scene",
    "stream_scenes",
    "temporal_state_from_jax",
    "zero_state",
]
