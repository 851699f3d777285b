"""bmfr_tpu_torch — the BMFR denoiser on PyTorch and hand-written CUDA
kernels for NVIDIA Hopper (H100).

A port of the JAX package :mod:`bmfr_tpu`, which stays the reference.
The public surface is the same: channels-first ``[3, H, W]`` f32 planes
and ``[T, 3, H, W]`` sequences, :class:`BMFRConfig` and
:data:`DEFAULT_CONFIG`, :class:`FrameInputs`,
:class:`TemporalState` and :class:`PackedState`, :func:`denoise_frame`,
:func:`make_denoise_frame` and :func:`denoise_sequence`. It runs every
configuration of the JAX package but one, a TPU measurement knob
(:func:`config.check_supported`): the default ``BMFRConfig()`` (the
reference-exact Householder path), the JAX package's flagship
(:data:`config.FLAGSHIP`) and any registered feature basis
(:func:`.features.register_feature`) on every fitter among them.
Scene-parallel denoising over a mesh of devices is
:func:`denoise_scenes_sharded` (:mod:`.parallel`), and
:mod:`.graft_entry` holds the counterparts of the JAX package's
``__graft_entry__.py``.

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
denoise path.

Speed: ``python -m bmfr_tpu_torch.bench`` (:mod:`.bench`) is the JAX
package's ``bench.py`` on the card (1280x720, 60 frames, the flagship,
one JSON line), and :func:`.profile_stages.sequence_trace_report`
(``scripts/torch_trace_scan.py``) splits the benched sequence by stage.
This package imports neither JAX nor :mod:`bmfr_tpu`.
"""

from .checkpoint import load_state, save_state
from .config import DEFAULT_CONFIG, FLAGSHIP, BMFRConfig, config_from_jax
from .features import register_feature
from .pipeline.denoise import (FrameInputs, PackedState, denoise_frame,
                               denoise_sequence, frame_inputs_from_numpy,
                               make_denoise_frame, packed_state_from_jax,
                               zero_state)
from .pipeline.state import TemporalState, temporal_state_from_jax
from .pipeline.streaming import (make_chunk_runner, stream_scene,
                                 stream_scenes)
from .parallel import (denoise_scenes_jit, denoise_scenes_sharded,
                       make_scene_mesh)

__all__ = [
    "BMFRConfig",
    "DEFAULT_CONFIG",
    "FLAGSHIP",
    "FrameInputs",
    "PackedState",
    "TemporalState",
    "config_from_jax",
    "denoise_frame",
    "denoise_scenes_jit",
    "denoise_scenes_sharded",
    "denoise_sequence",
    "frame_inputs_from_numpy",
    "load_state",
    "make_chunk_runner",
    "make_denoise_frame",
    "make_scene_mesh",
    "packed_state_from_jax",
    "register_feature",
    "save_state",
    "stream_scene",
    "stream_scenes",
    "temporal_state_from_jax",
    "zero_state",
]
