"""The compiled step: the steady per-frame step captured once as a CUDA
graph and replayed for every later frame.

The counterpart of the JAX package's compiled programs: the jitted step
with its donated carry (``bmfr_tpu/pipeline/denoise.py:297-313``) and the
``lax.scan`` body of ``denoise_sequence`` and of the stream's chunk
runner. Eagerly, a frame is a few hundred launches from Python and the
card waits for the host between them; a replay is one launch of all of
them.

- What a replay reads: static buffers that each call fills on the card
  before the replay (the four ``[3, H, W]`` planes, the ``[4, 4]`` camera,
  the ``[2]`` offset, and the frame number as a 0-d int32, which the
  fitter kernels and the jitter read there: :mod:`~bmfr_tpu_torch.ops.
  frame`), and the carry.
- The carry: the step owns the state it carries, a buffer set of the
  state's type. A :class:`~bmfr_tpu_torch.pipeline.denoise.PackedState`
  is packed in place, as eagerly; a :class:`~bmfr_tpu_torch.pipeline.
  state.TemporalState` is written last, by copies at the end of the graph
  (eagerly its planes are this frame's own tensors, the input planes
  among them, which the next frame's copy-in would overwrite). A state
  from elsewhere is copied into the carry once.
- Capture: the first call of a (state type, card) runs its frame eagerly
  on the static buffers (which also loads the kernel library and makes
  every one-time setting), then captures the same step on a stream of
  its own. A capture that fails raises: on a card nothing falls back to
  the eager step.
- Launch counters: the kernel wrappers count their launches in Python,
  which a replay does not run; each replay adds the captured step's
  counts, so the counts read as if the step ran eagerly.

The same kernels run in the same order with the same inputs, so a replay
equals the eager step bit for bit.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

from ..config import check_supported
from ..ops.fitter_direct import (fit_blocks_direct, fit_reconstruct_cholesky,
                                 fit_reconstruct_direct)
from ..ops.fitter_pallas import fit_blocks_pallas
from ..ops.warp import warp_rows
from ..ops.warp_blend import warp_blend
from ..profiling import stage
from .denoise import FrameInputs, PackedState, denoise_frame
from .state import TemporalState

#: the kernel wrappers whose launch counters a replay advances
COUNTED = (warp_blend, fit_reconstruct_cholesky, fit_reconstruct_direct,
           fit_blocks_direct, fit_blocks_pallas, warp_rows)

# one capture at a time in the process: scenes streamed on several
# threads each capture their own step
_CAPTURE_LOCK = threading.Lock()


def capture(fn, device):
    """Capture ``fn()`` as a CUDA graph on ``device``, on a stream of its
    own, and return ``(graph, fn's result)``; the result's tensors live
    in the graph's memory and each ``graph.replay()`` rewrites them. Work
    a graph cannot hold (a host read of the card, such as ``.item()``, or
    a synchronization) raises; nothing runs eagerly instead."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with _CAPTURE_LOCK, torch.cuda.graph(graph, stream=stream,
                                         capture_error_mode="thread_local"):
        out = fn()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph, out


def _check(t, name, shape, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


class _Graph:
    """One captured step: its static buffers, its carry and its graph."""

    def __init__(self, cfg, state_type, device):
        H, W = cfg.image_height, cfg.image_width
        f32 = dict(dtype=torch.float32, device=device)
        self.cfg, self.device = cfg, device
        self.inputs = FrameInputs(*(torch.zeros((3, H, W), **f32)
                                    for _ in FrameInputs._fields))
        self.cam = torch.zeros((4, 4), **f32)
        self.offset = torch.zeros(2, **f32)
        self.frame = torch.zeros((), dtype=torch.int32, device=device)
        self.carry = (PackedState if state_type is PackedState
                      else TemporalState).initial(cfg, device)
        if state_type is TemporalState:
            # distinct buffers: initial() shares one zero plane
            self.carry = TemporalState(*(t.clone() for t in self.carry))
        self.current = None     # the state whose values the carry holds
        self.graph = self.outputs = self.counts = None
        self.capture_s = None

    def body(self):
        """The steady step on the static buffers, the carry written
        last."""
        state, out = denoise_frame(self.cfg, self.carry, self.inputs,
                                   self.cam, self.offset, self.frame,
                                   history="always")
        if isinstance(state, TemporalState):
            with stage("state_pack"):
                for dst, src in zip(self.carry, state):
                    dst.copy_(src)
        return dict(result=out["result"], tone=out["tone"],
                    warp_stats=out["warp_stats"])

    def _holds(self, state):
        return (self.current is not None
                and all(a is b for a, b in zip(state, self.current)))

    def step(self, state, inputs, prev_cam, pixel_offset, frame, donate):
        cfg, dev = self.cfg, self.device
        H, W = cfg.image_height, cfg.image_width
        if not self._holds(state):
            for name, dst, src in zip(type(state)._fields, self.carry, state):
                _check(src, name, tuple(dst.shape), dst.dtype, dev)
                dst.copy_(src)
        for name, dst, src in zip(FrameInputs._fields, self.inputs, inputs):
            _check(src, name, (3, H, W), torch.float32, dev)
            dst.copy_(src)
        _check(prev_cam, "prev_cam", (4, 4), torch.float32, dev)
        _check(pixel_offset, "pixel_offset", (2,), torch.float32, dev)
        self.cam.copy_(prev_cam)
        self.offset.copy_(pixel_offset)
        if isinstance(frame, torch.Tensor):
            _check(frame, "frame", (), torch.int32, dev)
            self.frame.copy_(frame)
        else:
            self.frame.fill_(int(frame))

        if self.graph is None:
            # this frame eagerly (the one-time setup runs here), then the
            # capture, whose launches the counters must not keep
            outputs = self.body()
            before = [fn.launches for fn in COUNTED]
            t0 = time.perf_counter()
            self.graph, self.outputs = capture(self.body, dev)
            self.capture_s = time.perf_counter() - t0
            self.counts = [fn.launches - n for fn, n in zip(COUNTED, before)]
            for fn, n in zip(COUNTED, before):
                fn.launches = n
        else:
            self.graph.replay()
            for fn, n in zip(COUNTED, self.counts):
                fn.launches += n
            outputs = self.outputs
        self.current = (self.carry if donate else
                        type(self.carry)(*(t.clone() for t in self.carry)))
        return self.current, outputs


class CompiledStep:
    """The steady step of ``cfg`` (frames with history) as a replayed CUDA
    graph, one per state type and card, captured at its first call.

    ``run(state, inputs, prev_cam, pixel_offset, frame) -> (state,
    outputs)`` takes what :func:`~bmfr_tpu_torch.pipeline.denoise.
    denoise_frame` takes (``frame`` a host int or a 0-d int32 tensor on
    the card) on CUDA tensors; ``outputs`` holds ``result``, ``tone`` and
    ``warp_stats``, the graph's own buffers, which the next call
    overwrites. ``donate=True``: the returned state is the step's carry,
    updated in place by the next call (JAX's donated carry);
    ``donate=False``: a copy of it, and every state the caller holds
    stays intact. One step object serves one thread at a time.
    """

    def __init__(self, cfg, donate=True):
        check_supported(cfg)
        self.cfg, self.donate = cfg, donate
        self._graphs = {}

    def run(self, state, inputs, prev_cam, pixel_offset, frame):
        dev = inputs.noisy.device
        if dev.type != "cuda":
            raise ValueError(f"the compiled step runs on a card, not {dev} "
                             "(denoise_frame runs the step eagerly)")
        if isinstance(state, PackedState) and self.cfg.warp_mode != "pallas":
            raise ValueError("a PackedState needs warp_mode='pallas'")
        key = (type(state), dev)
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(self.cfg, type(state), dev)
        return g.step(state, inputs, prev_cam, pixel_offset, frame,
                      self.donate)

    @property
    def capture_seconds(self):
        """Seconds each capture took (capture and instantiation), by
        (state type name, device)."""
        return {(k[0].__name__, str(k[1])): g.capture_s
                for k, g in self._graphs.items()}


@functools.lru_cache(maxsize=None)
def _cached_step(cfg, device, thread):
    return CompiledStep(cfg)


def compiled_step(cfg, device):
    """The compiled step of ``cfg`` on ``device`` that
    :func:`~bmfr_tpu_torch.pipeline.denoise.denoise_sequence` replays,
    one per calling thread, kept for later calls as JAX keeps a compiled
    program (``compiled_step.cache_clear()`` frees them)."""
    return _cached_step(cfg, torch.device(device), threading.get_ident())


compiled_step.cache_clear = _cached_step.cache_clear
