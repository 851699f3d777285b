"""The compiled step: the steady per-frame step captured once as a CUDA
graph and replayed for every later frame.

- Which frames replay: :class:`CompiledStep` alone decides, for every
  driver (``make_denoise_frame``'s step and :func:`~bmfr_tpu_torch.
  pipeline.denoise.step_frames`, the loop of ``denoise_sequence``, the
  stream's chunks and the scene runner). A frame with history on a card
  replays the graph; a frame without history, a frame on the CPU and a
  step built ``plain`` run :func:`~bmfr_tpu_torch.pipeline.denoise.
  denoise_frame` eagerly, inside the span ``entry.eager``.

The counterpart of the JAX package's compiled programs: the jitted step
with its donated carry (``bmfr_tpu/pipeline/denoise.py:297-313``) and the
``lax.scan`` body of ``denoise_sequence`` and of the stream's chunk
runner. Eagerly, a frame is a few hundred launches from Python and the
card waits for the host between them; a replay is one launch of all of
them.

- What a replay reads: the caller's four ``[3, H, W]`` planes, ``[4,
  4]`` camera and ``[2]`` offset where they lie (:mod:`~bmfr_tpu_torch.
  pipeline.bind`: the captured kernels' arguments pointed at them before
  the replay, by one C call a slot; an input that cannot be read in place
  is copied into the slot's static buffer, its placeholder, as every
  input is at the capture), the frame number as a 0-d int32 in a static
  buffer that each call fills (the fitter kernels and the jitter read it
  there: :mod:`~bmfr_tpu_torch.ops.frame`), and the carry.
- The carry: the step owns the state it carries, a buffer set of the
  state's type, written in place by the step's last kernels as XLA
  writes the JAX step's donated outputs: a :class:`~bmfr_tpu_torch.
  pipeline.denoise.PackedState`'s words by kernels G and F, as eagerly; a
  :class:`~bmfr_tpu_torch.pipeline.state.TemporalState` (six distinct
  buffers) as ``denoise_frame``'s destination ``into``, so G stores the
  positions, normals, noisy colour and spp and F the out and result
  planes there, after the warp read them (eagerly, without ``into``, the
  next state is this frame's own tensors). The graph copies nothing into
  the carry; a state from elsewhere is copied in once, before a replay.
- Capture: the first replayed call of a (state type, card, number of
  scenes) runs its frame eagerly on the static buffers (which also loads
  the kernel library and makes every one-time setting), then captures the
  same step on a stream of its own, keeps the graph beside its instance
  and finds, once, the kernels' argument words that hold a placeholder's
  address (:class:`~bmfr_tpu_torch.pipeline.bind.NodeBinding`). A
  capture that fails raises: on a card nothing falls back to the eager
  step.
- Several scenes (:meth:`CompiledStep.run_scenes`, the scene-parallel
  runner of :mod:`~bmfr_tpu_torch.parallel`): one graph holds their
  steps back to back, each scene in a slot of its own (static buffers
  and carry). A carry never serves two scenes: a donated state is the
  carry itself, and the carry is found by the identity of its tensors.
- Launch counters: the kernel wrappers count their launches in Python,
  which a replay does not run; the capture tallies its launches apart
  (:func:`~bmfr_tpu_torch.ops._lib.tally_launches`, per thread) and each
  replay adds the nonzero ones in one call
  (:func:`~bmfr_tpu_torch.ops._lib.count_launches`), so the counts read
  as if the step ran eagerly, also while other threads launch.
- Spans and the copy counter (:mod:`~bmfr_tpu_torch.profiling`):
  ``step.run`` around a call, ``step.load`` around each slot's load and
  ``step.replay`` around the graph's launch and the counters' advance;
  ``copies`` counts the load's copies and fill (and a returned copy of
  the carry), ``inputs_in_place`` the inputs a replay reads where they
  lie.

The same kernels run in the same order with the same inputs, so a replay
equals the eager step bit for bit.
"""

from __future__ import annotations

import functools
import threading
import time

import torch

from ..config import check_supported
from ..ops import _lib
from ..ops.blockify import build_feature_blocks
from ..ops.fitter_direct import (fit_blocks_direct, fit_reconstruct_cholesky,
                                 fit_reconstruct_direct)
from ..ops.fitter_pallas import fit_blocks_pallas
from ..ops.frame import has_history
from ..ops.reproject import noisy_tail, reproject_coords
from ..ops.tail import filtered_tail
from ..ops.warp import warp_rows
from ..ops.warp_blend import warp_blend, warp_blend_planes
from ..ops.weighted_sum import weighted_sum
from ..profiling import count, span
from .bind import NodeBinding, in_place, storage_start
from .denoise import FrameInputs, PackedState, denoise_frame
from .state import TemporalState

#: a slot's inputs, in the order of its placeholders
INPUTS = (*FrameInputs._fields, "prev_cam", "pixel_offset")

#: the kernel wrappers whose launch counters a replay advances
COUNTED = (warp_blend, fit_reconstruct_cholesky, fit_reconstruct_direct,
           fit_blocks_direct, fit_blocks_pallas, warp_rows, reproject_coords,
           noisy_tail, filtered_tail, warp_blend_planes,
           build_feature_blocks, weighted_sum)

# one capture at a time in the process: scenes streamed on several
# threads each capture their own step
_CAPTURE_LOCK = threading.Lock()


def capture(fn, device):
    """Capture ``fn()`` as a CUDA graph on ``device``, on a stream of its
    own, and return ``(graph, fn's result)``: the graph instantiated, its
    ``raw_cuda_graph()`` kept for :class:`~bmfr_tpu_torch.pipeline.bind.
    NodeBinding`. The result's tensors live in the graph's memory and each
    ``graph.replay()`` rewrites them. Work a graph cannot hold (a host
    read of the card, such as ``.item()``, or a synchronization) raises;
    nothing runs eagerly instead."""
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with _CAPTURE_LOCK, torch.cuda.graph(graph, stream=stream,
                                         capture_error_mode="thread_local"):
        out = fn()
    graph.instantiate()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph, out


def _check(t, name, shape, dtype, device):
    if tuple(t.shape) != shape or t.dtype != dtype or t.device != device:
        raise ValueError(f"{name}: expected {dtype} {shape} on {device}, got "
                         f"{t.dtype} {tuple(t.shape)} on {t.device}")


class _Slot:
    """One scene's place in a captured step: its static buffers (the
    inputs' placeholders and the frame), its carry and, after the
    capture, the binding of its placeholders' nodes."""

    def __init__(self, cfg, state_type, device):
        H, W = cfg.image_height, cfg.image_width
        f32 = dict(dtype=torch.float32, device=device)
        self.cfg, self.device = cfg, device
        self.inputs = FrameInputs(*(torch.zeros((3, H, W), **f32)
                                    for _ in FrameInputs._fields))
        self.cam = torch.zeros((4, 4), **f32)
        self.offset = torch.zeros(2, **f32)
        self.placeholders = (*self.inputs, self.cam, self.offset)
        self.homes = tuple(t.data_ptr() for t in self.placeholders)
        self.frame = torch.zeros((), dtype=torch.int32, device=device)
        self.carry = (PackedState if state_type is PackedState
                      else TemporalState).initial(cfg, device)
        if state_type is TemporalState:
            # distinct buffers: initial() shares one zero plane
            self.carry = TemporalState(*(t.clone() for t in self.carry))
        self.current = None     # the state whose values the carry holds
        self.binding = None     # NodeBinding, once captured
        self.written = frozenset()  # storages the step writes (in_place)

    def body(self):
        """The steady step on the static buffers, the carry written in
        place by its kernels."""
        into = self.carry if isinstance(self.carry, TemporalState) else None
        _, out = denoise_frame(self.cfg, self.carry, self.inputs, self.cam,
                               self.offset, self.frame, history="always",
                               into=into)
        return dict(result=out["result"], tone=out["tone"],
                    warp_stats=out["warp_stats"])

    def bind(self, binding, outputs):
        """After the capture: read the inputs in place through ``binding``
        (a :class:`~bmfr_tpu_torch.pipeline.bind.NodeBinding` of the
        placeholders) where :func:`~bmfr_tpu_torch.pipeline.bind.in_place`
        admits them; never an input in the carry or in the ``outputs``'
        result or tone, which the step writes."""
        self.binding = binding
        self.written = frozenset(storage_start(t) for t in (
            *self.carry, outputs["result"], outputs["tone"]))

    def _holds(self, state):
        return (self.current is not None
                and all(a is b for a, b in zip(state, self.current)))

    def load(self, state, inputs, prev_cam, pixel_offset, frame):
        """Check the inputs and make them what the next run reads: before
        the capture each is copied into its placeholder; after it each
        that :func:`~bmfr_tpu_torch.pipeline.bind.in_place` admits is
        read where it lies and any other is copied, and one C call points
        the nodes at the frame's addresses where they changed. Fills the
        frame number, and copies ``state`` into the carry unless it holds
        it already. Counts each copy and fill in ``copies`` and the inputs
        read in place in ``inputs_in_place``
        (:func:`~bmfr_tpu_torch.profiling.count`)."""
        with span("step.load"):
            dev = self.device
            copies = 1      # the frame
            if not self._holds(state):
                for name, dst, src in zip(type(state)._fields, self.carry,
                                          state):
                    _check(src, name, tuple(dst.shape), dst.dtype, dev)
                    dst.copy_(src)
                copies += len(self.carry)
            srcs = (*inputs, prev_cam, pixel_offset)
            for name, dst, src in zip(INPUTS, self.placeholders, srcs):
                _check(src, name, tuple(dst.shape), torch.float32, dev)
            if self.binding is None:
                for dst, src in zip(self.placeholders, srcs):
                    dst.copy_(src)
                copies += len(srcs)
            else:
                bases, read = [], 0
                for dst, src, home, need in zip(self.placeholders, srcs,
                                                self.homes,
                                                self.binding.alignment):
                    if in_place(src, need, self.written):
                        bases.append(src.data_ptr())
                        read += 1
                    else:
                        dst.copy_(src)
                        bases.append(home)
                        copies += 1
                self.binding.bind(tuple(bases))
                count("inputs_in_place", read)
            if isinstance(frame, torch.Tensor):
                _check(frame, "frame", (), torch.int32, dev)
                self.frame.copy_(frame)
            else:
                self.frame.fill_(int(frame))
            count("copies", copies)

    def hand_out(self, donate):
        """The state after the step: the carry itself, or a copy (counted
        in ``copies``)."""
        if donate:
            self.current = self.carry
        else:
            self.current = type(self.carry)(*(t.clone() for t in self.carry))
            count("copies", len(self.carry))
        return self.current


class _Graph:
    """One captured step of one or more scenes: a slot per scene (its own
    buffers and carry) and one graph that runs their steps back to
    back."""

    def __init__(self, cfg, state_type, device, scenes=1):
        self.slots = [_Slot(cfg, state_type, device) for _ in range(scenes)]
        self.device = device
        self.graph = self.outputs = self.counts = None
        self.capture_s = None

    def body(self):
        return [slot.body() for slot in self.slots]

    def step(self, calls, donate):
        """``calls``: one ``(state, inputs, prev_cam, pixel_offset,
        frame)`` per slot. Returns one ``(state, outputs)`` per slot."""
        for slot, args in zip(self.slots, calls):
            slot.load(*args)
        if self.graph is None:
            # this frame eagerly (the one-time setup runs here), then the
            # capture, whose launches the counters must not keep
            outputs = self.body()
            t0 = time.perf_counter()
            with _lib.tally_launches() as tally:
                self.graph, self.outputs = capture(self.body, self.device)
            for slot, out in zip(self.slots, self.outputs):
                slot.bind(NodeBinding(self.graph, slot.placeholders), out)
            self.capture_s = time.perf_counter() - t0
            self.counts = [(fn, tally[fn]) for fn in COUNTED
                           if tally.get(fn)]
        else:
            with span("step.replay"):
                self.graph.replay()
                _lib.count_launches(self.counts)
            outputs = self.outputs
        return [(slot.hand_out(donate), out)
                for slot, out in zip(self.slots, outputs)]


class CompiledStep:
    """The per-frame step of ``cfg``: a frame with history on a card
    replays the steady step as a CUDA graph, one per state type, card and
    number of scenes, captured at its first replayed call; every other
    frame runs :func:`~bmfr_tpu_torch.pipeline.denoise.denoise_frame`
    eagerly (:meth:`replays` is the rule).

    ``run(state, inputs, prev_cam, pixel_offset, frame, history=None) ->
    (state, outputs)`` takes what :func:`~bmfr_tpu_torch.pipeline.
    denoise.denoise_frame` takes (``frame`` a host int or a 0-d int32
    tensor on the inputs' device). A replay's ``outputs`` hold ``result``,
    ``tone`` and ``warp_stats``, the graph's own buffers (on a
    ``TemporalState`` the result is the carry's ``result``), which the
    next call overwrites; an eager frame's are ``denoise_frame``'s.
    ``replayed``: whether the last call replayed the graph.

    ``donate=True``: a replay's state is the step's carry, updated in
    place by the next call (JAX's donated carry), and an eager frame's
    packed state is the caller's, overwritten; ``donate=False``: a copy
    of the carry, and an eager frame's packed state a clone, so every
    state the caller holds stays intact. An eager ``TemporalState`` step
    returns the frame's own tensors and writes nothing of the caller's.
    ``plain=True``: every frame eagerly, on the kernels' plain versions.
    One step object serves one thread at a time.

    ``run_scenes(calls, history=None)`` steps several scenes of one card
    at once, the counterpart of the JAX package's ``vmap`` over scenes
    inside its ``lax.scan`` (``bmfr_tpu/parallel/sharding.py:52-58``):
    ``calls`` holds one argument tuple ``(state, inputs, prev_cam,
    pixel_offset, frame)`` per scene, and one graph runs the scenes'
    steps back to back, each scene with its own static buffers and carry
    (a carry serves one scene: a donated state is the carry itself). It
    returns one ``(state, outputs)`` per scene.
    """

    def __init__(self, cfg, donate=True, plain=False):
        check_supported(cfg)
        self.cfg, self.donate, self.plain = cfg, donate, plain
        self.replayed = False
        self._graphs = {}

    def run(self, state, inputs, prev_cam, pixel_offset, frame,
            history=None):
        (out,) = self.run_scenes([(state, inputs, prev_cam, pixel_offset,
                                   frame)], history)
        return out

    def run_scenes(self, calls, history=None):
        self.replayed = self.replays(calls, history)
        if not self.replayed:
            with span("entry.eager"):
                return [self._eager(*call, history) for call in calls]
        with span("step.run"):
            return self._graph(calls).step(calls, self.donate)

    def replays(self, calls, history=None):
        """Whether ``run_scenes(calls, history)`` replays the graph: every
        scene's frame has history (:func:`~bmfr_tpu_torch.ops.frame.
        has_history`: a frame without it reads no state, which the
        captured step always reads) on a card, and the step is not
        ``plain``."""
        return not self.plain and all(
            inputs.noisy.is_cuda and has_history(frame, history)
            for _, inputs, _, _, frame in calls)

    def _eager(self, state, inputs, prev_cam, pixel_offset, frame, history):
        if not self.donate and isinstance(state, PackedState):
            state = PackedState(state.src8.clone())
        return denoise_frame(self.cfg, state, inputs, prev_cam, pixel_offset,
                             frame, plain=self.plain, history=history)

    def _graph(self, calls):
        """The checked calls' graph (made at the first call of its key)."""
        if not calls:
            raise ValueError("run_scenes needs at least one scene")
        state_type = type(calls[0][0])
        dev = calls[0][1].noisy.device
        for state, inputs, *_ in calls:
            if inputs.noisy.device != dev or type(state) is not state_type:
                raise ValueError("the scenes of one step share their card "
                                 "and their state type")
        if state_type is PackedState and self.cfg.warp_mode != "pallas":
            raise ValueError("a PackedState needs warp_mode='pallas'")
        key = (state_type, dev, len(calls))
        g = self._graphs.get(key)
        if g is None:
            g = self._graphs[key] = _Graph(self.cfg, state_type, dev,
                                           len(calls))
        return g

    @property
    def capture_seconds(self):
        """Seconds each capture took (capture, instantiation and the
        bindings' walk of the graph), by (state type name, device, number
        of scenes)."""
        return {(k[0].__name__, str(k[1]), k[2]): g.capture_s
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
