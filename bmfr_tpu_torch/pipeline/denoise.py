"""The per-frame denoise step and the frame-sequence loop.

Port of :mod:`bmfr_tpu.pipeline.denoise`. Per frame (opencl/bmfr.cpp:
417-485):

1. reproject (kernel H, :func:`~bmfr_tpu_torch.ops.reproject.
   reproject_coords`);
2. the warp branch, the 13 blend planes of the previous state:
   ``warp_mode="pallas"`` runs kernel A on the bf16 channel-pair
   :class:`PackedState` (:func:`~bmfr_tpu_torch.ops.warp_blend.
   warp_blend`); on a raw-plane :class:`~bmfr_tpu_torch.pipeline.state.
   TemporalState` (the streaming and checkpoint carry, and every other
   warp mode's) kernel I gathers the taps of its six tensors in place in
   the warp mode, ``"packed_bf16"`` for ``"pallas"`` (each tap rounded to
   bf16: what kernel A reads from the pack of the same planes, which
   JAX packs at the read), and blends them (:func:`~bmfr_tpu_torch.ops.
   warp_blend.warp_blend_planes`);
3. the K1 tail and the next state's words 0:5 or raw positions,
   normals, noisy and spp (kernel G,
   :func:`~bmfr_tpu_torch.ops.reproject.noisy_tail`);
4. the fitter branch, the filtered image: ``fitter_impl="pallas_direct"``
   runs kernel B (``solver="cholesky"``) or kernel C (``"householder"``)
   on the raw planes; every other ``fitter_impl`` builds the feature
   blocks (kernel J, :func:`~bmfr_tpu_torch.ops.blockify.
   build_feature_blocks`), fits them (:func:`~bmfr_tpu_torch.ops.fitter.
   fit_blocks`: kernel D, or the plain path for ``"xla"`` and the
   Cholesky solver) and reconstructs the image (kernel K,
   :func:`~bmfr_tpu_torch.ops.weighted_sum.weighted_sum`);
5. K4, 6. K5 and the next state's words 5:8 or raw out and result
   (kernel F, :func:`~bmfr_tpu_torch.ops.tail.filtered_tail`);
7. the next state, of the type of the previous one: the state buffer
   that kernels G and F wrote in place (a :class:`PackedState`, or the
   :class:`TemporalState` destination ``into`` that the compiled step
   passes its carry as), or else a new :class:`TemporalState` of this
   frame's planes, as the JAX step's is (the caller's state is never
   written then).

Kernels F, G, H, I, J and K stand for the stages that XLA fuses into
the TPU's jitted step; ``plain=True`` runs the composition of the stage
functions they replace.

Frame 0 has no history: no warp or gather runs and the planes are zero
(JAX's ``history="never"``). The reference's one-frame matrix lag (frame
N is reprojected with ``camera_matrices[N-1]``, opencl/bmfr.cpp:440-444)
is :class:`PreviousCameras`.

:func:`denoise_frame` is the eager step, as JAX's un-jitted one is.
:func:`make_denoise_frame`'s step and :func:`step_frames`, the frame
loop of :func:`denoise_sequence`, of the stream's chunk runner and of the
scene runner, hand every frame to the step object of
:mod:`~bmfr_tpu_torch.pipeline.graph`, which replays its compiled step
for every frame with history on a card.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..config import check_supported
from ..ops.blockify import (build_feature_blocks,
                            build_feature_blocks_reference)
from ..ops.fitter import fit_blocks
from ..ops.fitter_direct import (fit_reconstruct_cholesky,
                                 fit_reconstruct_cholesky_reference,
                                 fit_reconstruct_direct,
                                 fit_reconstruct_direct_reference)
from ..ops.frame import has_history
from ..ops.reproject import (noisy_tail, noisy_tail_reference,
                             reproject_coords, reproject_coords_reference)
from ..ops.tail import filtered_tail, filtered_tail_reference
from ..ops.warp import pack_pairs_bf16
from ..ops.warp_blend import (BLEND_PLANES, warp_blend, warp_blend_planes,
                              warp_blend_planes_reference,
                              warp_blend_reference)
from ..ops.weighted_sum import weighted_sum, weighted_sum_reference
from ..profiling import count, span, stage
from .state import TemporalState

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
    def initial(cls, cfg, device="cuda"):
        """An all-zero state (frame 0 never reads it), on the card unless
        ``device`` says otherwise."""
        return cls(torch.zeros((8, cfg.image_height, cfg.image_width),
                               dtype=torch.int32, device=device))


def _warp_planes(cfg, state, inputs, pfx, pfy, history, plain):
    """The warp branch: the 13 blend planes of the previous state and the
    warp record."""
    H, W = cfg.image_height, cfg.image_width
    if not history:
        planes = torch.zeros((BLEND_PLANES, H, W), dtype=torch.float32,
                             device=inputs.noisy.device)
        return planes, torch.zeros(6, dtype=torch.int32)
    if cfg.warp_mode == "pallas":
        if isinstance(state, PackedState):
            warp = warp_blend_reference if plain else warp_blend
            planes = warp(cfg, state.src8, inputs.positions, inputs.normals,
                          pfx, pfy)
        elif plain:
            # JAX's shape: the raw planes packed at the read
            # (warp_pallas.py:990-992), in TemporalState.stacked()'s
            # channel order, then kernel A's plain version
            src8 = pack_pairs_bf16([*state.positions, *state.normals,
                                    *state.noisy, state.spp.float(),
                                    *state.out, *state.result])
            planes = warp_blend_reference(cfg, src8, inputs.positions,
                                          inputs.normals, pfx, pfy)
        else:
            # kernel I rounds each tap to bf16 as it reads the six tensors
            # in place: kernel A's planes on the pack, with no pack
            planes = warp_blend_planes(cfg, state, inputs.positions,
                                       inputs.normals, pfx, pfy,
                                       "packed_bf16")
        # no tiers on the GPU: the kernel serves every pixel
        return planes, torch.tensor([0, 0, 0, 0, 0, H * W],
                                    dtype=torch.int32)
    warp = warp_blend_planes_reference if plain else warp_blend_planes
    planes = warp(cfg, state, inputs.positions, inputs.normals, pfx, pfy,
                  cfg.warp_mode)
    return planes, torch.zeros(6, dtype=torch.int32)


def _filter(cfg, inputs, accum, frame, plain):
    """The fitter branch: ``(filtered f32[3, H, W], weights, mins_maxs)``
    (the last two None where the path does not materialize them)."""
    if cfg.skip_fitting:
        return accum, None, None
    if cfg.fitter_impl == "pallas_direct":
        if cfg.solver == "cholesky":
            fit = (fit_reconstruct_cholesky_reference if plain
                   else fit_reconstruct_cholesky)
        else:
            fit = (fit_reconstruct_direct_reference if plain
                   else fit_reconstruct_direct)
        # the kernel gathers, fits and reconstructs: JAX's k2_blockify
        # and k3_weighted_sum have no work of their own here
        with stage("k2_fitter"):
            filtered, weights = fit(cfg, inputs.normals, inputs.positions,
                                    accum, frame)
        return filtered, weights, None
    with stage("k2_blockify"):
        tmp = (build_feature_blocks_reference if plain
               else build_feature_blocks)(cfg, inputs.normals,
                                          inputs.positions, accum, frame)
    with stage("k2_fitter"):
        weights, mins_maxs = fit_blocks(cfg, tmp, frame,
                                        impl="xla" if plain else None)
    with stage("k3_weighted_sum"):
        filtered = (weighted_sum_reference if plain else weighted_sum)(
            cfg, weights, mins_maxs, inputs.normals, inputs.positions, accum,
            frame, feature_blocks=tmp)
    return filtered, weights, mins_maxs


def denoise_frame(cfg, state, inputs: FrameInputs, prev_cam, pixel_offset,
                  frame, *, plain=False, history=None, into=None):
    """Run the 5-stage chain for frame number ``frame``: a host int, or a
    0-d int32 tensor on the inputs' device (JAX's traced frame: the
    kernels read it there, and the jitter's indices are built from it).

    ``history`` (``"never"`` or ``"always"``, JAX's static
    ``history``) says whether the frame reads the previous state; without
    it a host int decides (frame 0 reads none), and a tensor frame needs
    it (:func:`~bmfr_tpu_torch.ops.frame.has_history`): the host never
    reads the card to decide.

    ``state`` is a :class:`TemporalState` or, with ``warp_mode="pallas"``,
    a :class:`PackedState`; the next state has the same type. A packed
    buffer is overwritten with the next state (the warp reads the old
    words before the pack writes them, in stream order, so one buffer
    suffices). On the fused warp a :class:`TemporalState` is read through
    bf16 taps (kernel I in ``"packed_bf16"``; the plain path packs it at
    the read, as JAX does), the values a packed carry holds, so both
    carries give the same outputs bit for bit. A :class:`TemporalState`
    step returns a new :class:`TemporalState` of this frame's tensors and
    writes nothing of the caller's, as JAX's eager step does; with
    ``into`` (a :class:`TemporalState` of six distinct contiguous
    tensors, which may be ``state`` itself: the compiled step passes its
    carry) kernels G and F write the next state into it in place, after
    the warp read ``state`` (stream order), and it is returned.
    ``prev_cam``: f32 ``[4, 4]``; ``pixel_offset``: f32 ``[2]``.
    ``plain=True`` runs the plain PyTorch versions of the kernels instead
    of the kernels (for checking the kernels on the card).

    Each stage runs inside a profiler range under the JAX package's
    scope name (:data:`~bmfr_tpu_torch.profiling.STAGES`): kernels H and
    A or I inside ``warp_taps``, G inside ``k1_accumulate_noisy``, J
    inside ``k2_blockify``, K inside ``k3_weighted_sum`` and F inside
    ``k5_taa``, so ``k4_accumulate_filtered`` and ``state_pack`` hold no
    work on the kernel path (the plain versions open them inside G's and
    F's ranges).

    Returns ``(state, outputs)``; outputs holds the final ``result`` and
    the intermediates (``tone``, ``out``, ``filtered``, ``accum``,
    ``spp``, ``prev_pixels``, ``accept``, ``weights``, ``mins_maxs``,
    ``warp_stats``).
    """
    check_supported(cfg)
    if isinstance(state, PackedState) and cfg.warp_mode != "pallas":
        raise ValueError("a PackedState needs warp_mode='pallas'")
    if into is not None and not isinstance(state, TemporalState):
        raise ValueError("into takes the next state of a TemporalState step")
    hist = has_history(frame, history)
    history = "always" if hist else "never"
    # the next state in place: kernel G writes words 0:5 (or into's
    # positions, normals, noisy, spp) and kernel F words 5:8 (or into's
    # out, result), both after the warp read the previous state (stream
    # order)
    pack = state.src8 if isinstance(state, PackedState) else None
    with stage("warp_taps"):
        prev_pixels = (reproject_coords_reference if plain
                       else reproject_coords)(cfg, inputs.positions,
                                              prev_cam, pixel_offset, history)
        pfx, pfy = prev_pixels
        planes, warp_stats = _warp_planes(cfg, state, inputs, pfx, pfy, hist,
                                          plain)
    # K4 and the pack have no range of their own on the kernel path: they
    # run inside kernels G and F (the plain versions open them)
    with stage("k1_accumulate_noisy"):
        k1 = (noisy_tail_reference if plain else noisy_tail)(
            cfg, inputs.noisy, prev_pixels, planes, inputs.positions,
            inputs.normals, frame, history, pack=pack, into=into)
    filtered, weights, mins_maxs = _filter(cfg, inputs, k1["accum"], frame,
                                           plain)
    with stage("k5_taa"):
        out, tone, result = (filtered_tail_reference if plain
                             else filtered_tail)(
            cfg, filtered, planes, inputs.albedo, k1["spp"],
            k1["prev_pixels"], frame, history, pack=pack, into=into)

    if into is not None:
        state = into
    elif pack is None:
        state = TemporalState(normals=inputs.normals,
                              positions=inputs.positions, noisy=k1["accum"],
                              spp=k1["spp"], out=out, result=result)

    outputs = dict(
        result=result, tone=tone, out=out, filtered=filtered,
        accum=k1["accum"], spp=k1["spp"], prev_pixels=k1["prev_pixels"],
        accept=k1["accept"], weights=weights, mins_maxs=mins_maxs,
        warp_stats=warp_stats)
    return state, outputs


def zero_state(cfg, device="cuda"):
    """The all-zero state of ``cfg``'s warp: a :class:`PackedState` for
    ``warp_mode="pallas"``, else a :class:`TemporalState`; on the card
    unless ``device`` says otherwise."""
    if cfg.warp_mode == "pallas":
        return PackedState.initial(cfg, device)
    return TemporalState.initial(cfg, device)


def make_denoise_frame(cfg, *, plain=False, donate=True):
    """A per-frame step ``(state, inputs, prev_cam, pixel_offset, frame,
    history=None) -> (state, result)`` with ``cfg`` bound, the
    counterpart of the JAX package's jitted step
    (``make_denoise_frame(cfg, donate=True)``).

    Each frame goes to one step object (:class:`~bmfr_tpu_torch.pipeline.
    graph.CompiledStep`), which decides: on a card every frame with
    history replays the steady step captured once as a CUDA graph,
    reading the frame from the card; frame 0, the CPU and ``plain=True``
    run :func:`denoise_frame` eagerly. ``frame``/``history`` as
    :func:`denoise_frame` takes them. ``result`` is the caller's own
    tensor. Each call is a :func:`~bmfr_tpu_torch.profiling.span`
    ``entry.step`` (given ``frame`` when it is a host int) around
    ``entry.clone`` (a replay's result copied) or ``entry.eager``.

    ``donate=True``: the step owns the state it returns and updates it in
    place on the next call, the counterpart of JAX's donated carry and
    the reference's double-buffer swap (opencl/bmfr.cpp:482-484); a
    state handed in from elsewhere (``zero_state``, ``load_state``, ...)
    is copied into the step's carry once, and an eager packed state is
    updated in place. ``donate=False`` leaves every state the caller
    holds intact (a copy of each returned state is the caller's).
    """
    from .graph import CompiledStep

    compiled = CompiledStep(cfg, donate=donate, plain=plain)

    def step(state, inputs, prev_cam, pixel_offset, frame, history=None):
        with span("entry.step", frame if isinstance(frame, int) else None):
            state, outputs = compiled.run(state, inputs, prev_cam,
                                          pixel_offset, frame, history)
            result = outputs["result"]
            if compiled.replayed:
                with span("entry.clone"):
                    result = result.clone()
                    count("copies")
            return state, result

    return step


class PreviousCameras:
    """The camera matrix each frame is reprojected with: the reference's
    one-frame lag, frame N with the matrix of frame N-1
    (opencl/bmfr.cpp:440-444), and frame 0 with its own. ``cams``: the
    matrices of frames ``t0, t0+1, ...``; ``prev``: frame ``t0-1``'s
    (None where ``t0`` is frame 0). ``[i]`` is the matrix frame ``t0+i``
    reads, a view of ``cams`` or ``prev``."""

    __slots__ = ("cams", "prev")

    def __init__(self, cams, prev=None):
        self.cams = cams
        self.prev = cams[0] if prev is None else prev

    def __getitem__(self, i):
        return self.cams[i - 1] if i else self.prev


def step_frames(step, states, inputs, cams, offs, t0, out):
    """Step S scenes over frames ``t0 .. t0+n-1`` through ``step`` (a
    :class:`~bmfr_tpu_torch.pipeline.graph.CompiledStep`, which decides
    which frames replay): the frame loop of :func:`denoise_sequence`, of
    the stream's chunk runner and of the scene runner.

    ``states``: a list of the S scenes' states, each replaced in place
    by the next (so a state the caller does not hold is freed once
    stepped); ``inputs``: :class:`FrameInputs` of ``[S, n, 3, H, W]``;
    ``cams[s][i]``: the matrix scene ``s``'s frame ``t0+i`` is
    reprojected with (a :class:`PreviousCameras`); ``offs``: f32 ``[S,
    n, 2]``; ``out``: ``{output name: [S, n, ...] tensor}``, into which
    each scene-frame's output of that name is copied. Returns ``states``
    after the last frame."""
    S = len(states)
    for i in range(inputs.noisy.shape[1]):
        calls = [(states[s], FrameInputs(*(x[s, i] for x in inputs)),
                  cams[s][i], offs[s, i], t0 + i) for s in range(S)]
        for s, (state, outputs) in enumerate(step.run_scenes(calls)):
            states[s] = state
            for name, dst in out.items():
                dst[s, i] = outputs[name]
    return states


def denoise_sequence(cfg, inputs: FrameInputs, camera_matrices,
                     pixel_offsets, lite_outputs=True, initial_state=None,
                     return_stats=False, *, plain=False):
    """Denoise a stacked animation, frame by frame.

    inputs: :class:`FrameInputs` with a leading time axis ``[T, 3, H, W]``;
    camera_matrices f32 ``[T, 4, 4]``; pixel_offsets f32 ``[T, 2]``, all
    on one device. Returns the stacked TAA results ``f32[T, 3, H, W]``
    (plus the tone-mapped frames when ``lite_outputs`` is False, and the
    i32 ``[T, 6]`` warp record when ``return_stats``: every warped frame
    records ``[0, 0, 0, 0, 0, H*W]`` on the fused warp, every other frame
    zeros). ``initial_state``: the state to start from (default the
    all-zero state of :func:`zero_state`); the sequence starts at frame
    0, which reads no history, as the JAX one does.

    The frames go through :func:`step_frames` and the step object of
    ``cfg`` (:func:`~bmfr_tpu_torch.pipeline.graph.compiled_step`,
    captured at the first call and kept for later calls on the same card
    from the same thread): as JAX hoists frame 0 out of its ``lax.scan``,
    frame 0 runs eagerly and, on a card, frames 1.. replay the compiled
    step; on the CPU and with ``plain=True`` every frame runs eagerly.
    """
    from .graph import CompiledStep, compiled_step

    T = inputs.noisy.shape[0]
    dev = inputs.noisy.device
    step = (CompiledStep(cfg, plain=True) if plain
            else compiled_step(cfg, dev))
    out = {"result": torch.empty((T, 3, cfg.image_height, cfg.image_width),
                                 dtype=torch.float32, device=dev)}
    if not lite_outputs:
        out["tone"] = torch.empty_like(out["result"])
    if return_stats:
        out["warp_stats"] = torch.zeros((T, 6), dtype=torch.int32)
    step_frames(step, [zero_state(cfg, dev) if initial_state is None
                       else initial_state],
                FrameInputs(*(x[None] for x in inputs)),
                [PreviousCameras(camera_matrices)], pixel_offsets[None], 0,
                {name: y[None] for name, y in out.items()})
    ys = tuple(out.values())
    return ys if len(ys) > 1 else ys[0]


def packed_state_from_jax(cfg, src8, device="cuda"):
    """The port's state from the JAX package's padded
    ``PackedState.src8`` (i32 ``[8, Hp, Wp]``, any array-like): the
    image window ``[:, 16:16+H, 256:256+W]``, on the card unless
    ``device`` says otherwise."""
    top, left = JAX_STATE_PAD
    H, W = cfg.image_height, cfg.image_width
    win = np.asarray(src8)[:, top:top + H, left:left + W]
    return PackedState(torch.from_numpy(
        np.ascontiguousarray(win, dtype=np.int32)).to(device))


def frame_inputs_from_numpy(normals, positions, noisy, albedo,
                            device="cuda"):
    """:class:`FrameInputs` from channels-last numpy arrays
    (``[H, W, 3]`` or ``[T, H, W, 3]``, as the fixtures return them), on
    the card unless ``device`` says otherwise (without a card this raises:
    there is no silent CPU fallback)."""
    def chw(a):
        a = np.moveaxis(np.asarray(a, np.float32), -1, -3)
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return FrameInputs(chw(normals), chw(positions), chw(noisy), chw(albedo))
