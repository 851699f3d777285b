"""K4 + K5 + the out/result pack in one pass (kernel F) and its plain
PyTorch version.

On the TPU, XLA fuses the pre-blended K4 (:func:`bmfr_tpu.ops.accumulate.
accumulate_filtered_data`), K5 (:func:`bmfr_tpu.ops.taa.taa`) and the
next state's out/result words (``w_out``, ``bmfr_tpu/pipeline/
denoise.py:272-277``) into the jitted step. On the card kernel F
(``csrc/filtered_tail.cu``) computes them in one pass: persistent CTAs
walk 32x16 tiles, each tile's inputs landing in a shared-memory ring
(by TMA where :func:`filtered_tail_loader` allows it), K4 per pixel and
on the one-pixel halo, the tone's YCoCg neighbourhood from shared memory
and warp shuffles, K5's clamp, blend and early-out, and the words.
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib
from .accumulate import accumulate_filtered_data
from .frame import has_history
from .taa import taa
from .warp import pack_pairs_bf16
from ..profiling import stage


#: the bytes TMA wants of a tensor's address and of its row stride
TMA_ALIGN = 16
#: the C entry's variant of each loader (0 is K4 alone, without TAA)
VARIANTS = {"threads": 1, "tma": 2}


def filtered_tail_loader(W, addresses):
    """How kernel F fills its ring at width ``W``: ``"tma"`` (one thread
    issues a tile's TMA box copies a tile ahead) where the row stride of
    a plane (``4 W`` bytes) and the address of every tensor TMA reads
    (``addresses``: the byte addresses of filtered, planes, albedo and
    prev_pixels, f32 ``[C, H, W]`` each) are multiples of
    :data:`TMA_ALIGN`, so that every plane of them is too; else
    ``"threads"`` (every thread's own 4 B loads, the same kernel body).
    The persistent grid (the card's SMs times the CTAs that fit on one,
    never more than the 32x16 tiles) is the C entry's, which asks the
    card."""
    aligned = (4 * W) % TMA_ALIGN == 0 and all(
        a % TMA_ALIGN == 0 for a in addresses)
    return "tma" if aligned else "threads"


def filtered_tail_reference(cfg, filtered, planes, albedo, spp, prev_pixels,
                            frame, history=None, pack=None, into=None):
    """Plain PyTorch version of :func:`filtered_tail`:
    :func:`~bmfr_tpu_torch.ops.accumulate.accumulate_filtered_data`, then
    :func:`~bmfr_tpu_torch.ops.taa.taa`, then with ``pack`` words 5:8 or
    with ``into`` its out and result."""
    H, W = filtered.shape[-2:]
    _lib.check_destinations(pack, into, H, W, filtered.device)
    with stage("k4_accumulate_filtered"):
        out, tone = accumulate_filtered_data(cfg, filtered, planes, albedo,
                                             spp, frame, history)
    result = taa(cfg, prev_pixels, tone, planes, frame, history)
    if pack is not None:
        with stage("state_pack"):
            pack_pairs_bf16([*out, *result], out=pack[5:8])
    if into is not None:
        with stage("state_pack"):
            into.out.copy_(out)
            into.result.copy_(result)
        out, result = into.out, into.result
    return out, tone, result


def filtered_tail(cfg, filtered, planes, albedo, spp, prev_pixels, frame,
                  history=None, pack=None, into=None):
    """K4 and K5 of one frame: ``(out, tone, result)``, f32 ``[3, H, W]``
    each (``result`` is ``tone`` itself where K5 passes the frame
    through, no history or ``skip_taa``, unless ``into`` is given) and,
    with ``pack`` (a :class:`~bmfr_tpu_torch.pipeline.denoise.
    PackedState`'s i32 ``[8, H, W]``), words 5:8 (out and result as bf16
    pairs) written in place; words 0:5 are left alone. With ``into`` (a
    :class:`~bmfr_tpu_torch.pipeline.state.TemporalState` of six distinct
    contiguous tensors, never with ``pack``), ``out`` and ``result`` are
    written into ``into.out`` and ``into.result`` (and returned as those
    tensors; where K5 passes the frame through, ``into.result`` gets a
    copy of the tone, so the carry never aliases ``tone``); its other
    fields are left alone.

    ``filtered``: the fitter's output f32 ``[3, H, W]``; ``planes``: the
    warp's 13 blend planes (K4 reads 4 and 6:9, K5 9:13); ``albedo``: f32
    ``[3, H, W]``; ``spp``: K1's new u8 ``[H, W]``; ``prev_pixels``: K1's
    map f32 ``[2, H, W]`` (K5's off-screen early-out);
    ``frame``/``history``: whether the frame reads history
    (:func:`~bmfr_tpu_torch.ops.frame.has_history`).

    On a CUDA tensor this launches kernel F, which equals
    :func:`filtered_tail_reference` (with TAA its ring filled as
    :func:`filtered_tail_loader` picks); on a CPU tensor it runs that
    plain version. Any other device raises, and so does a tensor map that
    cannot be encoded."""
    dev = filtered.device
    if dev.type == "cpu":
        return filtered_tail_reference(cfg, filtered, planes, albedo, spp,
                                       prev_pixels, frame, history, pack,
                                       into)
    if dev.type != "cuda":
        raise ValueError(f"filtered_tail: unsupported device {dev}")
    H, W = filtered.shape[-2:]
    _lib.check_destinations(pack, into, H, W, dev)
    _lib.check_tensor(filtered, "filtered", torch.float32, (3, H, W), dev)
    _lib.check_tensor(planes, "planes", torch.float32, (13, H, W), dev)
    _lib.check_tensor(albedo, "albedo", torch.float32, (3, H, W), dev)
    _lib.check_tensor(spp, "spp", torch.uint8, (H, W), dev)
    _lib.check_tensor(prev_pixels, "prev_pixels", torch.float32, (2, H, W),
                      dev)
    if pack is not None:
        _lib.check_tensor(pack, "pack", torch.int32, (8, H, W), dev)
    hist = has_history(frame, history)
    run_taa = hist and not cfg.skip_taa
    tone = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    if into is None:
        out = torch.empty_like(tone)
        result = torch.empty_like(tone) if run_taa else tone
    else:
        # the K4-only kernel stores the tone into a result of its own too
        out, result = into.out, into.result
    variant = 0
    if run_taa:
        variant = VARIANTS[filtered_tail_loader(
            W, [t.data_ptr() for t in (filtered, planes, albedo,
                                       prev_pixels)])]
    alpha = np.float32(cfg.taa_blend_alpha)
    _lib.launch("bmfr_filtered_tail", filtered.data_ptr(), planes.data_ptr(),
                albedo.data_ptr(), spp.data_ptr(), prev_pixels.data_ptr(),
                out.data_ptr(), tone.data_ptr(), result.data_ptr(),
                None if pack is None else pack.data_ptr(), H, W,
                float(np.float32(cfg.second_blend_alpha)), float(alpha),
                float(np.float32(1.0) - alpha),
                int(cfg.residual_dtype == "bfloat16"),
                int(hist and not cfg.skip_second_accum), variant)
    _lib.count_launch(filtered_tail)
    return out, tone, result


#: kernel launches since the count was last set to 0
filtered_tail.launches = 0
