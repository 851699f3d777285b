"""The fused temporal warp + per-stage blend (kernel A), the raw-plane
tap warp + blend (kernel I), and their plain PyTorch versions.

Replaces the TPU's ``_blend_kernel3`` (``bmfr_tpu/ops/warp_pallas.py``,
entry ``warp_blend_pallas``). For every pixel it reads the four clipped
bilinear taps ``(clip(iy+dy), clip(ix+dx))`` of the 16 recurrent
channels from the bf16 channel-pair state pack, gates them by the K1
position/normal limits and the K5 border masks, and emits the 13 blend
planes of :func:`blend_from_taps`.

The GPU has a hardware gather, so the TPU kernel's window plan, claim
maps, depth phases, fix-up and fallback tiers and padded carry have no
counterpart: a direct clipped gather gives exactly the taps of the JAX
package's exact tier (``blend_from_rows`` over ``gather_planes``). Its
``ix < 0`` rule (bit 8) holds by construction: at ``ix = -1`` both
``clip(ix)`` and ``clip(ix + 1)`` are column 0.

:func:`warp_blend_planes` (kernel I, ``csrc/warp_taps.cu``) replaces what
XLA fuses on the TPU on every other warp mode: ``stack_state``,
``gather_taps`` and the tap branches (``bmfr_tpu/pipeline/denoise.py:
115-119``, ``bmfr_tpu/ops/warp.py:65``, ``reproject.py:78-114``,
``accumulate.py:32-55``, ``taa.py:72-97``). It gathers the taps straight
from the raw-plane state's six tensors and blends them as
:func:`blend_from_taps` does, with no stacked copy and no tap tensor.
The bf16 modes round each tap to bf16 (nearest-even), which is what
their packs hold; ``packed_x_bf16`` also keeps its words' columns (at
``ix = INT_MAX`` the dx = 1 taps read column ``W - 1``, not the wrapped
column 0 of ``clip(ix + 1)``).
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib
from .gather import TAP_OFFSETS, bilinear_weights, floor_int, in_bounds
from .warp import add_wrap, gather_taps, unpack_pairs_bf16

#: Output planes: 0-2 K1 weighted prev-color sum, 3 K1 spp sum, 4 K1/K4
#: total weight, 5 accept bits, 6-8 K4 weighted out sum, 9-11 K5
#: weighted result sum, 12 K5 total weight.
BLEND_PLANES = 13


def blend_from_taps(cfg, t0, t1, t2, t3, cur6, bits, fx, fy):
    """Resolved f32 tap stacks ``[16, ...]`` (reference tap order) -> the
    13 per-stage blend planes (``warp_pallas.py:427-494``).

    cur6: f32 ``[6, ...]`` current positions 0:3 + normals 3:6. bits: the
    :func:`mask_bits` field. fx/fy: the bilinear fractions. Pixels whose
    reprojection is fully off screen are don't-cares for the K5 planes
    (taa passes them through, opencl/bmfr.cl:884-890).
    """
    f32 = torch.float32
    negb = ((bits >> 8) & 1) > 0
    taps = (t0, torch.where(negb, t0, t1), t2, torch.where(negb, t2, t3))
    w = bilinear_weights(fx, fy)

    shape = t0.shape[1:]
    dev = t0.device
    pc = torch.zeros((3,) + shape, dtype=f32, device=dev)
    spp_sum = torch.zeros(shape, dtype=f32, device=dev)
    tw = torch.zeros(shape, dtype=f32, device=dev)
    accept = torch.zeros(shape, dtype=torch.int32, device=dev)
    k4 = torch.zeros((3,) + shape, dtype=f32, device=dev)
    k5 = torch.zeros((3,) + shape, dtype=f32, device=dev)
    k5w = torch.zeros(shape, dtype=f32, device=dev)
    pos_lim = float(np.float32(cfg.position_limit_squared))
    nrm_lim = float(np.float32(cfg.normal_limit_squared))

    for i in range(4):
        t = taps[i]
        inb = ((bits >> i) & 1) > 0
        pd = t[0:3] - cur6[0:3]
        nd = t[3:6] - cur6[3:6]
        ok = (inb
              & ((pd[0] * pd[0] + pd[1] * pd[1] + pd[2] * pd[2]) < pos_lim)
              & ((nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2]) < nrm_lim))
        wgt = torch.where(ok, w[i], 0.0)
        pc = pc + wgt[None] * t[6:9]
        spp_sum = spp_sum + wgt * t[9]
        tw = tw + wgt
        accept = accept | torch.where(ok, 1 << i, 0).to(torch.int32)
        k4 = k4 + wgt[None] * t[10:13]
        wm = torch.where(((bits >> (4 + i)) & 1) > 0, w[i], 0.0)
        k5 = k5 + wm[None] * t[13:16]
        k5w = k5w + wm

    return torch.cat([pc, spp_sum[None], tw[None], accept.to(f32)[None],
                      k4, k5, k5w[None]], dim=0)


def mask_bits(iy, ix, H, W):
    """The per-pixel mask bitfield consumed by :func:`blend_from_taps`
    (``warp_pallas.py:497-515``): bits 0..3 K1 tap in-bounds, 4..7 K5 tap
    masks, 8 the ``ix < 0`` edge."""
    bits = torch.zeros(iy.shape, dtype=torch.int32, device=iy.device)
    for i, (dx, dy) in enumerate(TAP_OFFSETS):
        inb = in_bounds(add_wrap(iy, dy), add_wrap(ix, dx), H, W)
        bits |= torch.where(inb, 1 << i, 0).to(torch.int32)
    # K5's tap masks (taa's border logic, opencl/bmfr.cl:929-960)
    x_lo = ix >= 0
    x_hi = ix < W - 1
    y_lo = iy >= 0
    y_hi = iy < H - 1
    for i, m in enumerate((y_lo & x_lo, y_lo & x_hi,
                           y_hi & x_lo, y_hi & x_hi)):
        bits |= torch.where(m, 1 << (4 + i), 0).to(torch.int32)
    bits |= torch.where(ix < 0, 1 << 8, 0).to(torch.int32)
    return bits


def blend_gathered_taps(cfg, taps, positions, normals, pfx, pfy):
    """The tap branches of K1, K4 and K5 (``reproject.py:78-114``,
    ``accumulate.py:32-55``, ``taa.py:72-97``) in one pass: the four
    gathered taps ``f32[4, 16, H, W]`` of the 16 recurrent channels
    (:func:`~bmfr_tpu_torch.ops.warp.gather_taps` of
    ``TemporalState.stacked()``) -> the 13 blend planes the stages read.
    K1 weights a tap by its screen bounds and the position/normal
    limits and records that as the accept bits; K4 reuses those bits;
    K5 takes its own border masks and no limit test (:func:`mask_bits`).
    Each sum runs in the stage's own order, so the planes equal the JAX
    tap branches' sums."""
    H, W = pfx.shape
    ix = floor_int(pfx)
    iy = floor_int(pfy)
    fx = pfx - ix.float()
    fy = pfy - iy.float()
    cur6 = torch.cat([positions, normals], dim=0)
    return blend_from_taps(cfg, *taps, cur6, mask_bits(iy, ix, H, W),
                           fx, fy)


def warp_blend_reference(cfg, src8, positions, normals, pfx, pfy):
    """Plain PyTorch version of :func:`warp_blend`: unpack the state,
    gather the four clipped taps, blend."""
    taps = gather_taps(unpack_pairs_bf16(src8, 16), floor_int(pfy),
                       floor_int(pfx))
    return blend_gathered_taps(cfg, taps, positions, normals, pfx, pfy)


def warp_blend(cfg, src8, positions, normals, pfx, pfy):
    """The 13 blend planes ``f32[13, H, W]`` of the previous state
    ``src8`` (i32 ``[8, H, W]`` channel-pair pack: positions 0:3,
    normals 3:6, noisy 6:9, spp 9, out 10:13, result 13:16) at the
    reprojected coordinates ``pfx``/``pfy`` (f32 ``[H, W]``), gated
    against the current ``positions``/``normals`` (f32 ``[3, H, W]``).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`warp_blend_reference`. Any other device raises.
    """
    dev = pfx.device
    if dev.type == "cpu":
        return warp_blend_reference(cfg, src8, positions, normals, pfx, pfy)
    if dev.type != "cuda":
        raise ValueError(f"warp_blend: unsupported device {dev}")
    H, W = pfx.shape
    _lib.check_tensor(src8, "src8", torch.int32, (8, H, W), dev)
    _lib.check_tensor(positions, "positions", torch.float32, (3, H, W), dev)
    _lib.check_tensor(normals, "normals", torch.float32, (3, H, W), dev)
    _lib.check_tensor(pfx, "pfx", torch.float32, (H, W), dev)
    _lib.check_tensor(pfy, "pfy", torch.float32, (H, W), dev)
    out = torch.empty((BLEND_PLANES, H, W), dtype=torch.float32, device=dev)
    _lib.launch("bmfr_warp_blend", src8.data_ptr(), positions.data_ptr(),
                normals.data_ptr(), pfx.data_ptr(), pfy.data_ptr(),
                out.data_ptr(), H, W,
                float(np.float32(cfg.position_limit_squared)),
                float(np.float32(cfg.normal_limit_squared)))
    _lib.count_launch(warp_blend)
    return out


#: kernel launches since the count was last set to 0
warp_blend.launches = 0

#: the warp modes kernel I serves, by its template code
TAP_MODES = {"float32": 0, "packed_bf16": 1, "packed_x_bf16": 2}


def warp_blend_planes_reference(cfg, state, positions, normals, pfx, pfy,
                                mode):
    """Plain PyTorch version of :func:`warp_blend_planes`: stack the
    state, gather its four clipped taps in warp mode ``mode``, blend."""
    taps = gather_taps(state.stacked(), floor_int(pfy), floor_int(pfx),
                       mode)
    return blend_gathered_taps(cfg, taps, positions, normals, pfx, pfy)


def warp_blend_planes(cfg, state, positions, normals, pfx, pfy, mode):
    """The 13 blend planes ``f32[13, H, W]`` (:func:`blend_from_taps`'
    layout) of the raw-plane previous state ``state`` (a
    :class:`~bmfr_tpu_torch.pipeline.state.TemporalState`: positions,
    normals, noisy, out and result f32 ``[3, H, W]``, spp u8 ``[H, W]``)
    at the reprojected coordinates ``pfx``/``pfy`` (f32 ``[H, W]``),
    gathered in warp mode ``mode`` (``"float32"``, ``"packed_bf16"`` or
    ``"packed_x_bf16"``) and gated against the current
    ``positions``/``normals`` (f32 ``[3, H, W]``).

    On a CUDA tensor this launches kernel I, which reads the state's
    tensors in place; on a CPU tensor it runs
    :func:`warp_blend_planes_reference`. Any other device raises.
    """
    if mode not in TAP_MODES:
        raise ValueError(f"warp_blend_planes: warp mode {mode!r} is not one "
                         f"of {tuple(TAP_MODES)}")
    dev = pfx.device
    if dev.type == "cpu":
        return warp_blend_planes_reference(cfg, state, positions, normals,
                                           pfx, pfy, mode)
    if dev.type != "cuda":
        raise ValueError(f"warp_blend_planes: unsupported device {dev}")
    H, W = pfx.shape
    for name in ("positions", "normals", "noisy", "out", "result"):
        _lib.check_tensor(getattr(state, name), f"state.{name}",
                          torch.float32, (3, H, W), dev)
    _lib.check_tensor(state.spp, "state.spp", torch.uint8, (H, W), dev)
    _lib.check_tensor(positions, "positions", torch.float32, (3, H, W), dev)
    _lib.check_tensor(normals, "normals", torch.float32, (3, H, W), dev)
    _lib.check_tensor(pfx, "pfx", torch.float32, (H, W), dev)
    _lib.check_tensor(pfy, "pfy", torch.float32, (H, W), dev)
    out = torch.empty((BLEND_PLANES, H, W), dtype=torch.float32, device=dev)
    _lib.launch("bmfr_warp_taps", state.positions.data_ptr(),
                state.normals.data_ptr(), state.noisy.data_ptr(),
                state.spp.data_ptr(), state.out.data_ptr(),
                state.result.data_ptr(), positions.data_ptr(),
                normals.data_ptr(), pfx.data_ptr(), pfy.data_ptr(),
                out.data_ptr(), H, W,
                float(np.float32(cfg.position_limit_squared)),
                float(np.float32(cfg.normal_limit_squared)), TAP_MODES[mode])
    _lib.count_launch(warp_blend_planes)
    return out


#: kernel launches since the count was last set to 0
warp_blend_planes.launches = 0
