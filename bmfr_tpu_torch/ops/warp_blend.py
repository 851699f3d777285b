"""The fused temporal warp + per-stage blend (kernel A) and its plain
PyTorch version.

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
"""

from __future__ import annotations

import numpy as np
import torch

from . import _lib
from .gather import TAP_OFFSETS, bilinear_weights, floor_int, in_bounds
from .warp import unpack_pairs_bf16

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
        bits |= torch.where(in_bounds(iy + dy, ix + dx, H, W), 1 << i, 0
                            ).to(torch.int32)
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


def warp_blend_reference(cfg, src8, positions, normals, pfx, pfy):
    """Plain PyTorch version of :func:`warp_blend`: unpack the state,
    gather the four clipped taps, blend."""
    H, W = pfx.shape
    ix = floor_int(pfx)
    iy = floor_int(pfy)
    fx = pfx - ix.float()
    fy = pfy - iy.float()
    stk = unpack_pairs_bf16(src8, 16)                   # [16, H, W]
    taps = [stk[:, (iy + dy).clamp(0, H - 1), (ix + dx).clamp(0, W - 1)]
            for dx, dy in TAP_OFFSETS]
    cur6 = torch.cat([positions, normals], dim=0)
    return blend_from_taps(cfg, *taps, cur6, mask_bits(iy, ix, H, W),
                           fx, fy)


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
    warp_blend.launches += 1
    return out


#: kernel launches since the count was last set to 0
warp_blend.launches = 0
