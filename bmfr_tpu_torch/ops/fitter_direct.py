"""The fused per-block fit and reconstruction with the Cholesky solver
(kernel B) and its plain PyTorch version.

Replaces the TPU's ``_chol_kernel`` (``bmfr_tpu/ops/fitter_direct.py``,
entry ``fit_reconstruct_cholesky``) together with the inverse-jitter
slice that followed it (``pipeline/denoise.py:218-225``). For every
32x32 block of the jittered margins grid (``blocks_y x blocks_x``, 984 at
1280x720):

1. gather the block's pixels from the mirror-addressed normals,
   positions and accumulated colour (:func:`blockify.jittered_view`);
2. build the 10 features and 3 colours, NaN -> 0
   (``fitter_direct.py:165-217``, the float32 tmp store);
3. rescale the 6 scaled features by the block min/max, with denominator
   ``rmax - rmin`` only where ``|rmax - rmin| > 1``;
4. add the hash noise ``noise[f, e]`` (``e = x_in + 32*y_in``, row 0 zero);
5. form the 10x13 Gram/rhs sums in plain f32;
6. solve by Cholesky in ``_chol_kernel``'s loop order (``:558-589``),
   NaN weights -> 0;
7. reconstruct ``max(sum_f w_f * basis_f, 0)`` with the basis built from
   the unsanitized, noise-free features, and keep the in-image cells.

Returns ``(filtered f32[3, H, W], weights f32[n_blocks, F, 3])`` (the
weights in the layout of the JAX package's ``fit_blocks``).
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_FEATURES_NOT_SCALED, DEFAULT_FEATURES_SCALED
from ..features import evaluate_features
from ..rng import feature_noise
from . import _lib
from .blockify import jitter_offset, jittered_view

BLOCK_EDGE = 32
DEFAULT_FEATURES = DEFAULT_FEATURES_NOT_SCALED + DEFAULT_FEATURES_SCALED


def _check_cfg(cfg):
    if cfg.block_edge != BLOCK_EDGE:
        raise NotImplementedError("the direct fitter needs 32x32 blocks")
    if cfg.all_features != DEFAULT_FEATURES:
        raise NotImplementedError(
            "the fitter kernel evaluates the default feature basis only "
            "(ROADMAP Queue 1 #9)")
    if cfg.tmp_data_dtype != "float32":
        raise NotImplementedError(
            f"tmp_data_dtype={cfg.tmp_data_dtype!r}: only float32 is "
            "ported (ROADMAP Queue 1 #9)")


def _frame_noise(cfg, frame, device):
    return feature_noise(frame, cfg.feature_count, cfg.block_pixels,
                         cfg.buffer_count, cfg.noise_amount, device)


def _gram(data, F):
    """Per-block ``data[:, :F] @ data^T`` -> ``[nb, F, B]`` in full f32:
    TF32 would round the operands, and the normal equations cancel
    catastrophically under that (the TPU's bf16 twin of this trap
    NaN-ed most blocks of a full-resolution frame)."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        return torch.einsum("bfe,bge->bfg", data[:, :F], data)
    finally:
        torch.set_float32_matmul_precision(prev)


def _cholesky_solve(G, F):
    """``_chol_kernel``'s unrolled Cholesky + forward/back solves over
    ``[n_blocks]`` vectors, so a failed pivot takes the same NaN path
    (``torch.linalg.cholesky`` would raise, ``cholesky_ex`` leaves finite
    garbage). ``G``: ``[nb, F, F+3]``. Returns weights ``[nb, F, 3]``
    with NaN -> 0."""
    L = [[None] * F for _ in range(F)]
    for j in range(F):
        d = G[:, j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(d)
        for i in range(j + 1, F):
            v = G[:, j, i]
            for k in range(j):
                v = v - L[i][k] * L[j][k]
            L[i][j] = v / L[j][j]
    y = [None] * F
    for i in range(F):
        v = G[:, i, F:F + 3]                            # [nb, 3]
        for k in range(i):
            v = v - L[i][k][:, None] * y[k]
        y[i] = v / L[i][i][:, None]
    x = [None] * F
    for i in reversed(range(F)):
        v = y[i]
        for k in range(i + 1, F):
            v = v - L[k][i][:, None] * x[k]
        x[i] = v / L[i][i][:, None]
    w = torch.stack(x, dim=1)                           # [nb, F, 3]
    return torch.where(torch.isnan(w), 0.0, w)


def fit_reconstruct_cholesky_reference(cfg, normals, positions, accum,
                                       frame):
    """Plain PyTorch version of :func:`fit_reconstruct_cholesky`."""
    _check_cfg(cfg)
    H, W = normals.shape[-2:]
    F = cfg.feature_count
    lo = cfg.features_not_scaled_count
    be = cfg.block_edge
    nby, nbx = cfg.blocks_y, cfg.blocks_x
    nb = nby * nbx

    raw9 = torch.cat([normals, positions, accum], dim=0)
    view = jittered_view(cfg, raw9, frame)              # [9, mh, mw]
    blocks = view.reshape(9, nby, be, nbx, be).permute(0, 1, 3, 2, 4)
    blocks = blocks.reshape(9, nb, be * be)             # [9, nb, bp]

    feat = evaluate_features(cfg.all_features, blocks[0:3], blocks[3:6])
    data = torch.cat([feat, blocks[6:9]], dim=0)        # [B, nb, bp]
    data = torch.where(torch.isnan(data), 0.0, data)
    sub = data[lo:F]
    rmin = sub.amin(dim=-1, keepdim=True)
    rmax = sub.amax(dim=-1, keepdim=True)
    rng_ = rmax - rmin
    denom = torch.where(rng_.abs() > 1.0, rng_, 1.0)
    basis = torch.cat([feat[:lo], (feat[lo:F] - rmin) / denom], dim=0)
    data = torch.cat([data[:lo], (sub - rmin) / denom, data[F:]], dim=0)
    noise = _frame_noise(cfg, frame, normals.device)    # [F, bp]
    data = torch.cat([data[:F] + noise[:, None, :], data[F:]], dim=0)

    G = _gram(data.permute(1, 0, 2), F)                 # [nb, F, B]
    w = _cholesky_solve(G, F)                           # [nb, F, 3]

    color = torch.zeros((nb, 3, be * be), dtype=torch.float32,
                        device=normals.device)
    basis = basis.permute(1, 0, 2)                      # [nb, F, bp]
    for f in range(F):
        color = color + basis[:, f, None, :] * w[:, f, :, None]
    color = torch.maximum(color, torch.zeros((), device=color.device))

    # unblock + inverse jitter: image (y, x) = view cell
    # (y + half - oy, x + half - ox) (opencl/bmfr.cl:718-722)
    fview = color.reshape(nby, nbx, 3, be, be).permute(2, 0, 3, 1, 4)
    fview = fview.reshape(3, nby * be, nbx * be)
    half = be // 2
    ox, oy = jitter_offset(frame)
    filtered = fview[:, half - oy:half - oy + H, half - ox:half - ox + W]
    return filtered.contiguous(), w


def fit_reconstruct_cholesky(cfg, normals, positions, accum, frame):
    """Fit every block of frame ``frame`` and reconstruct the filtered
    image. ``normals``/``positions``/``accum``: f32 ``[3, H, W]``.
    Returns ``(filtered f32[3, H, W], weights f32[n_blocks, F, 3])``.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`fit_reconstruct_cholesky_reference`. Any other device raises.
    """
    dev = normals.device
    if dev.type == "cpu":
        return fit_reconstruct_cholesky_reference(cfg, normals, positions,
                                                  accum, frame)
    if dev.type != "cuda":
        raise ValueError(f"fit_reconstruct_cholesky: unsupported device "
                         f"{dev}")
    _check_cfg(cfg)
    H, W = cfg.image_height, cfg.image_width
    F = cfg.feature_count
    for t, name in ((normals, "normals"), (positions, "positions"),
                    (accum, "accum")):
        _lib.check_tensor(t, name, torch.float32, (3, H, W), dev)
    noise = _frame_noise(cfg, frame, dev)
    out = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    weights = torch.empty((cfg.n_blocks, F, 3), dtype=torch.float32,
                          device=dev)
    ox, oy = jitter_offset(frame)
    _lib.launch("bmfr_fit_reconstruct_cholesky", normals.data_ptr(),
                positions.data_ptr(), accum.data_ptr(), noise.data_ptr(),
                out.data_ptr(), weights.data_ptr(), H, W, cfg.blocks_x,
                cfg.blocks_y, ox, oy)
    fit_reconstruct_cholesky.launches += 1
    return out, weights


#: kernel launches since the count was last set to 0
fit_reconstruct_cholesky.launches = 0
