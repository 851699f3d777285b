"""Stage K2 — the blockwise multi-order least-squares fit, plain PyTorch
(port of :mod:`bmfr_tpu.ops.fitter`; opencl/bmfr.cl:490-700).

Per block of ``[n_blocks, buffer_count, block_pixels]`` tmp data: the
min/max rescale of the scaled features, the storage-dtype round trip,
the hash noise on the feature columns, then either ``feature_count``
Householder reflections (with the storage rounding after each) and a
triangular solve, or the normal equations solved by Cholesky. The
reference's cross-colour reflections only touch rows the solve never
reads and are skipped, as in the JAX package (``fitter.py:19-23``).

:func:`fit_blocks` dispatches like the JAX one: ``"auto"``,
``"pallas"`` and ``"pallas_direct"`` go to kernel D
(:func:`~bmfr_tpu_torch.ops.fitter_pallas.fit_blocks_pallas`, which
runs its plain version on a CPU tensor); ``"xla"`` selects the plain
path on any device; the Cholesky solver always takes the plain path
(the JAX package solves it outside any kernel too), and ``"pallas"``
with it is an error.

Every matmul here runs in full f32: TF32 would round the operands, and
the normal equations cancel catastrophically under that (the TPU's bf16
twin of this trap NaN-ed most blocks of a full-resolution frame).
"""

from __future__ import annotations

import contextlib

import torch

from ..rng import feature_noise
from .blockify import storage_dtype


@contextlib.contextmanager
def highest_precision():
    """f32 matmuls without TF32 (``Precision.HIGHEST`` in the JAX
    package) for the duration of the block."""
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(prev)


def scale_blocks(cfg, data):
    """Per-block min/max rescale of the scaled features
    (opencl/bmfr.cl:511-542). data: f32 ``[n_blocks, B, bp]``. Returns
    (scaled data, mins_maxs f32 ``[n_blocks, n_scaled, 2]``)."""
    lo, hi = cfg.features_not_scaled_count, cfg.feature_count
    sub = data[:, lo:hi]
    bmin = sub.amin(dim=-1)
    bmax = sub.amax(dim=-1)
    scaled = scale_with_mins_maxs(sub, bmin[..., None], bmax[..., None])
    data = torch.cat([data[:, :lo], scaled, data[:, hi:]], dim=1)
    return data, torch.stack([bmin, bmax], dim=-1)


def scale_with_mins_maxs(values, bmin, bmax):
    """The conditional rescale: divide by ``bmax - bmin`` only where
    ``|bmax - bmin| > 1`` (opencl/bmfr.cl:200-205, :737-741)."""
    rng_ = bmax - bmin
    denom = torch.where(rng_.abs() > 1.0, rng_, 1.0)
    return (values - bmin) / denom


def storage_roundtrip(cfg, x):
    """Round f32 ``x`` through the storage dtype (nearest-even; f16
    overflows to inf, as a half store does)."""
    if cfg.tmp_data_dtype == "float32":
        return x
    return x.to(storage_dtype(cfg)).float()


def householder_qr_weights(cfg, data):
    """Batched Householder QR + triangular solve (``fitter.py:77-125``).
    data: f32 ``[n_blocks, B, bp]``, features first, colours last,
    scaled and noised. Returns weights f32 ``[n_blocks, F, 3]``."""
    F, B, bp = cfg.feature_count, cfg.buffer_count, cfg.block_pixels
    elem = torch.arange(bp, device=data.device)
    T = data
    for col in range(F):
        v = T[:, col]                                   # [nb, bp]
        tail = torch.where(elem > col, v, 0.0)
        sigma = (tail * tail).sum(dim=-1)               # [nb]
        pivot = v[:, col]
        # vec_length = sqrt(sigma + pivot^2) (opencl/bmfr.cl:583)
        vec_len = torch.sqrt(sigma + pivot * pivot)
        head = pivot - vec_len
        u_len_sq = sigma + head * head
        u = torch.where(elem == col, head[:, None], tail)

        # reflect the trailing columns (features col+1.. and the colours)
        rest = T[:, col + 1:]                           # [nb, B-col-1, bp]
        with highest_precision():
            dots = torch.einsum("be,bfe->bf", u, rest)
        coef = 2.0 / u_len_sq
        rest = rest - coef[:, None, None] * dots[:, :, None] * u[:, None, :]
        rest = storage_roundtrip(cfg, rest)

        # column col becomes (r_0..r_{col-1}, vec_length, 0...), the
        # explicit r_value stores (opencl/bmfr.cl:574-594)
        new_col = torch.where(elem < col, v, 0.0)
        new_col = torch.where(elem == col, vec_len[:, None], new_col)
        T = torch.cat([T[:, :col], new_col[:, None], rest], dim=1)

    # R[row e, col f] = T[f, e] (upper triangular); rhs rows of the colours
    R = T[:, :F, :F].transpose(1, 2).triu()
    rhs = T[:, F:B, :F].transpose(1, 2)
    return torch.linalg.solve_triangular(R, rhs, upper=True)


def gram(data, F):
    """Per-block ``data[:, :F] @ data^T`` -> ``[nb, F, B]`` in full f32:
    the Gram matrix (columns ``:F``) and the right-hand sides
    (columns ``F:``)."""
    with highest_precision():
        return torch.einsum("bfe,bge->bfg", data[:, :F], data)


def cholesky_solve(G, F):
    """``_chol_kernel``'s unrolled Cholesky + forward/back solves over
    ``[n_blocks]`` vectors (``fitter_direct.py:558-589``), so a failed
    pivot takes the same NaN path (``torch.linalg.cholesky`` would raise,
    ``cholesky_ex`` leaves finite garbage). ``G``: ``[nb, F, F+3]``.
    Returns weights ``[nb, F, 3]`` with NaN -> 0."""
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


def cholesky_weights(cfg, data):
    """Normal-equations solve (``fitter.py:128-149``): singular blocks
    (NaN from the factorization) get zero weights."""
    F = cfg.feature_count
    return cholesky_solve(gram(data, F), F)


def fit_blocks_reference(cfg, tmp_blocks, frame):
    """The plain fitter: scale -> storage round -> noise -> solve with
    ``cfg.solver`` (``fitter.py:187-199``). Returns (weights f32
    ``[n_blocks, F, 3]``, mins_maxs f32 ``[n_blocks, n_scaled, 2]``)."""
    data, mins_maxs = scale_blocks(cfg, tmp_blocks.float())
    data = storage_roundtrip(cfg, data)
    F = cfg.feature_count
    noise = feature_noise(frame, F, cfg.block_pixels, cfg.buffer_count,
                          cfg.noise_amount, data.device)
    data = torch.cat([data[:, :F] + noise[None], data[:, F:]], dim=1)
    if cfg.solver == "cholesky":
        return cholesky_weights(cfg, data), mins_maxs
    return householder_qr_weights(cfg, data), mins_maxs


def fit_blocks(cfg, tmp_blocks, frame, impl=None):
    """Full fitter stage (``fitter.py:152-199``). tmp_blocks: ``[n_blocks,
    buffer_count, block_pixels]`` in the storage dtype, from
    :func:`~bmfr_tpu_torch.ops.blockify.build_feature_blocks`. Returns
    (weights f32 ``[n_blocks, F, 3]``, mins_maxs f32
    ``[n_blocks, n_scaled, 2]``)."""
    requested = impl or cfg.fitter_impl
    # the planes-direct entries take raw planes; through this block API
    # "pallas_direct" is the block kernel, as in the JAX package
    impl = "pallas" if requested in ("auto", "pallas",
                                     "pallas_direct") else requested
    if cfg.solver != "householder" and impl == "pallas":
        # kernel D implements only the Householder QR; the solver choice
        # wins over the backend choice
        if requested == "pallas":
            raise ValueError(
                f"solver={cfg.solver!r} is not implemented by the block "
                "fitter kernel; use fitter_impl='xla' or 'auto'")
        impl = "xla"
    if impl == "pallas":
        from .fitter_pallas import fit_blocks_pallas

        return fit_blocks_pallas(cfg, tmp_blocks, frame)
    return fit_blocks_reference(cfg, tmp_blocks, frame)
