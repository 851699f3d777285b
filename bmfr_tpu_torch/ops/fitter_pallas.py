"""The block fitter (kernel D) and its plain PyTorch version.

Replaces the TPU's ``_fitter_kernel`` (``bmfr_tpu/ops/fitter_pallas.py``,
entry ``fit_blocks_pallas``): from pre-built blocks ``[n_blocks,
buffer_count, block_pixels]`` in the storage dtype (any ``block_edge``
8..64, 4..16 columns), the min/max rescale, the storage rounding, the hash
noise, the Householder reflections with the storage rounding after each,
and the back substitution, all in one kernel. Blocks of up to 1024 pixels
are held in registers (``csrc/householder_blocks.cu``), larger ones in
shared memory (``csrc/householder_blocks_smem.cu``);
:func:`launch_geometry` picks the route and its launch shape. The plain
version is the Householder path of
:func:`~bmfr_tpu_torch.ops.fitter.fit_blocks_reference`, which has the
same rounding points (``fitter_pallas.py:112, :114-118, :140``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..rng import noise_amp
from . import _lib
from .blockify import storage_dtype
from .fitter import fit_blocks_reference
from .frame import frame_tensor

#: storage dtype -> the kernels' tmp-dtype / rounding-mode code
MODE = {"float32": 0, "float16": 1, "bfloat16": 2}
#: columns (features + colours) kernel D takes, and the dynamic shared
#: memory a CTA may opt in to on the H100 (227 KB)
MIN_BUFFERS, MAX_BUFFERS = 4, 16
MAX_SMEM = 232448
#: threads of a CTA, rows a thread holds on the register route, and the
#: block size (pixels) up to which that route holds a block
THREADS, ROWS = 256, 4
MAX_REGISTER_PIXELS = THREADS * ROWS
F32 = 4


class Geometry(NamedTuple):
    """How kernel D is launched for one block shape."""

    route: str            # "registers" or "shared"
    group: int            # threads that fit one block
    blocks_per_cta: int
    smem_bytes: int       # dynamic shared memory per CTA
    rows_per_thread: int
    reg_columns: int      # shared route: trailing columns kept in registers


def launch_geometry(block_edge: int, columns: int) -> Geometry:
    """Kernel D's launch shape for ``block_edge`` and ``columns`` (features
    + colours); the same for every storage dtype (the block is held in
    f32).

    Up to 1024 pixels, a group of ``bp / 4`` threads (rounded up to whole
    warps above 32) holds 4 rows each in registers, and a CTA of at most
    256 threads fits ``256 // group`` blocks; its shared memory is the
    reductions' scratch. Larger blocks take one CTA of 256 threads with
    the columns in shared memory; where they do not fit (block_edge 64
    with 15 or 16 columns) the last 1 or 2 colour columns stay in
    registers, 16 rows a thread.
    """
    bp = block_edge * block_edge
    if block_edge < 8 or block_edge % 8:
        raise ValueError(f"block_edge {block_edge}: a multiple of 8, >= 8")
    if not MIN_BUFFERS <= columns <= MAX_BUFFERS:
        raise ValueError(f"kernel D takes {MIN_BUFFERS}..{MAX_BUFFERS} "
                         f"columns, not {columns}")
    if bp <= MAX_REGISTER_PIXELS:
        group = bp // ROWS
        if group > 32:
            group = -(-group // 32) * 32
        per_cta = THREADS // group
        warps = -(-per_cta * group // 32)
        # red [2][warps][2 columns], rows [2][blocks][columns],
        # back-substitution rows [blocks][columns][16]
        smem = F32 * (2 * warps * 2 * columns + 2 * per_cta * columns
                      + per_cta * columns * 16)
        return Geometry("registers", group, per_cta, smem, ROWS, 0)
    # red [2][8][2 columns], pivot rows [2][columns], rhs [2][16]
    scratch = F32 * (2 * (THREADS // 32) * 2 * columns + 2 * columns + 2 * 16)
    for reg in (0, 1, 2) if bp == 4096 else (0,):
        smem = F32 * (columns - reg) * bp + scratch
        if smem <= MAX_SMEM:
            return Geometry("shared", THREADS, 1, smem, -(-bp // THREADS),
                            reg)
    raise ValueError(f"{columns} columns of {bp} pixels do not fit kernel D")


def fit_blocks_pallas_reference(cfg, tmp_blocks, frame):
    """Plain PyTorch version of :func:`fit_blocks_pallas`."""
    return fit_blocks_reference(cfg.replace(solver="householder"),
                                tmp_blocks, frame)


def fit_blocks_pallas(cfg, tmp_blocks, frame):
    """Householder fit of every block (the JAX ``fit_blocks_pallas``'s
    signature and outputs): tmp_blocks ``[n_blocks, buffer_count,
    block_pixels]`` in the storage dtype -> (weights f32 ``[n_blocks, F,
    3]``, mins_maxs f32 ``[n_blocks, n_scaled, 2]``).

    On a CUDA tensor this launches the kernel, which reads ``frame`` (a
    host int or a 0-d int32 tensor on the card) there and hashes the
    noise itself; on a CPU tensor it runs
    :func:`fit_blocks_pallas_reference`. Any other device raises.
    """
    dev = tmp_blocks.device
    if dev.type == "cpu":
        return fit_blocks_pallas_reference(cfg, tmp_blocks, frame)
    if dev.type != "cuda":
        raise ValueError(f"fit_blocks_pallas: unsupported device {dev}")
    nb, B, bp = cfg.n_blocks, cfg.buffer_count, cfg.block_pixels
    F, lo = cfg.feature_count, cfg.features_not_scaled_count
    _lib.check_tensor(tmp_blocks, "tmp_blocks", storage_dtype(cfg),
                      (nb, B, bp), dev)
    if tmp_blocks.data_ptr() % 16:
        raise ValueError("fit_blocks_pallas: tmp_blocks must be 16-byte "
                         "aligned (vector loads)")
    geo = launch_geometry(cfg.block_edge, B)
    ft = frame_tensor(frame, dev)
    amp = noise_amp(cfg.noise_amount)
    weights = torch.empty((nb, F, 3), dtype=torch.float32, device=dev)
    mins_maxs = torch.empty((nb, F - lo, 2), dtype=torch.float32,
                            device=dev)
    ptrs = (tmp_blocks.data_ptr(), weights.data_ptr(), mins_maxs.data_ptr(),
            nb, B, lo, bp, MODE[cfg.tmp_data_dtype])
    if geo.route == "registers":
        _lib.launch("bmfr_fit_blocks_registers", *ptrs, geo.group,
                    geo.blocks_per_cta, geo.smem_bytes, ft.data_ptr(), amp)
    else:
        _lib.launch("bmfr_fit_blocks_shared", *ptrs, geo.reg_columns,
                    geo.smem_bytes, ft.data_ptr(), amp)
    _lib.count_launch(fit_blocks_pallas)
    return weights, mins_maxs


#: kernel launches since the count was last set to 0
fit_blocks_pallas.launches = 0
