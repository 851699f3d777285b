"""The block fitter (kernel D) and its plain PyTorch version.

Replaces the TPU's ``_fitter_kernel`` (``bmfr_tpu/ops/fitter_pallas.py``,
entry ``fit_blocks_pallas``) with ``csrc/householder.cu``: from
pre-built blocks ``[n_blocks, buffer_count, block_pixels]`` in the
storage dtype (any ``block_edge`` 8..64), the min/max rescale, the
storage rounding, the hash noise, the Householder reflections with the
storage rounding after each, and the back substitution, all in one
kernel. The plain version is the Householder path of
:func:`~bmfr_tpu_torch.ops.fitter.fit_blocks_reference`, which has the
same rounding points (``fitter_pallas.py:112, :114-118, :140``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..rng import feature_noise
from . import _lib
from .blockify import storage_dtype
from .fitter import fit_blocks_reference

#: storage dtype -> the kernels' tmp-dtype / rounding-mode code
MODE = {"float32": 0, "float16": 1, "bfloat16": 2}
#: columns (features + colours) kernel D takes, and the shared memory a
#: block may use on the card (232,448 B less the kernel's static scratch)
MAX_BUFFERS = 16
MAX_SMEM = 232448 - 1024


def fit_blocks_pallas_reference(cfg, tmp_blocks, frame: int):
    """Plain PyTorch version of :func:`fit_blocks_pallas`."""
    return fit_blocks_reference(cfg.replace(solver="householder"),
                                tmp_blocks, frame)


def fit_blocks_pallas(cfg, tmp_blocks, frame: int):
    """Householder fit of every block (the JAX ``fit_blocks_pallas``'s
    signature and outputs): tmp_blocks ``[n_blocks, buffer_count,
    block_pixels]`` in the storage dtype -> (weights f32 ``[n_blocks, F,
    3]``, mins_maxs f32 ``[n_blocks, n_scaled, 2]``).

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
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
    smem = B * bp * np.dtype(np.float32).itemsize
    if B > MAX_BUFFERS or smem > MAX_SMEM:
        raise ValueError(f"fit_blocks_pallas: {B} columns of {bp} pixels "
                         f"({smem} B) exceed the kernel's shared memory")
    noise = feature_noise(frame, F, bp, B, cfg.noise_amount, dev)
    weights = torch.empty((nb, F, 3), dtype=torch.float32, device=dev)
    mins_maxs = torch.empty((nb, F - lo, 2), dtype=torch.float32,
                            device=dev)
    _lib.launch("bmfr_fit_blocks_householder", tmp_blocks.data_ptr(),
                noise.data_ptr(), weights.data_ptr(), mins_maxs.data_ptr(),
                nb, B, F, lo, bp, MODE[cfg.tmp_data_dtype])
    fit_blocks_pallas.launches += 1
    return weights, mins_maxs


#: kernel launches since the count was last set to 0
fit_blocks_pallas.launches = 0
