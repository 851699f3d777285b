"""The direct fitters: fit every 32x32 block straight from the raw image
planes and reconstruct the filtered image, in one kernel per frame, and
their plain PyTorch versions.

- Kernel B (``csrc/fitter_chol.cu``) replaces the TPU's ``_chol_kernel``
  (``bmfr_tpu/ops/fitter_direct.py``, entry ``fit_reconstruct_cholesky``):
  the normal equations solved by Cholesky, factored and solved on one
  warp in ``_chol_kernel``'s order while the CTA's other warps rescale
  the reconstruction's basis.
- Kernel C (``csrc/householder_direct.cu``) replaces the TPU's
  ``_qr_kernel`` (entries ``fit_reconstruct_direct`` and
  ``fit_blocks_direct``): the reference-exact Householder QR, each
  thread's pixels held in registers.

Both take the same front half (``csrc/fitter_front.cuh``): gather the
block's pixels from the mirror-addressed normals, positions and
accumulated colour (:func:`blockify.jittered_view`); build the 10
features and 3 colours with the K1 store contract (NaN -> 0, f16 clamp,
storage rounding); rescale the 6 scaled features by the block min/max
(denominator ``rmax - rmin`` only where ``|rmax - rmin| > 1``) and round
again; add the hash noise, which the kernels compute themselves from
:func:`~bmfr_tpu_torch.rng.noise_params`. The reconstruction ``max(sum_f w_f basis_f,
0)`` uses the basis built from the pre-rounding, unsanitized, noise-free
f32 features and writes the image directly, which replaces the JAX
pipeline's inverse-jitter slice (``pipeline/denoise.py:218-225``).

The plain versions are the block path the JAX tests hold the direct
kernels to (``tests/test_fitter_direct.py``): ``build_feature_blocks``
-> ``fit_blocks`` (plain, Cholesky or Householder) ->
``weighted_sum_image``.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_FEATURES
from ..rng import noise_params
from . import _lib
from .blockify import build_feature_blocks, jitter_offset
from .fitter import fit_blocks_reference
from .fitter_pallas import MODE
from .weighted_sum import weighted_sum_image

BLOCK_EDGE = 32


def _check_cfg(cfg):
    if cfg.block_edge != BLOCK_EDGE:
        raise NotImplementedError("the direct fitter needs 32x32 blocks")
    if cfg.all_features != DEFAULT_FEATURES:
        raise NotImplementedError(
            "the direct fitter kernels evaluate the default feature basis "
            "only (ROADMAP Queue 2 #6)")


def _fit_plain(cfg, solver, normals, positions, accum, frame):
    cfg = cfg.replace(solver=solver)
    tmp = build_feature_blocks(cfg, normals, positions, accum, frame)
    return fit_blocks_reference(cfg, tmp, frame)


def _reconstruct_plain(cfg, solver, normals, positions, accum, frame):
    _check_cfg(cfg)
    w, mm = _fit_plain(cfg, solver, normals, positions, accum, frame)
    cfg = cfg.replace(skip_fitting=False)
    return weighted_sum_image(cfg, w, mm, normals, positions, accum,
                              frame), w


def _launch_direct(name, cfg, normals, positions, accum, frame, *outs):
    """Check the planes and launch direct kernel ``name`` on them, writing
    into ``outs`` (tensors, or None for an output the kernel skips)."""
    _check_cfg(cfg)
    dev = normals.device
    H, W = cfg.image_height, cfg.image_width
    for t, label in ((normals, "normals"), (positions, "positions"),
                     (accum, "accum")):
        _lib.check_tensor(t, label, torch.float32, (3, H, W), dev)
    base, amp = noise_params(frame, cfg.block_pixels, cfg.buffer_count,
                             cfg.noise_amount)
    ox, oy = jitter_offset(frame)
    ptr = [0 if t is None else t.data_ptr() for t in outs]
    _lib.launch(name, normals.data_ptr(), positions.data_ptr(),
                accum.data_ptr(), *ptr, H, W, cfg.blocks_x, cfg.blocks_y,
                ox, oy, MODE[cfg.tmp_data_dtype], base, amp)


def _device(fn_name, t):
    dev = t.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn_name}: unsupported device {dev}")
    return dev


def _outputs(cfg, dev, image=True, mins_maxs=False):
    f32 = dict(dtype=torch.float32, device=dev)
    out = (torch.empty((3, cfg.image_height, cfg.image_width), **f32)
           if image else None)
    w = torch.empty((cfg.n_blocks, cfg.feature_count, 3), **f32)
    mm = (torch.empty((cfg.n_blocks, cfg.features_scaled_count, 2), **f32)
          if mins_maxs else None)
    return out, w, mm


def fit_reconstruct_cholesky_reference(cfg, normals, positions, accum,
                                       frame):
    """Plain PyTorch version of :func:`fit_reconstruct_cholesky`."""
    return _reconstruct_plain(cfg, "cholesky", normals, positions, accum,
                              frame)


def fit_reconstruct_cholesky(cfg, normals, positions, accum, frame):
    """Fit every block of frame ``frame`` by Cholesky and reconstruct the
    filtered image (kernel B). ``normals``/``positions``/``accum``: f32
    ``[3, H, W]``. Returns ``(filtered f32[3, H, W], weights f32[n_blocks,
    F, 3])``, the weights in the layout of the JAX ``fit_blocks``.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`fit_reconstruct_cholesky_reference`. Any other device raises.
    """
    dev = _device("fit_reconstruct_cholesky", normals)
    if dev.type == "cpu":
        return fit_reconstruct_cholesky_reference(cfg, normals, positions,
                                                  accum, frame)
    out, w, _ = _outputs(cfg, dev)
    _launch_direct("bmfr_fit_reconstruct_cholesky", cfg, normals,
                   positions, accum, frame, out, w)
    fit_reconstruct_cholesky.launches += 1
    return out, w


def fit_reconstruct_direct_reference(cfg, normals, positions, accum, frame):
    """Plain PyTorch version of :func:`fit_reconstruct_direct`."""
    return _reconstruct_plain(cfg, "householder", normals, positions,
                              accum, frame)


def fit_reconstruct_direct(cfg, normals, positions, accum, frame):
    """Fit every block by Householder QR and reconstruct the filtered
    image (kernel C, the JAX ``fit_reconstruct_direct`` with its
    inverse-jitter slice fused). Same arguments and outputs as
    :func:`fit_reconstruct_cholesky`.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`fit_reconstruct_direct_reference`. Any other device raises.
    """
    dev = _device("fit_reconstruct_direct", normals)
    if dev.type == "cpu":
        return fit_reconstruct_direct_reference(cfg, normals, positions,
                                                accum, frame)
    out, w, _ = _outputs(cfg, dev)
    _launch_direct("bmfr_fit_direct_householder", cfg, normals, positions,
                   accum, frame, out, w, None)
    fit_reconstruct_direct.launches += 1
    return out, w


def fit_blocks_direct_reference(cfg, normals, positions, accum, frame):
    """Plain PyTorch version of :func:`fit_blocks_direct`."""
    _check_cfg(cfg)
    return _fit_plain(cfg, "householder", normals, positions, accum, frame)


def fit_blocks_direct(cfg, normals, positions, accum, frame):
    """Fit every block by Householder QR straight from the raw planes
    (kernel C without the reconstruction). Returns ``(weights
    f32[n_blocks, F, 3], mins_maxs f32[n_blocks, n_scaled, 2])``, as
    ``fit_blocks`` does.

    On a CUDA tensor this launches the kernel; on a CPU tensor it runs
    :func:`fit_blocks_direct_reference`. Any other device raises.
    """
    dev = _device("fit_blocks_direct", normals)
    if dev.type == "cpu":
        return fit_blocks_direct_reference(cfg, normals, positions, accum,
                                           frame)
    _, w, mm = _outputs(cfg, dev, image=False, mins_maxs=True)
    _launch_direct("bmfr_fit_direct_householder", cfg, normals, positions,
                   accum, frame, None, w, mm)
    fit_blocks_direct.launches += 1
    return w, mm


#: kernel launches since the count was last set to 0
fit_reconstruct_cholesky.launches = 0
fit_reconstruct_direct.launches = 0
fit_blocks_direct.launches = 0
