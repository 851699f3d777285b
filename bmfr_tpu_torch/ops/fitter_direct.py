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
again; add the hash noise, which the kernels compute themselves
(:func:`~bmfr_tpu_torch.rng.noise_params`). The kernels read the frame
number from the card (:func:`~bmfr_tpu_torch.ops.frame.frame_tensor`)
and derive its jitter and noise there, so ``frame`` may be a host int or
a 0-d int32 tensor on the planes' card. The reconstruction ``max(sum_f
w_f basis_f, 0)`` uses the basis built from the pre-rounding,
unsanitized, noise-free f32 features and writes the image directly,
which replaces the JAX pipeline's inverse-jitter slice
(``pipeline/denoise.py:218-225``).

Any other feature basis (4..16 columns, features + colours), and the
default one once a user has registered one of its names anew, takes the
basis front of the same kernels (``csrc/fitter_chol_basis.cu``,
``csrc/householder_direct_basis.cu``, ``csrc/basis_front.cuh``), chosen by
:func:`basis_plan` alone: the kernels read the raw planes and compute
each feature whose name still holds its built-in function in their own
code (a raw plane, its square or 1: :func:`plane_table`), as
``_chol_kernel`` and ``_qr_kernel`` evaluate the registry inside the
kernel; every other feature is a plane the wrapper evaluates with the
registry (:func:`basis_planes`), addressed as the raw planes are (a
feature is a per-pixel function, so evaluating before the mirror equals
evaluating after it). The K1 store contract, the rescale
of the scaled features (those from ``features_not_scaled_count`` on),
the noise (none on feature 0) and the reconstruction from the
pre-rounding features are the default front's.

The plain versions are the block path the JAX tests hold the direct
kernels to (``tests/test_fitter_direct.py``):
``build_feature_blocks_reference`` -> ``fit_blocks`` (plain, Cholesky or
Householder) -> ``weighted_sum_image``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import DEFAULT_FEATURES
from ..features import _BUILTIN_FEATURES, FEATURE_REGISTRY, evaluate_features
from ..rng import noise_amp
from . import _lib
from .blockify import build_feature_blocks_reference
from .fitter import fit_blocks_reference
from .fitter_pallas import MAX_BUFFERS, MIN_BUFFERS, MODE
from .frame import frame_tensor
from .weighted_sum import weighted_sum_image

BLOCK_EDGE = 32


def _check_cfg(cfg):
    if cfg.block_edge != BLOCK_EDGE:
        raise NotImplementedError("the direct fitter needs 32x32 blocks")
    if not MIN_BUFFERS <= cfg.buffer_count <= MAX_BUFFERS:
        raise ValueError(f"the direct fitters take {MIN_BUFFERS}.."
                         f"{MAX_BUFFERS} columns (features + colours), not "
                         f"{cfg.buffer_count}")


#: the plan's code of each built-in feature (:func:`plane_table` maps a
#: code to the plane the basis kernels read and their op on it)
BUILTIN_CODES = {name: code for code, name in enumerate(DEFAULT_FEATURES)}
#: the code of extra plane k is PLANE_CODE + k
PLANE_CODE = 16


class BasisPlan(NamedTuple):
    """How kernels B and C build ``cfg``'s basis (:func:`basis_plan`)."""

    #: one code per feature of ``cfg.all_features``, in its order: a
    #: built-in code, or PLANE_CODE + the index of its plane in ``planes``
    codes: tuple
    #: the features the wrapper evaluates into the extra planes
    planes: tuple
    #: the in-code default front serves the basis
    default: bool

    @property
    def geometry(self):
        """The raw planes the basis kernels read for these codes
        (:func:`plane_table`): normals 0..2, positions 3..5."""
        return tuple(sorted({c - 1 if c <= 6 else c - 4 for c in self.codes
                             if 1 <= c < PLANE_CODE}))


def basis_plan(cfg):
    """The one place that chooses between the default front and the basis
    front. A feature whose registry entry is its built-in function (by
    identity) gets the built-in code; any other, a registered feature or
    a default name registered anew, becomes a plane (one per name). The
    default front serves only the ten default features in their order,
    each still built in."""
    codes, planes = [], []
    for name in cfg.all_features:
        if FEATURE_REGISTRY[name] is _BUILTIN_FEATURES.get(name):
            codes.append(BUILTIN_CODES[name])
            continue
        if name not in planes:
            planes.append(name)
        codes.append(PLANE_CODE + planes.index(name))
    return BasisPlan(tuple(codes), tuple(planes),
                     cfg.all_features == DEFAULT_FEATURES and not planes)


#: what the basis kernels do with a feature's plane (csrc/basis_front.cuh)
VALUE, SQUARE, ONE = 0, 1, 2


def plane_table(plan, normals, positions, accum, extra):
    """The basis as the basis kernels take it: per feature of ``plan``
    the device address of the plane it reads and its op. A normal or
    position reads its raw plane, a squared position the position's plane
    (squared in the kernel), the constant the first colour plane (which
    the kernels read anyway; they take 1), any other feature its extra
    plane. Returns (addresses, op of feature i in byte i % 8 of word
    i // 8; at least two words)."""
    step = normals[0].numel() * normals.element_size()
    addresses, words = [], [0] * max(2, -(-len(plan.codes) // 8))
    for i, code in enumerate(plan.codes):
        if code >= PLANE_CODE:
            plane, op = extra.data_ptr() + (code - PLANE_CODE) * step, VALUE
        elif code >= 7:
            plane, op = positions.data_ptr() + (code - 7) * step, SQUARE
        elif code >= 4:
            plane, op = positions.data_ptr() + (code - 4) * step, VALUE
        elif code >= 1:
            plane, op = normals.data_ptr() + (code - 1) * step, VALUE
        else:
            plane, op = accum.data_ptr(), ONE
        addresses.append(plane)
        words[i // 8] |= op << (8 * (i % 8))
    return tuple(addresses), tuple(words)


def basis_planes(cfg, normals, positions, plan=None):
    """The extra planes the basis front stages: the features ``plan`` (by
    default ``basis_plan(cfg)``) marks as planes, evaluated with the
    registry on the image, f32 ``[K, H, W]``, contiguous; None when K =
    0."""
    plan = plan or basis_plan(cfg)
    if not plan.planes:
        return None
    return evaluate_features(plan.planes, normals,
                             positions).to(torch.float32).contiguous()


#: the most features kernels J and K take (``csrc/feature_table.cuh``)
TABLE_FEATURES = 64


def feature_table(cfg, normals, positions, const_plane):
    """The basis of ``cfg`` as kernels J and K take it
    (``csrc/feature_table.cuh``): :func:`plane_table` with the constant
    reading ``const_plane``. Returns ``(extra, planes, ops)``: the extra
    planes (keep them until the kernel is launched), and the host arrays
    of plane addresses and op words (ctypes, pass their addresses)."""
    if cfg.feature_count > TABLE_FEATURES:
        raise NotImplementedError(f"kernels J and K take at most "
                                  f"{TABLE_FEATURES} features, not "
                                  f"{cfg.feature_count}")
    plan = basis_plan(cfg)
    extra = basis_planes(cfg, normals, positions, plan)
    addresses, words = plane_table(plan, normals, positions, const_plane,
                                   extra)
    return (extra, (ctypes.c_uint64 * len(addresses))(*addresses),
            (ctypes.c_uint64 * len(words))(*words))


def _fit_plain(cfg, solver, normals, positions, accum, frame):
    cfg = cfg.replace(solver=solver)
    tmp = build_feature_blocks_reference(cfg, normals, positions, accum,
                                         frame)
    return fit_blocks_reference(cfg, tmp, frame)


def _reconstruct_plain(cfg, solver, normals, positions, accum, frame):
    _check_cfg(cfg)
    w, mm = _fit_plain(cfg, solver, normals, positions, accum, frame)
    cfg = cfg.replace(skip_fitting=False)
    return weighted_sum_image(cfg, w, mm, normals, positions, accum,
                              frame), w


def _launch_direct(name, cfg, normals, positions, accum, frame, *outs):
    """Check the planes and launch direct kernel ``name`` on them at frame
    ``frame`` (a host int or a 0-d int32 tensor on the card), writing
    into ``outs`` (tensors, or None for an output the kernel skips)."""
    _check_cfg(cfg)
    dev = normals.device
    H, W = cfg.image_height, cfg.image_width
    for t, label in ((normals, "normals"), (positions, "positions"),
                     (accum, "accum")):
        _lib.check_tensor(t, label, torch.float32, (3, H, W), dev)
    ft = frame_tensor(frame, dev)
    ptr = [0 if t is None else t.data_ptr() for t in outs]
    tail = (ft.data_ptr(), MODE[cfg.tmp_data_dtype],
            noise_amp(cfg.noise_amount))
    plan = basis_plan(cfg)
    if plan.default:
        _lib.launch(name, normals.data_ptr(), positions.data_ptr(),
                    accum.data_ptr(), *ptr, H, W, cfg.blocks_x,
                    cfg.blocks_y, *tail)
        return
    # the extra planes live until the kernel has read them (the caching
    # allocator reuses them only in this stream's order); the kernel copies
    # the addresses into its launch arguments before the call returns
    extra = basis_planes(cfg, normals, positions, plan)
    addresses, ops = plane_table(plan, normals, positions, accum, extra)
    table = (ctypes.c_uint64 * len(addresses))(*addresses)
    _lib.launch(name + "_basis", accum.data_ptr(), ctypes.addressof(table),
                *ops, *ptr, H, W, cfg.blocks_x, cfg.blocks_y,
                cfg.feature_count, cfg.features_not_scaled_count, *tail)


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
    _lib.count_launch(fit_reconstruct_cholesky)
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
    _lib.count_launch(fit_reconstruct_direct)
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
    _lib.count_launch(fit_blocks_direct)
    return w, mm


#: kernel launches since the count was last set to 0
fit_reconstruct_cholesky.launches = 0
fit_reconstruct_direct.launches = 0
fit_blocks_direct.launches = 0
