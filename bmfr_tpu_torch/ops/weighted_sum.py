"""Stage K3 — weighted-sum reconstruction from the fitted block weights
(port of :mod:`bmfr_tpu.ops.weighted_sum`; opencl/bmfr.cl:703-758).

:func:`weighted_sum` (kernel K, ``csrc/block_reconstruct.cu``) replaces
what XLA fuses on the TPU out of ``weighted_sum``
(``bmfr_tpu/ops/weighted_sum.py:27``): per image pixel its block under
the inverse jitter, the rescale, the dot product and the clamp in one
pass, with no block-layout intermediate: one CTA per 32 x 32 tile of the
margins grid (one block at ``block_edge`` 32), launched as
:func:`reconstruct_geometry` says."""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from ..features import evaluate_features
from . import _lib
from .blockify import blockify_planes, jitter_offset, unblockify_planes
from .fitter import highest_precision, scale_with_mins_maxs
from .frame import frame_tensor


#: kernel K's CTA (``csrc/block_reconstruct.cu``): a TILE x TILE tile of
#: the margins grid, THREADS threads, each one column of the tile and a
#: band of BAND rows
TILE, BAND = 32, 8
THREADS = TILE * (TILE // BAND)


class ReconstructGeometry(NamedTuple):
    """Kernel K's launch: the grid of tiles over the margins grid, the
    shared memory that holds the (min, d) pairs and weights of the most
    blocks one tile touches (bytes), and whether the table is the default
    basis' (its values in registers, 6 plane loads a pixel)."""
    tiles_x: int
    tiles_y: int
    smem: int
    default_basis: bool


def reconstruct_geometry(cfg):
    """Kernel K's launch for ``cfg``, from the config alone: the frame is
    read on the card, so one launch serves every jitter."""
    from .fitter_direct import basis_plan

    be = cfg.block_edge
    F, lo = cfg.feature_count, cfg.features_not_scaled_count
    # the most blocks TILE cells from a multiple of TILE touch along one
    # axis (the pattern repeats every lcm(TILE, be) cells)
    span = max((t + TILE - 1) // be - t // be + 1
               for t in range(0, math.lcm(TILE, be), TILE))
    return ReconstructGeometry(
        tiles_x=-(-cfg.blocks_x * be // TILE),
        tiles_y=-(-cfg.blocks_y * be // TILE),
        smem=span ** 2 * (8 * (F - lo) + 12 * F),
        default_basis=basis_plan(cfg).default and lo == 4)


def block_basis(cfg, mins_maxs, normals, positions, frame,
                feature_blocks=None):
    """The rescaled basis ``f32[n_blocks, F, block_pixels]`` that
    :func:`weighted_sum_reference` dots with the weights: the blocks'
    unscaled feature rows (f32 storage) or the raw features blocked, the
    scaled ones rescaled with each block's mins/maxs."""
    if feature_blocks is not None and cfg.tmp_data_dtype == "float32":
        fblocks = feature_blocks[:, :cfg.feature_count]
    else:
        feats = evaluate_features(cfg.all_features, normals, positions)
        fblocks = blockify_planes(cfg, feats, frame)    # [nb, F, bp]
    lo = cfg.features_not_scaled_count
    scaled = scale_with_mins_maxs(fblocks[:, lo:], mins_maxs[..., 0:1],
                                  mins_maxs[..., 1:2])
    return torch.cat([fblocks[:, :lo], scaled], dim=1)


def weighted_sum_reference(cfg, weights, mins_maxs, normals, positions,
                           noisy, frame, feature_blocks=None):
    """Plain PyTorch version of :func:`weighted_sum`."""
    fblocks = block_basis(cfg, mins_maxs, normals, positions, frame,
                          feature_blocks)
    with highest_precision():
        color_blocks = torch.einsum("bfe,bfc->bce", fblocks, weights)
    color = unblockify_planes(cfg, color_blocks, frame)
    color = torch.clamp_min(color, 0.0)
    if cfg.skip_fitting:
        color = noisy
    return color


def weighted_sum(cfg, weights, mins_maxs, normals, positions, noisy,
                 frame, feature_blocks=None):
    """Reconstruct the filtered image in the block layout
    (``weighted_sum.py:27-67``). weights f32 ``[n_blocks, F, 3]``;
    mins_maxs f32 ``[n_blocks, n_sc, 2]``; normals/positions/noisy f32
    ``[3, H, W]`` (noisy is the ``skip_fitting`` bypass source,
    opencl/bmfr.cl:752-754). Returns f32 ``[3, H, W]``, negatives
    clamped to 0 (opencl/bmfr.cl:750), NaN kept.

    ``feature_blocks``: the fit's input blocks; their unscaled feature
    rows are the basis K3 would rebuild, so they are reused, but only
    under f32 storage: reduced-precision tmp rounds the features, and the
    reference's K3 reads the raw f32 buffers (``:45-49``). The rows are
    the pixels' own features with NaN turned into 0.

    On a CUDA tensor this launches kernel K, which evaluates each pixel's
    features from the raw planes (with NaN -> 0 where the plain version
    reads f32 blocks) and dots them with its block's weights in f32, in
    its own summation order (within a stated tolerance of the plain
    version's batched product); ``skip_fitting`` returns ``noisy``, as
    the plain version does, with no launch. On a CPU tensor it runs
    :func:`weighted_sum_reference`. Any other device raises.
    """
    from .fitter_direct import feature_table

    dev = normals.device
    if dev.type == "cpu":
        return weighted_sum_reference(cfg, weights, mins_maxs, normals,
                                      positions, noisy, frame,
                                      feature_blocks)
    if dev.type != "cuda":
        raise ValueError(f"weighted_sum: unsupported device {dev}")
    if cfg.skip_fitting:
        return noisy
    H, W = cfg.image_height, cfg.image_width
    F, lo = cfg.feature_count, cfg.features_not_scaled_count
    _lib.check_tensor(normals, "normals", torch.float32, (3, H, W), dev)
    _lib.check_tensor(positions, "positions", torch.float32, (3, H, W), dev)
    # the plain fitters' weights are a transposed view
    weights, mins_maxs = weights.contiguous(), mins_maxs.contiguous()
    _lib.check_tensor(weights, "weights", torch.float32,
                      (cfg.n_blocks, F, 3), dev)
    _lib.check_tensor(mins_maxs, "mins_maxs", torch.float32,
                      (cfg.n_blocks, F - lo, 2), dev)
    sanitize = (feature_blocks is not None
                and cfg.tmp_data_dtype == "float32")
    ft = frame_tensor(frame, dev)
    # the constant reads the first normal plane, which normal_x reads too
    extra, planes, ops = feature_table(cfg, normals, positions, normals)
    geo = reconstruct_geometry(cfg)
    out = torch.empty((3, H, W), dtype=torch.float32, device=dev)
    _lib.launch("bmfr_block_reconstruct", ctypes.addressof(planes),
                ctypes.addressof(ops), F, lo, weights.data_ptr(),
                mins_maxs.data_ptr(), out.data_ptr(), ft.data_ptr(), H, W,
                cfg.block_edge, cfg.blocks_x, int(sanitize),
                int(geo.default_basis), geo.tiles_x, geo.tiles_y, geo.smem)
    _lib.count_launch(weighted_sum)
    # the extra planes' memory is reused only after the kernel, in stream
    # order
    del extra
    return out


#: kernel launches since the count was last set to 0
weighted_sum.launches = 0


def weighted_sum_image(cfg, weights, mins_maxs, normals, positions, noisy,
                       frame):
    """Image-space reconstruction (``weighted_sum.py:70-111``): per-pixel
    feature evaluation + rescale + dot with the pixel's block weights,
    the block lookup written as a gather by each pixel's block under the
    inverse jitter (opencl/bmfr.cl:718-747). ``frame``: a host int or a
    0-d integer tensor."""
    if cfg.skip_fitting:
        return noisy
    H, W = cfg.image_height, cfg.image_width
    be = cfg.block_edge
    half = be // 2
    F = cfg.feature_count
    lo = cfg.features_not_scaled_count
    nby, nbx = cfg.blocks_y, cfg.blocks_x
    ox, oy = jitter_offset(frame, be)
    dev = normals.device
    # image pixel (y, x) lies in block (by[y], bx[x]) of the jittered grid
    by = torch.div(torch.arange(H, device=dev) + (half - oy), be,
                   rounding_mode="floor")
    bx = torch.div(torch.arange(W, device=dev) + (half - ox), be,
                   rounding_mode="floor")

    def upsample(block_vals):
        """[n_blocks, K] -> per-pixel [K, H, W] via the inverse jitter: a
        gather by block row and column (the window's origin may be a
        tensor)."""
        g = block_vals.reshape(nby, nbx, -1).permute(2, 0, 1)
        return g[:, by[:, None], bx[None, :]]

    feats = evaluate_features(cfg.all_features, normals, positions)
    mm = upsample(mins_maxs.reshape(cfg.n_blocks, (F - lo) * 2))
    scaled = scale_with_mins_maxs(feats[lo:], mm[0::2], mm[1::2])
    basis = torch.cat([feats[:lo], scaled], dim=0)      # [F, H, W]
    w3 = upsample(weights.reshape(cfg.n_blocks, F * 3)).reshape(F, 3, H, W)
    color = (basis[:, None] * w3).sum(dim=0)
    return torch.clamp_min(color, 0.0)
