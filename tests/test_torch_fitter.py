"""Kernel B's plain version (``bmfr_tpu_torch.ops.fitter_direct``)
against the JAX package's fused Cholesky fitter (``fit_reconstruct_
cholesky``, interpret mode on the CPU) after its inverse-jitter slice,
as the JAX pipeline calls it (``pipeline/denoise.py:197-225``). The
tolerance is the repo's own pin for that kernel
(tests/test_fitter_direct.py:146-147): rtol = atol = 5e-3."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.ops.blockify import (blockify_padded, blockify_view,
                                   build_feature_blocks, jitter_offset,
                                   jitter_origin)
from bmfr_tpu.ops.fitter import fit_blocks
from bmfr_tpu.ops.fitter_direct import (DMA_SLACK, _pads_for_direct,
                                        fit_reconstruct_cholesky as jax_fit)
from bmfr_tpu_torch.ops.fitter_direct import fit_reconstruct_cholesky
from conftest import to_chw

TOL = 5e-3


def takes_origin_path(cfg, raw9):
    """Whether the JAX pipeline fits ``cfg`` on its DMA-origin path."""
    mw_pad = _pads_for_direct(cfg)[1]
    return blockify_padded(cfg, raw9, width=mw_pad,
                           slack=DMA_SLACK)[1] == mw_pad


@functools.partial(jax.jit, static_argnums=0)
def _jax_filtered(cfg, raw9, f):
    mw_pad = _pads_for_direct(cfg)[1]
    padded9, tw = blockify_padded(cfg, raw9, width=mw_pad, slack=DMA_SLACK)
    if tw == mw_pad:
        fview = jax_fit(cfg, padded9, f, origin=jitter_origin(cfg, f))
    else:
        fview = jax_fit(cfg, blockify_view(cfg, raw9, f, width=tw), f)
    half = cfg.block_edge // 2
    off = jitter_offset(f, cfg.block_edge)
    return jax.lax.dynamic_slice(
        fview, (jnp.int32(0), half - off[1], half - off[0]),
        (3, cfg.image_height, cfg.image_width))


def jax_filtered(cfg, raw9, frame):
    """The JAX pipeline's K2+K3 on the direct path, inverse jitter
    included, and whether it took the origin path. The frame is traced,
    so the frames of one config share one interpret-mode compile."""
    return (np.asarray(_jax_filtered(cfg, raw9, jnp.int32(frame))),
            takes_origin_path(cfg, raw9))


def run_port(cfg, raw9, frame):
    t = torch.from_numpy(np.asarray(raw9))
    return fit_reconstruct_cholesky(bt.config_from_jax(cfg), t[0:3], t[3:6],
                                    t[6:9], frame)


@pytest.fixture(scope="module")
def scene_planes(tiny_scene):
    sc = tiny_scene
    return np.concatenate([to_chw(sc["normals"][1]),
                           to_chw(sc["positions"][1]),
                           to_chw(sc["noisy"][1])], axis=0)


@pytest.mark.parametrize("frame", [0, 5])
def test_plain_matches_jax_cholesky_scene(tiny_cfg, scene_planes, frame):
    cfg = tiny_cfg.replace(fitter_impl="pallas_direct",
                           solver="cholesky").validate()
    want, origin_path = jax_filtered(cfg, jnp.asarray(scene_planes), frame)
    assert not origin_path          # 64x48 takes the sliced-view branch
    got, w = run_port(cfg, scene_planes, frame)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)

    # the same blocks solve (and fail to zero weights) as in the JAX
    # package's XLA cholesky solve; the weights themselves are sensitive
    # to summation order on ill-conditioned blocks, the reconstruction
    # above is the contract
    p = jnp.asarray(scene_planes)
    tmp = build_feature_blocks(cfg, p[0:3], p[3:6], p[6:9], jnp.int32(frame))
    w_x, _ = fit_blocks(cfg.replace(fitter_impl="xla"), tmp,
                        jnp.int32(frame))
    assert w.shape == w_x.shape
    np.testing.assert_array_equal((w.numpy() == 0).all(axis=(1, 2)),
                                  (np.asarray(w_x) == 0).all(axis=(1, 2)))


@pytest.mark.parametrize("frame", [0, 3])
def test_plain_matches_jax_cholesky_origin_path(tiny_cfg, frame):
    """480x64 random planes: blocks_x = 16 is one whole chunk, so the JAX
    pipeline takes its DMA-origin path (tests/test_fitter_direct.py:
    161-174)."""
    cfg = tiny_cfg.replace(image_width=480, image_height=64,
                           fitter_impl="pallas_direct",
                           solver="cholesky").validate()
    raw9 = np.random.default_rng(5).standard_normal(
        (9, cfg.image_height, cfg.image_width)).astype(np.float32)
    want, origin_path = jax_filtered(cfg, jnp.asarray(raw9), frame)
    assert origin_path
    got, _ = run_port(cfg, raw9, frame)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_plain_rejects_unported_fitter_variants(tiny_cfg, scene_planes):
    """The variants the direct fitters once rejected now run: a custom
    feature basis (rejected until the kernels gained a basis front) on
    every entry, and reduced-precision tmp storage. What stays rejected:
    blocks other than 32x32 on the direct fitters, and the Cholesky
    solver on the block fitter's kernel (a ValueError, as the JAX one
    raises)."""
    from bmfr_tpu_torch.ops.fitter import fit_blocks
    from bmfr_tpu_torch.ops.fitter_direct import (fit_blocks_direct,
                                                  fit_reconstruct_direct)

    cfg = bt.config_from_jax(tiny_cfg)
    t = torch.from_numpy(scene_planes)
    custom = cfg.replace(features_scaled=("world_position_x",))
    for fit in (fit_reconstruct_cholesky, fit_reconstruct_direct):
        out, w = fit(custom, t[0:3], t[3:6], t[6:9], 0)
        assert w.shape == (cfg.n_blocks, 5, 3)
        assert out.shape == t[0:3].shape and bool(torch.isfinite(out).all())
    w, mm = fit_blocks_direct(custom, t[0:3], t[3:6], t[6:9], 0)
    assert (w.shape, mm.shape) == ((cfg.n_blocks, 5, 3), (cfg.n_blocks, 1, 2))
    with pytest.raises(NotImplementedError, match="32x32"):
        fit_reconstruct_cholesky(cfg.replace(block_edge=16), t[0:3], t[3:6],
                                 t[6:9], 0)
    for dtype in ("float16", "bfloat16"):
        out, w = fit_reconstruct_cholesky(cfg.replace(tmp_data_dtype=dtype),
                                          t[0:3], t[3:6], t[6:9], 0)
        assert out.shape == t[0:3].shape and bool(torch.isfinite(out).all())
    tmp = torch.zeros((cfg.n_blocks, cfg.buffer_count, cfg.block_pixels))
    with pytest.raises(ValueError, match="solver"):
        fit_blocks(cfg.replace(solver="cholesky", fitter_impl="pallas"),
                   tmp, 0)
