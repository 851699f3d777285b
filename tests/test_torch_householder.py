"""The block fitter's plain version (kernel D's, through ``fit_blocks``)
against the JAX package's ``fit_blocks(impl="xla")`` and interpret-mode
``fit_blocks_pallas`` on the CPU, and K3's two reconstructions against
JAX's. (The direct fitters are in tests/test_torch_householder_direct.py.)

Tolerances are the JAX tests' own: mins/maxs 1e-6, weights 2e-3 (f32)
and 5e-3 (f16/bf16: a 1-ulp difference before a storage rounding can
flip one ulp of the stored value) (tests/test_fitter_pallas.py:27-37,
:75-77).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.ops.fitter import fit_blocks as jax_fit_blocks
from bmfr_tpu.ops.fitter_pallas import fit_blocks_pallas as jax_fbp
from bmfr_tpu.ops.weighted_sum import weighted_sum as jax_ws
from bmfr_tpu.ops.weighted_sum import weighted_sum_image as jax_wsi
from bmfr_tpu_torch.ops import fitter_pallas
from bmfr_tpu_torch.ops.fitter import fit_blocks
from bmfr_tpu_torch.ops.weighted_sum import weighted_sum, weighted_sum_image
from conftest import to_chw
from torch_threads import one_intra_op_thread  # noqa: F401


#: jitted, the frame traced: one compile per config instead of one per
#: op of the eager reflections
_jax_xla = jax.jit(lambda cfg, tmp, f: jax_fit_blocks(cfg, tmp, f, impl="xla"),
                   static_argnums=0)
_jax_pallas = jax.jit(jax_fbp, static_argnums=0)


def tol(dtype):
    return 2e-3 if dtype == "float32" else 5e-3


def block_data(cfg):
    """tests/test_fitter_pallas.py's blocks: uniform, the scaled features
    spread over more than 1 so the conditional divide engages."""
    r = np.random.RandomState(3)
    data = r.rand(cfg.n_blocks, cfg.buffer_count,
                  cfg.block_pixels).astype(np.float32)
    data[:, 4:10, :] *= 7.0
    data[:, 4:10, :] -= 2.0
    return data


@pytest.mark.parametrize("block_edge", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_block_fitter_matches_jax(tiny_cfg, dtype, block_edge):
    jcfg = tiny_cfg.replace(tmp_data_dtype=dtype,
                            block_edge=block_edge).validate()
    cfg = bt.config_from_jax(jcfg).replace(fitter_impl="auto")
    stored = jnp.asarray(block_data(jcfg)).astype(dtype)
    frame = 1
    # the interpret-mode kernel once per dtype and per block size, the XLA
    # path elsewhere (tests/test_fitter_pallas.py pins the two together)
    if (dtype, block_edge) in (("float32", 16), ("float16", 32),
                               ("bfloat16", 64)):
        w_j, mm_j = _jax_pallas(jcfg, stored, jnp.int32(frame))
    else:
        w_j, mm_j = _jax_xla(jcfg, stored, jnp.int32(frame))

    tmp = torch.tensor(np.asarray(stored.astype(jnp.float32))).to(
        {"float32": torch.float32, "float16": torch.float16,
         "bfloat16": torch.bfloat16}[dtype])
    n0 = fitter_pallas.fit_blocks_pallas.launches
    w, mm = fit_blocks(cfg, tmp, frame)           # "auto": kernel D's wrapper
    assert fitter_pallas.fit_blocks_pallas.launches == n0  # CPU: plain
    assert w.shape == (jcfg.n_blocks, 10, 3) and mm.shape == (
        jcfg.n_blocks, 6, 2)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=tol(dtype),
                               atol=tol(dtype))


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("frame", [0, 5])
def test_weighted_sums_match_jax(tiny_cfg, tiny_scene, dtype, frame):
    """K3's block and image reconstructions on the same weights and
    mins/maxs, with and without the fit's feature blocks (which only
    f32 storage reuses)."""
    from bmfr_tpu.ops.blockify import build_feature_blocks as jax_bfb

    from bmfr_tpu_torch.ops.blockify import build_feature_blocks

    jcfg = tiny_cfg.replace(tmp_data_dtype=dtype).validate()
    cfg = bt.config_from_jax(jcfg)
    r = np.random.default_rng(frame)
    w = r.standard_normal((jcfg.n_blocks, 10, 3)).astype(np.float32) * 0.3
    mm = np.sort(r.standard_normal((jcfg.n_blocks, 6, 2)).astype(
        np.float32) * 3, axis=-1)
    planes = np.concatenate([to_chw(tiny_scene[k][1]) for k in
                             ("normals", "positions", "noisy")], axis=0)
    p = jnp.asarray(planes)
    n, pos, acc = torch.from_numpy(planes).split(3)
    tmp_j = jax_bfb(jcfg, p[0:3], p[3:6], p[6:9], jnp.int32(frame))
    tmp = build_feature_blocks(cfg, n, pos, acc, frame)
    np.testing.assert_array_equal(tmp.float().numpy(),
                                  np.asarray(tmp_j.astype(jnp.float32)))
    args_j = (jnp.asarray(w), jnp.asarray(mm), p[0:3], p[3:6], p[6:9],
              jnp.int32(frame))
    args = (torch.from_numpy(w), torch.from_numpy(mm), n, pos, acc, frame)
    for got, want in (
            (weighted_sum(cfg, *args), jax_ws(jcfg, *args_j)),
            (weighted_sum(cfg, *args, feature_blocks=tmp),
             jax_ws(jcfg, *args_j, feature_blocks=tmp_j)),
            (weighted_sum_image(cfg, *args), jax_wsi(jcfg, *args_j))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                                   atol=1e-5)
