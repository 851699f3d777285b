"""Any feature basis on the direct fitters: the plain versions of kernels B
and C (``bmfr_tpu_torch.ops.fitter_direct``) against the JAX package's
interpret-mode ``fit_reconstruct_cholesky`` and ``fit_reconstruct_direct``
on one frame at 64x48, with the first-order basis (7 features) and a
13-feature basis of three features registered on both sides
(``register_feature``).

Tolerances are those of ``tests/test_torch_fitter.py`` and
``tests/test_torch_householder_direct.py``: the reconstructions to 5e-3
(rtol = atol, the JAX tests' pin of the fused kernels against the block
path), the Householder weights to 2e-3 and mins/maxs to 1e-6.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu import features as jfeat
from bmfr_tpu.ops.blockify import blockify_view, jitter_offset
from bmfr_tpu.ops.fitter_direct import fit_blocks_direct as jax_fbd
from bmfr_tpu.ops.fitter_direct import fit_reconstruct_cholesky as jax_frc
from bmfr_tpu.ops.fitter_direct import fit_reconstruct_direct as jax_frd
from bmfr_tpu_torch import features
from bmfr_tpu_torch.ops import fitter_direct
from conftest import to_chw

#: three second-order cross terms, registered on both sides
CROSS = {
    "test_position_xy": (lambda n, p: p[0] * p[1]),
    "test_position_yz": (lambda n, p: p[1] * p[2]),
    "test_normal_xz": (lambda n, p: n[0] * n[2]),
}
FIRST_ORDER = dict(features_scaled=("world_position_x", "world_position_y",
                                    "world_position_z"))
THIRTEEN = dict(features_scaled=(
    "world_position_x", "world_position_y", "world_position_z",
    "world_position_x2", "world_position_y2", "world_position_z2",
    *CROSS))
BASES = {"first_order": FIRST_ORDER, "13_features": THIRTEEN}


@pytest.fixture(scope="module")
def cross_features():
    """The cross terms in both registries for the module's tests."""
    for name, fn in CROSS.items():
        jfeat.register_feature(name, fn)
        features.register_feature(name, fn)
    yield
    for name in CROSS:
        jfeat.FEATURE_REGISTRY.pop(name, None)
        features.FEATURE_REGISTRY.pop(name, None)


@pytest.fixture(scope="module")
def planes(tiny_scene):
    sc = tiny_scene
    return np.concatenate([to_chw(sc["normals"][1]),
                           to_chw(sc["positions"][1]),
                           to_chw(sc["noisy"][1])], axis=0)


def port_planes(planes):
    t = torch.from_numpy(planes)
    return t[0:3], t[3:6], t[6:9]


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_direct(cfg, which, raw9, f):
    """One JAX direct kernel (interpret mode) on the sliced view of frame
    ``f``, a reconstruction sliced back to the image as the pipeline
    does (``pipeline/denoise.py:218-225``)."""
    view = blockify_view(cfg, raw9, f)
    if which == "fit_blocks_direct":
        return jax_fbd(cfg, view, f)
    fit = jax_frd if which == "fit_reconstruct_direct" else jax_frc
    fview = fit(cfg, view, f)
    half = cfg.block_edge // 2
    off = jitter_offset(f, cfg.block_edge)
    return jax.lax.dynamic_slice(
        fview, (jnp.int32(0), half - off[1], half - off[0]),
        (3, cfg.image_height, cfg.image_width))


def configs(tiny_cfg, basis, **kw):
    jcfg = tiny_cfg.replace(fitter_impl="pallas_direct", **BASES[basis],
                            **kw).validate()
    return jcfg, bt.config_from_jax(jcfg)


@pytest.mark.parametrize("which", ["fit_reconstruct_cholesky",
                                   "fit_reconstruct_direct"])
@pytest.mark.parametrize("basis", list(BASES))
def test_plain_direct_fitters_match_jax_on_a_basis(tiny_cfg, planes,
                                                   cross_features, which,
                                                   basis):
    jcfg, cfg = configs(tiny_cfg, basis)
    frame = 5
    want = np.asarray(_jax_direct(jcfg, which, jnp.asarray(planes),
                                  jnp.int32(frame)))
    got, w = getattr(fitter_direct, which)(cfg, *port_planes(planes), frame)
    assert w.shape == (jcfg.n_blocks, jcfg.feature_count, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)


def test_plain_blocks_entry_matches_jax_on_a_basis(tiny_cfg, planes,
                                                   cross_features):
    """Kernel C's blocks entry: weights and the mins/maxs of the scaled
    features, first-order basis (the JAX blocks entry exports 16 rows, so
    a 16-column basis fails to trace there)."""
    jcfg, cfg = configs(tiny_cfg, "first_order")
    w_j, mm_j = _jax_direct(jcfg, "fit_blocks_direct", jnp.asarray(planes),
                            jnp.int32(2))
    w, mm = fitter_direct.fit_blocks_direct(cfg, *port_planes(planes), 2)
    assert mm.shape == (jcfg.n_blocks, jcfg.features_scaled_count, 2)
    np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(w.numpy(), np.asarray(w_j), rtol=2e-3,
                               atol=2e-3)


def test_register_feature_reaches_both_sides(tiny_cfg, planes):
    """A feature registered on each side under one name is what both the
    extra plane of the port's basis front and the JAX registry
    evaluate; a basis of the default 10 with that feature swapped in
    still meets the JAX Householder fitter."""
    name = "test_normal_xy_sum"

    def fn(n, p):
        return n[0] + n[1]

    assert features.register_feature(name, fn) is fn
    jfeat.register_feature(name, fn)
    try:
        n, p, a = port_planes(planes)
        scaled = ("world_position_x", "world_position_y", name)
        jcfg = tiny_cfg.replace(fitter_impl="pallas_direct",
                                features_scaled=scaled).validate()
        cfg = bt.config_from_jax(jcfg)
        # the basis front stages the registered feature as its one extra
        # plane; the built-in ones it computes in the kernel
        assert fitter_direct.basis_plan(cfg).planes == (name,)
        got = fitter_direct.basis_planes(cfg, n, p).numpy()
        want = np.asarray(jfeat.evaluate_features(
            (name,), jnp.asarray(planes[0:3]), jnp.asarray(planes[3:6])))
        np.testing.assert_array_equal(got, want)
        w_j = np.asarray(_jax_direct(jcfg, "fit_blocks_direct",
                                     jnp.asarray(planes), jnp.int32(1))[0])
        w, _ = fitter_direct.fit_blocks_direct(cfg, n, p, a, 1)
        np.testing.assert_allclose(w.numpy(), w_j, rtol=2e-3, atol=2e-3)
    finally:
        features.FEATURE_REGISTRY.pop(name, None)
        jfeat.FEATURE_REGISTRY.pop(name, None)


def test_direct_fitters_take_4_to_16_columns(tiny_cfg, planes):
    """A basis of the constant alone (4 columns) runs; 17 columns raise on
    both solvers, as kernel D's range does."""
    cfg = bt.config_from_jax(tiny_cfg).replace(
        fitter_impl="pallas_direct", features_not_scaled=("const",),
        features_scaled=())
    for fit in (fitter_direct.fit_reconstruct_cholesky,
                fitter_direct.fit_reconstruct_direct):
        out, w = fit(cfg, *port_planes(planes), 3)
        assert w.shape == (cfg.n_blocks, 1, 3)
        assert bool(torch.isfinite(out).all())
    wide = cfg.replace(features_scaled=("world_position_x",) * 13)
    for fit in (fitter_direct.fit_reconstruct_cholesky,
                fitter_direct.fit_reconstruct_direct,
                fitter_direct.fit_blocks_direct):
        with pytest.raises(ValueError, match="4..16 columns"):
            fit(wide, *port_planes(planes), 3)
