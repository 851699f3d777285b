"""How kernels B and C build a feature basis (``ops/fitter_direct.py::
basis_plan``), on the CPU.

- the plan: a name that still holds its built-in function gets the
  built-in code the kernels compute in their own code; a registered
  feature, or a default name registered anew, becomes an extra plane; the
  in-code default front serves only the ten built-in default features;
- the repair against JAX: ``normal_x`` registered anew on both sides; the
  port's direct fitters on the CPU equal the JAX package's interpret-mode
  ``_chol_kernel`` and ``_qr_kernel`` at ``tests/test_torch_basis.py``'s
  tolerance (5e-3, rtol = atol, the JAX tests' pin of the fused kernels);
- the slice against JAX: the port's ``denoise_sequence`` on the
  13-feature cross basis with the direct Householder fitter against the
  JAX package's on frame 0 at 64x48 (its kernel C in interpret mode; one
  frame keeps the file short), >= 80 dB,
  ``tests/test_torch_exact_path.py``'s bar for the f32-warp paths;
- a replay of the basis B's Gram summation order (4x4 tiles, each warp's
  eighth of the block, 4-pixel running sums a lane, the lanes' transpose
  tree, the eighths in warp order) on seeded 1024-pixel blocks of 16
  columns, f32- and f16-stored: no less exact against the f64 Gram than
  the plain ``fitter.gram`` (within sqrt 2, the rule the card holds B's
  reduced-precision fits to).
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
from bmfr_tpu.ops.fitter_direct import fit_reconstruct_cholesky as jax_frc
from bmfr_tpu.ops.fitter_direct import fit_reconstruct_direct as jax_frd
from bmfr_tpu.pipeline.denoise import FrameInputs as JaxFrameInputs
from bmfr_tpu.pipeline.denoise import denoise_sequence as jax_denoise_sequence
from bmfr_tpu_torch import features
from bmfr_tpu_torch.config import DEFAULT_FEATURES
from bmfr_tpu_torch.metrics import psnr
from bmfr_tpu_torch.ops import fitter, fitter_direct
from bmfr_tpu_torch.ops.fitter_direct import (ONE, PLANE_CODE, SQUARE,
                                              VALUE, basis_plan, plane_table)
from conftest import to_chw

CROSS = {
    "plan_test_position_xy": (lambda n, p: p[0] * p[1]),
    "plan_test_position_yz": (lambda n, p: p[1] * p[2]),
    "plan_test_normal_xz": (lambda n, p: n[0] * n[2]),
}
THIRTEEN = dict(features_scaled=(
    "world_position_x", "world_position_y", "world_position_z",
    "world_position_x2", "world_position_y2", "world_position_z2",
    *CROSS))
#: the slice's bar per frame, tests/test_torch_exact_path.py's EXACT_DB
SLICE_DB = 80.0


@pytest.fixture
def registered():
    """Register features on both sides for one test; restore both
    registries after."""
    saved = dict(features.FEATURE_REGISTRY), dict(jfeat.FEATURE_REGISTRY)

    def register(name, fn):
        features.register_feature(name, fn)
        jfeat.register_feature(name, fn)

    yield register
    for reg, old in zip((features.FEATURE_REGISTRY,
                         jfeat.FEATURE_REGISTRY), saved):
        reg.clear()
        reg.update(old)


def test_default_names_take_the_builtin_codes():
    plan = basis_plan(bt.BMFRConfig())
    assert plan == (tuple(range(10)), (), True)
    assert plan.geometry == (0, 1, 2, 3, 4, 5)
    assert DEFAULT_FEATURES[plan.codes.index(7)] == "world_position_x2"


def test_reregistered_default_name_becomes_a_plane(registered):
    registered("normal_y", lambda n, p: -n[1])
    plan = basis_plan(bt.BMFRConfig())
    assert not plan.default
    assert plan.planes == ("normal_y",)
    assert plan.codes == (0, 1, PLANE_CODE, 3, 4, 5, 6, 7, 8, 9)
    # the same function object registered again is the built-in again
    features.register_feature("normal_y",
                              features._BUILTIN_FEATURES["normal_y"])
    assert basis_plan(bt.BMFRConfig()).default


def test_registered_features_become_planes_in_order(registered):
    """Codes follow ``cfg.all_features``; a built-in name among the scaled
    features keeps its code (the kernels scale by position, from lo); a
    name used twice is one plane."""
    for name, fn in CROSS.items():
        registered(name, fn)
    xy, yz, _ = CROSS
    cfg = bt.BMFRConfig(
        features_not_scaled=("const", "world_position_x"),
        features_scaled=(xy, "normal_y", yz, xy, "world_position_z2"))
    plan = basis_plan(cfg)
    assert cfg.features_not_scaled_count == 2
    assert plan.codes == (0, 4, PLANE_CODE, 2, PLANE_CODE + 1, PLANE_CODE, 9)
    assert plan.planes == (xy, yz)
    assert not plan.default
    assert plan.geometry == (1, 3, 5)
    # the default names in another order are not the default front
    shuffled = bt.BMFRConfig(features_scaled=tuple(
        reversed(bt.BMFRConfig().features_scaled)))
    assert not basis_plan(shuffled).default
    assert basis_plan(shuffled).planes == ()


def test_plane_table_addresses_and_ops():
    """Each code's plane (a raw plane, the colour plane for the constant,
    an extra plane) and op, the ops packed a byte each into two words."""
    n, p, a = (torch.zeros(3, 4, 8) for _ in range(3))
    extra = torch.zeros(2, 4, 8)
    step = 4 * 8 * 4
    plan = fitter_direct.BasisPlan(
        (0, 1, 3, 4, 6, 7, 9, PLANE_CODE + 1, PLANE_CODE), ("u", "v"), False)
    addresses, (lo, hi) = plane_table(plan, n, p, a, extra)
    assert addresses == (
        a.data_ptr(), n.data_ptr(), n.data_ptr() + 2 * step, p.data_ptr(),
        p.data_ptr() + 2 * step, p.data_ptr(), p.data_ptr() + 2 * step,
        extra.data_ptr() + step, extra.data_ptr())
    ops = lo.to_bytes(8, "little") + hi.to_bytes(8, "little")
    assert tuple(ops[:9]) == (ONE, VALUE, VALUE, VALUE, VALUE, SQUARE,
                              SQUARE, VALUE, VALUE)
    assert ops[9:] == bytes(7)


def test_basis_planes_evaluate_only_the_planes(registered):
    for name, fn in CROSS.items():
        registered(name, fn)
    cfg = bt.BMFRConfig(image_width=8, image_height=4, **THIRTEEN)
    r = np.random.default_rng(3)
    n, p = (torch.from_numpy(r.standard_normal((3, 4, 8)).astype(np.float32))
            for _ in range(2))
    got = fitter_direct.basis_planes(cfg, n, p)
    assert got.shape == (3, 4, 8) and got.is_contiguous()
    torch.testing.assert_close(got, torch.stack(
        [fn(n, p) for fn in CROSS.values()]), rtol=0, atol=0)
    assert fitter_direct.basis_planes(bt.BMFRConfig(image_width=8,
                                                    image_height=4),
                                      n, p) is None


@functools.partial(jax.jit, static_argnums=(0, 1))
def _jax_direct(cfg, which, raw9, f):
    """One JAX direct kernel (interpret mode) on the sliced view of frame
    ``f``, sliced back to the image as the pipeline does."""
    view = blockify_view(cfg, raw9, f)
    fit = jax_frd if which == "fit_reconstruct_direct" else jax_frc
    fview = fit(cfg, view, f)
    half = cfg.block_edge // 2
    off = jitter_offset(f, cfg.block_edge)
    return jax.lax.dynamic_slice(
        fview, (jnp.int32(0), half - off[1], half - off[0]),
        (3, cfg.image_height, cfg.image_width))


@pytest.mark.parametrize("which", ["fit_reconstruct_cholesky",
                                   "fit_reconstruct_direct"])
def test_reregistered_normal_x_matches_jax(tiny_cfg, tiny_scene, registered,
                                           which):
    """``normal_x`` as -n[0] on both sides: JAX's kernels evaluate the
    registry inside the kernel; the port's plain versions evaluate it too,
    and on the card the kernels now stage it as a plane. The config
    (noise_amount 0.0125) is used nowhere else, so JAX's jit traces it
    with the override."""
    registered("normal_x", lambda n, p: -n[0])
    sc, t = tiny_scene, 1
    raw9 = np.concatenate([to_chw(sc[k][t]) for k in
                           ("normals", "positions", "noisy")], axis=0)
    jcfg = tiny_cfg.replace(fitter_impl="pallas_direct",
                            noise_amount=0.0125).validate()
    cfg = bt.config_from_jax(jcfg)
    assert basis_plan(cfg).planes == ("normal_x",)
    want = np.asarray(_jax_direct(jcfg, which, jnp.asarray(raw9),
                                  jnp.int32(5)))
    planes = torch.from_numpy(raw9)
    got, _ = getattr(fitter_direct, which)(cfg, planes[0:3], planes[3:6],
                                           planes[6:9], 5)
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)
    # the override reaches the answer: the built-in normal_x gives another
    features.FEATURE_REGISTRY["normal_x"] = features._BUILTIN_FEATURES[
        "normal_x"]
    builtin, _ = getattr(fitter_direct, which)(cfg, planes[0:3],
                                               planes[3:6], planes[6:9], 5)
    assert float(np.abs(builtin.numpy() - want).max()) > 5e-3


def test_householder_slice_on_a_basis_matches_jax(tiny_cfg, tiny_scene,
                                                  registered):
    """The slice on the CPU: the direct Householder fitter on the 13-feature
    cross basis through ``denoise_sequence``, the f32 warp (no Pallas
    warp), so the JAX side reaches kernel C alone, in interpret mode. One
    frame: the fit, the reconstruction and the TAA of frame 0."""
    for name, fn in CROSS.items():
        registered(name, fn)
    sc = {k: v[:1] for k, v in tiny_scene.items()}
    jcfg = tiny_cfg.replace(warp_mode="float32", fitter_impl="pallas_direct",
                            solver="householder", **THIRTEEN).validate()
    want = np.asarray(jax.jit(lambda *a: jax_denoise_sequence(jcfg, *a))(
        JaxFrameInputs(*(jnp.asarray(np.moveaxis(sc[k], -1, -3)) for k in
                         ("normals", "positions", "noisy", "albedo"))),
        jnp.asarray(sc["camera_matrices"]), jnp.asarray(sc["pixel_offsets"])))
    cfg = bt.config_from_jax(jcfg)
    assert basis_plan(cfg).planes == tuple(CROSS)
    got = bt.denoise_sequence(
        cfg, bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], "cpu"),
        torch.from_numpy(sc["camera_matrices"]),
        torch.from_numpy(sc["pixel_offsets"])).numpy()
    dbs = [psnr(got[t], want[t]) for t in range(len(want))]
    print("householder on the 13-feature basis vs JAX, PSNR dB", dbs)
    assert np.isfinite(got).all()
    assert min(dbs) >= SLICE_DB, dbs


#: the basis B's Gram schedule: 8 warps, 2 steps of 64 pixels, 2 a lane
NW, STEPS, LANES = 8, 2, 32


def fma(acc, a, b):
    """f32 fused multiply-add, by the exact f64 product rounded once with
    the sum (to within a double rounding)."""
    return (acc.double() + a.double() * b.double()).float()


def replay_basis_gram(data, F):
    """``csrc/fitter_chol_basis.cu`` phase 3 on ``data [nb, NB, 1024]``
    f32: warp w sums pixels [128 w, 128 w + 128), lane l pixels 128 w + 64
    s + 2 l + j in the order (s, j); the lanes combine by the transpose
    reduction (partners lane ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1); the warps'
    sums add in warp order. Every sum of rows < F is taken (a 4x4 tile's
    clamped entries are copies of these). Returns ``[nb, F, NB]``."""
    nb, B, _ = data.shape
    x = data.view(nb, B, NW, STEPS, LANES, 2)
    acc = torch.zeros(nb, F, B, NW, LANES)
    for s in range(STEPS):
        for j in range(2):
            a = x[:, :F, None, :, s, :, j]
            b = x[:, None, :, :, s, :, j]
            acc = fma(acc, a.expand(nb, F, B, NW, LANES),
                      b.expand(nb, F, B, NW, LANES))
    t = acc.view(nb, F, B, NW, 2, 2, 2, 2, 2)
    for _ in range(5):
        t = t.select(4, 0) + t.select(4, 1)
    total = t[..., 0]
    for w in range(1, NW):
        total = total + t[..., w]
    return total


@pytest.mark.parametrize("stored", ["float32", "float16"])
def test_basis_gram_order_is_no_less_exact_than_plain(stored):
    r = np.random.default_rng(16)
    nb, B, F = 8, 16, 13
    # features near 1 and a small spread, as rescaled features sit: the
    # sums cancel in the normal equations
    data = (1.0 + 0.05 * r.standard_normal((nb, B, 1024))).astype(
        np.float32)
    data[:, 0] = 1.0
    if stored == "float16":
        data = data.astype(np.float16).astype(np.float32)
    t = torch.from_numpy(data)
    exact = torch.einsum("bfe,bge->bfg", t[:, :F].double(), t.double())
    got = replay_basis_gram(t, F).double()
    plain = fitter.gram(t, F).double()
    d_got = float((got - exact).norm() / exact.norm())
    d_plain = float((plain - exact).norm() / exact.norm())
    print(stored, "relative distance from the f64 Gram: replay", d_got,
          "plain", d_plain)
    assert d_got <= 2 ** 0.5 * d_plain, (d_got, d_plain)
