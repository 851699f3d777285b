"""The default path's kernels I, J and K (the raw-plane tap warp + blend,
the feature-block store and the block reconstruction) on the CPU: their
wrappers (the plain versions here) against the JAX stages they replace,
the claim kernel I's bf16 flag rests on, and the kernels' own index
arithmetic replayed in numpy against the plain versions.

The kernels themselves run on the card: ``tests/test_torch_gpu.py``
holds each against its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu import features as jfeat
from bmfr_tpu.ops import gather as jgather
from bmfr_tpu.ops import warp as jwarp
from bmfr_tpu.ops.blockify import build_feature_blocks as jax_bfb
from bmfr_tpu.ops.weighted_sum import weighted_sum as jax_ws
from bmfr_tpu_torch import features
from bmfr_tpu_torch.geometry import BLOCK_OFFSETS
from bmfr_tpu_torch.ops import blockify, gather, warp
from bmfr_tpu_torch.ops.blockify import (build_feature_blocks,
                                         build_feature_blocks_reference)
from bmfr_tpu_torch.ops.fitter_direct import feature_table
from bmfr_tpu_torch.ops.warp_blend import TAP_MODES, warp_blend_planes
from bmfr_tpu_torch.ops.weighted_sum import (BAND, THREADS, TILE,
                                             reconstruct_geometry,
                                             weighted_sum,
                                             weighted_sum_reference)
from conftest import to_chw
from torch_threads import one_intra_op_thread  # noqa: F401

H, W = 48, 64
INT_MAX = 2**31 - 1
T = torch.from_numpy


def same_bits(got, want):
    """Equal bit for bit where not NaN, NaN where NaN (the two frameworks'
    bf16 casts may give a NaN other bits)."""
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    bits = got.view(np.uint32) if got.dtype == np.float32 else got.view(
        np.uint16)
    want_bits = want.view(bits.dtype)
    np.testing.assert_array_equal(np.where(nan, 0, bits),
                                  np.where(nan, 0, want_bits))


# ---- kernel I: the raw-plane tap warp + blend ----

def extreme_field():
    """Coordinates through both screen edges (ix = -2, -1, W-1, W and
    beyond; iy off the bottom) with NaN, +-inf and +-2**31 among them."""
    yy = np.arange(H, dtype=np.float32)[:, None] + np.zeros((1, W), np.float32)
    xx = np.arange(W, dtype=np.float32)[None, :] + np.zeros((H, 1), np.float32)
    pfx = xx * (1.0 + 3.0 / W) - 1.6 + yy * (1.5 / H)
    pfy = yy * 1.01 + 2.3 - xx * (2.0 / W)
    pfx[0, :8] = pfy[1, :8] = [np.nan, np.inf, -np.inf, 1e30, -1e30,
                               2.0**31, -(2.0**31), -1.0]
    pfx[5:9, 3] = [np.inf, 2.0**31, np.nan, -np.inf]
    pfy[5:9, 4] = [np.inf, -np.inf, np.nan, 2.0**31]
    return pfx.astype(np.float32), pfy.astype(np.float32)


def state_planes(seed):
    """16 recurrent channels with NaN and infinities in ~3 % of them;
    spp (channel 9) an integer 0..255."""
    r = np.random.default_rng(seed)
    planes = (r.standard_normal((16, H, W))
              * 10.0 ** r.integers(-2, 3, (16, H, W))).astype(np.float32)
    mask = r.random((16, H, W)) < 0.03
    planes[mask] = r.choice(np.float32([np.nan, np.inf, -np.inf]),
                            int(mask.sum()))
    planes[9] = r.integers(0, 256, (H, W))
    return planes


def kernel_columns(ix, mode):
    """Kernel I's columns of the dx = 0 and dx = 1 taps
    (``csrc/warp_taps.cu``): clip(ix) and clip(ix + 1) with ix + 1
    wrapping at INT_MAX, or, for ``packed_x_bf16``, the x-pair word's
    column: 0 for ix < 0, else min(clip(ix) + 1, W - 1)."""
    ix = ix.astype(np.int64)
    cx0 = np.clip(ix, 0, W - 1)
    if mode == "packed_x_bf16":
        cx1 = np.where(ix < 0, 0, np.minimum(cx0 + 1, W - 1))
    else:
        cx1 = np.where(ix == INT_MAX, 0, np.clip(ix + 1, 0, W - 1))
    return cx0, cx1


@pytest.mark.parametrize("mode", ["packed_bf16", "packed_x_bf16"])
def test_bf16_modes_are_rounded_clipped_taps(mode):
    """The claim kernel I's bf16 flag rests on: each packed mode's taps
    (the port's gather_taps and the JAX package's) are the raw planes'
    values at kernel I's columns (``kernel_columns``) and rows (clip(iy),
    clip(iy + 1) wrapping at INT_MAX), rounded to bf16 nearest-even,
    bit for bit, NaN and infinite values and NaN, infinite and saturated
    coordinates included. For ``packed_bf16`` those are the float32
    mode's taps; for ``packed_x_bf16`` too, but at ix = INT_MAX, where
    the dx = 1 taps read column W-1 and not the wrapped column 0."""
    planes = state_planes(3)
    pfx, pfy = extreme_field()
    ix = gather.floor_int(T(pfx)).numpy()
    iy = gather.floor_int(T(pfy)).numpy()
    assert {-2, -1, W - 1, W, INT_MAX, -INT_MAX - 1} <= set(ix.ravel())
    assert (iy == INT_MAX).any() and (iy >= H).any() and (iy < 0).any()

    cy = (np.clip(iy.astype(np.int64), 0, H - 1),
          np.where(iy == INT_MAX, 0, np.clip(iy.astype(np.int64) + 1, 0,
                                             H - 1)))
    cx = kernel_columns(ix, mode)
    rounded = T(planes).to(torch.bfloat16).float().numpy()
    want = np.stack([rounded[:, cy[dy], cx[dx]]
                     for dx, dy in gather.TAP_OFFSETS])

    got = warp.gather_taps(T(planes), T(iy), T(ix), mode).numpy()
    same_bits(got, want)
    jgot = np.asarray(jwarp.gather_taps(jnp.asarray(planes), jnp.asarray(iy),
                                        jnp.asarray(ix), mode=mode))
    same_bits(jgot, want)

    f32 = warp.gather_taps(T(planes), T(iy), T(ix), "float32")
    f32 = f32.to(torch.bfloat16).float().numpy()
    differ = ~((got == f32) | (np.isnan(got) & np.isnan(f32)))
    if mode == "packed_bf16":
        assert not differ.any()
    else:
        # only the dx = 1 taps (1 and 3) of pixels at ix = INT_MAX
        where = np.zeros_like(differ)
        where[[1, 3]] = (ix == INT_MAX)[None, None]
        assert differ.any() and not (differ & ~where).any()


@pytest.mark.parametrize("mode", ["float32", "packed_bf16", "packed_x_bf16"])
def test_warp_blend_planes_matches_jax(tiny_cfg, tiny_scene, mode):
    """Kernel I's wrapper (its plain version on the CPU) on a raw-plane
    state against the JAX step's branch it replaces: ``stack_state``,
    ``gather_taps`` in ``mode`` and the tap branches of K1, K4 and K5.
    The stages run on the 13 planes on the port's side and on JAX's taps
    on JAX's; integer outputs equal, float ones within rtol = atol =
    1e-5 (only the association differs, tests/test_torch_stages.py)."""
    from bmfr_tpu.ops.accumulate import accumulate_filtered_data as jax_k4
    from bmfr_tpu.ops.reproject import accumulate_noisy_data as jax_k1
    from bmfr_tpu.ops.taa import taa as jax_taa

    from bmfr_tpu_torch.ops.accumulate import accumulate_filtered_data
    from bmfr_tpu_torch.ops.reproject import (accumulate_noisy_data,
                                              reproject_coords)
    from bmfr_tpu_torch.ops.taa import taa

    jcfg = tiny_cfg.replace(warp_mode=mode).validate()
    cfg = bt.config_from_jax(jcfg)
    sc, frame = tiny_scene, 2
    r = np.random.default_rng(12)
    pos, nrm, noisy, alb = (to_chw(sc[k][frame]) for k in
                            ("positions", "normals", "noisy", "albedo"))
    prev = dict(positions=to_chw(sc["positions"][1]),
                normals=to_chw(sc["normals"][1]),
                noisy=r.random((3, H, W)).astype(np.float32),
                spp=r.integers(1, 40, (H, W)).astype(np.uint8),
                out=r.random((3, H, W)).astype(np.float32),
                result=r.random((3, H, W)).astype(np.float32))
    state = bt.TemporalState(**{k: T(v) for k, v in prev.items()})
    cam, off = sc["camera_matrices"][1], sc["pixel_offsets"][frame]
    filtered = (r.random((3, H, W)) * 2.0).astype(np.float32)

    pfx, pfy = reproject_coords(cfg, T(pos), T(cam), T(off))
    n0 = warp_blend_planes.launches
    planes = warp_blend_planes(cfg, state, T(pos), T(nrm), pfx, pfy, mode)
    assert warp_blend_planes.launches == n0
    assert planes.shape == (13, H, W) and planes.dtype == torch.float32

    j = jnp.asarray
    # bmfr_tpu/pipeline/denoise.py:115-119 (stack_state)
    stacked = jnp.concatenate(
        [j(prev["positions"]), j(prev["normals"]), j(prev["noisy"]),
         j(prev["spp"]).astype(jnp.float32)[None], j(prev["out"]),
         j(prev["result"])], axis=0)
    jpfx, jpfy = (j(a.numpy()) for a in (pfx, pfy))
    jtaps = jwarp.gather_taps(stacked, jgather.floor_int(jpfy),
                              jgather.floor_int(jpfx), mode=mode)
    want1 = jax_k1(jcfg, j(nrm), j(pos), j(noisy), None, None, None, None,
                   j(cam), j(off), jnp.int32(frame), taps=jtaps[:, 0:10])
    got1 = accumulate_noisy_data(cfg, T(noisy), pfx, pfy, planes, frame)
    assert (got1["accept"].numpy() > 0).mean() > 0.2
    for k in ("spp", "accept"):
        np.testing.assert_array_equal(got1[k].numpy(), np.asarray(want1[k]))
    np.testing.assert_allclose(got1["accum"].numpy(),
                               np.asarray(want1["accum"]), rtol=1e-5,
                               atol=1e-5)
    spp = np.array(want1["spp"])
    want4 = jax_k4(jcfg, j(filtered), want1["prev_pixels"], want1["accept"],
                   j(alb), j(spp), None, jnp.int32(frame),
                   taps=jtaps[:, 10:13])
    got4 = accumulate_filtered_data(cfg, T(filtered), planes, T(alb),
                                    T(spp), frame)
    for g, w in zip(got4, want4):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)
    pp, tone = np.array(want1["prev_pixels"]), np.array(want4[1])
    want5 = jax_taa(jcfg, j(pp), j(tone), None, jnp.int32(frame),
                    taps=jtaps[:, 13:16])
    np.testing.assert_allclose(taa(cfg, T(pp), T(tone), planes,
                                   frame).numpy(), np.asarray(want5),
                               rtol=1e-5, atol=1e-5)


def test_warp_blend_planes_is_the_stacked_gather_and_blend(tiny_cfg):
    """On the CPU the wrapper is its plain version (the stacked state's
    gather and the blend, bit for bit) on a field with off-screen, NaN and
    infinite coordinates and NaN and infinite state values; an unknown
    mode or device raises."""
    from bmfr_tpu_torch.ops.warp_blend import blend_gathered_taps

    cfg = bt.config_from_jax(tiny_cfg)
    planes = state_planes(4)
    state = bt.TemporalState(
        positions=T(planes[0:3]), normals=T(planes[3:6]),
        noisy=T(planes[6:9]), spp=T(planes[9].astype(np.uint8)),
        out=T(planes[10:13]), result=T(planes[13:16]))
    cur = T(np.random.default_rng(5).standard_normal((6, H, W)).astype(
        np.float32))
    pfx, pfy = (T(a) for a in extreme_field())
    for mode in TAP_MODES:
        got = warp_blend_planes(cfg, state, cur[0:3], cur[3:6], pfx, pfy,
                                mode)
        taps = warp.gather_taps(state.stacked(), gather.floor_int(pfy),
                                gather.floor_int(pfx), mode)
        want = blend_gathered_taps(cfg, taps, cur[0:3], cur[3:6], pfx, pfy)
        same_bits(got.numpy(), want.numpy())
        assert bool(torch.isnan(got).any())
    with pytest.raises(ValueError, match="warp mode 'pallas'"):
        warp_blend_planes(cfg, state, cur[0:3], cur[3:6], pfx, pfy, "pallas")
    with pytest.raises(ValueError, match="unsupported device"):
        warp_blend_planes(cfg, state, cur[0:3], cur[3:6], pfx.to("meta"),
                          pfy.to("meta"), "float32")


# ---- kernel J: the feature-block store ----

@pytest.fixture
def registered():
    """A feature outside the built-in set, in both registries."""
    name = "default_kernels_xy"

    def fn(n, p):
        return p[0] * n[1] - p[2]

    jfeat.register_feature(name, fn)
    features.register_feature(name, fn)
    yield name
    jfeat.FEATURE_REGISTRY.pop(name, None)
    features.FEATURE_REGISTRY.pop(name, None)


def geometry_planes(seed):
    """normals, positions and accumulated colour f32 [3, H, W] each, with
    NaN, infinities and values beyond f16's range among them."""
    r = np.random.default_rng(seed)
    p = (r.standard_normal((9, H, W)) * 10.0 ** r.integers(
        -1, 3, (9, H, W))).astype(np.float32)
    mask = r.random((9, H, W)) < 0.02
    p[mask] = r.choice(np.float32([np.nan, np.inf, -np.inf, 7e4, -9e4]),
                       int(mask.sum()))
    return p


@pytest.mark.parametrize("block_edge", [16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_build_feature_blocks_matches_jax(tiny_cfg, dtype, block_edge):
    """Kernel J's wrapper (its plain version on the CPU) against JAX's
    ``build_feature_blocks`` bit for bit, over frames of four jitter
    entries (the table scaled for block_edge 16 and 64), NaN, infinite and
    out-of-f16-range values included."""
    jcfg = tiny_cfg.replace(tmp_data_dtype=dtype,
                            block_edge=block_edge).validate()
    cfg = bt.config_from_jax(jcfg)
    p = geometry_planes(block_edge)
    jp = jnp.asarray(p)
    n0 = build_feature_blocks.launches
    for frame in (0, 5, 14, 25):
        got = build_feature_blocks(cfg, *T(p).split(3), frame)
        want = np.asarray(jax_bfb(jcfg, jp[0:3], jp[3:6], jp[6:9],
                                  jnp.int32(frame)))
        assert got.shape == (cfg.n_blocks, cfg.buffer_count,
                             cfg.block_pixels)
        assert str(got.dtype) == f"torch.{dtype}"
        same_bits(got.float().numpy(), want.astype(np.float32))
    assert build_feature_blocks.launches == n0


def test_build_feature_blocks_registered_feature(tiny_cfg, registered):
    """A basis with a registered feature: the plain version against JAX's
    on f16 tmp, and the feature table kernels J and K take (the built-in
    features as raw planes and ops, the registered one as an extra
    plane)."""
    from bmfr_tpu_torch.ops.fitter_direct import ONE, SQUARE, VALUE

    scaled = ("world_position_x", registered, "world_position_z2")
    jcfg = tiny_cfg.replace(tmp_data_dtype="float16",
                            features_scaled=scaled).validate()
    cfg = bt.config_from_jax(jcfg)
    p = geometry_planes(7)
    jp = jnp.asarray(p)
    n, pos, acc = T(p).split(3)
    got = build_feature_blocks(cfg, n, pos, acc, 3)
    want = np.asarray(jax_bfb(jcfg, jp[0:3], jp[3:6], jp[6:9], jnp.int32(3)))
    same_bits(got.float().numpy(), want.astype(np.float32))

    n, pos, acc = (t.contiguous() for t in (n, pos, acc))
    extra, planes, ops = feature_table(cfg, n, pos, acc)
    step = H * W * 4
    assert extra.shape == (1, H, W)
    assert list(planes) == [acc.data_ptr(), n.data_ptr(), n.data_ptr() + step,
                            n.data_ptr() + 2 * step, pos.data_ptr(),
                            extra.data_ptr(), pos.data_ptr() + 2 * step]
    codes = [(ops[i // 8] >> (8 * (i % 8))) & 0xFF for i in range(7)]
    assert codes == [ONE, VALUE, VALUE, VALUE, VALUE, VALUE, SQUARE]


def test_feature_table_takes_wide_bases(tiny_cfg):
    """Kernels J and K take up to 64 features: a 20-feature basis fills
    three op words; 65 features raise."""
    names = ("world_position_x", "world_position_y2") * 8
    cfg = bt.config_from_jax(tiny_cfg).replace(features_scaled=names)
    n, pos, acc = T(geometry_planes(1)).split(3)
    _, planes, ops = feature_table(cfg, n, pos, acc)
    assert len(planes) == 20 and len(ops) == 3
    assert (ops[2] >> 24) & 0xFF == 1          # feature 19: a square
    with pytest.raises(NotImplementedError, match="64 features"):
        feature_table(cfg.replace(features_scaled=names * 4 + names[:1]),
                      n, pos, acc)


def mirror_c(i, size):
    """``bmfr::mirror`` of fitter_front.cuh with C's truncating %."""
    period = 2 * size
    m = np.fmod(i, period)
    m = np.where(m < 0, m + period, m)
    return np.where(m < size, m, period - 1 - m)


@pytest.mark.parametrize("block_edge", [8, 24, 40])
@pytest.mark.parametrize("frame", [1, 9])
def test_feature_blocks_index_arithmetic(tiny_cfg, block_edge, frame):
    """Kernel J's addressing replayed in numpy (one thread per cell p:
    block p // bp, element p % bp, the jitter (table * be) >> 5, the
    mirror with C's %) gives the plain version's blocks."""
    cfg = bt.config_from_jax(tiny_cfg).replace(block_edge=block_edge)
    be, bp, half = block_edge, block_edge**2, block_edge // 2
    p = geometry_planes(2)
    want = build_feature_blocks_reference(cfg, *T(p).split(3), frame)
    stored = blockify._feature_planes(cfg, *T(p).split(3)).numpy()

    cell = np.arange(cfg.n_blocks * bp)
    b, e = cell // bp, cell % bp
    ey, ex = e // be, e % be
    by, bx = b // cfg.blocks_x, b % cfg.blocks_x
    ox, oy = (BLOCK_OFFSETS[frame & 15] * be) >> 5
    y = mirror_c(by * be + ey - half + oy, H)
    x = mirror_c(bx * be + ex - half + ox, W)
    got = np.zeros(want.shape, np.float32)
    got[b, :, e] = stored[:, y, x].T
    same_bits(got, want.numpy())


# ---- kernel K: the block reconstruction ----

def fitted(cfg, seed):
    """Weights and mins/maxs of a fit: some ranges above 1, some below."""
    r = np.random.default_rng(seed)
    w = (r.standard_normal((cfg.n_blocks, cfg.feature_count, 3))
         * 0.3).astype(np.float32)
    mm = np.sort(r.standard_normal((cfg.n_blocks, cfg.features_scaled_count,
                                    2)) * r.choice([0.2, 3.0], (
                                        cfg.n_blocks, cfg.features_scaled_count,
                                        1)), axis=-1).astype(np.float32)
    return w, mm


@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_weighted_sum_matches_jax(tiny_cfg, tiny_scene, dtype):
    """Kernel K's wrapper (its plain version on the CPU) against JAX's
    ``weighted_sum``: with f32 tmp it reuses the blocks' feature rows
    (NaN turned into 0), with f16 tmp it evaluates the raw features (NaN
    kept); rtol = atol = 1e-5 (the products' order), NaN where NaN."""
    jcfg = tiny_cfg.replace(tmp_data_dtype=dtype).validate()
    cfg = bt.config_from_jax(jcfg)
    frame = 6
    p = np.concatenate([to_chw(tiny_scene[k][1]) for k in
                        ("normals", "positions", "noisy")], axis=0)
    p[3, 10, 5:9] = np.nan        # a few positions without a hit
    jp = jnp.asarray(p)
    n, pos, acc = T(p).split(3)
    w, mm = fitted(cfg, 8)
    tmp = build_feature_blocks(cfg, n, pos, acc, frame)
    tmp_j = jax_bfb(jcfg, jp[0:3], jp[3:6], jp[6:9], jnp.int32(frame))
    n0 = weighted_sum.launches
    got = weighted_sum(cfg, T(w), T(mm), n, pos, acc, frame,
                       feature_blocks=tmp).numpy()
    assert weighted_sum.launches == n0
    want = np.asarray(jax_ws(jcfg, jnp.asarray(w), jnp.asarray(mm), jp[0:3],
                             jp[3:6], jp[6:9], jnp.int32(frame),
                             feature_blocks=tmp_j))
    assert np.isnan(got).any() == (dtype == "float16")
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="unsupported device"):
        weighted_sum(cfg, T(w), T(mm), n.to("meta"), pos, acc, frame)


@pytest.mark.parametrize("sanitize", [True, False])
@pytest.mark.parametrize("block_edge", [16, 32])
def test_block_reconstruct_index_arithmetic(tiny_cfg, block_edge, sanitize):
    """Kernel K's per-pixel arithmetic replayed in numpy: the pixel's
    block under the inverse jitter, the rescale in f32, the products
    summed in f64, the clamp keeping NaN; the plain version lies within
    2e-6 of the sum of the products' magnitudes (an f32 10-term dot
    product's rounding in any order) of it on every finite value, NaN
    where NaN."""
    cfg = bt.config_from_jax(tiny_cfg).replace(block_edge=block_edge)
    be, half = block_edge, block_edge // 2
    F, lo = cfg.feature_count, cfg.features_not_scaled_count
    p = geometry_planes(9)
    p[3:6] = np.clip(p[3:6], -30, 30)     # finite sums, some NaN
    n, pos, acc = T(p).split(3)
    frame = 7
    w, mm = fitted(cfg, 3)
    tmp = build_feature_blocks_reference(cfg, n, pos, acc, frame)
    want = weighted_sum_reference(
        cfg, T(w), T(mm), n, pos, acc, frame,
        feature_blocks=tmp if sanitize else None).numpy()

    feats = features.evaluate_features(cfg.all_features, n, pos).numpy()
    if sanitize:
        feats = np.where(np.isnan(feats), 0.0, feats)
    ox, oy = (BLOCK_OFFSETS[frame & 15] * be) >> 5
    yy, xx = np.mgrid[0:H, 0:W]
    b = ((yy + half - oy) // be) * cfg.blocks_x + (xx + half - ox) // be
    rng_ = mm[b, :, 1] - mm[b, :, 0]                    # [H, W, F - lo]
    d = np.where(np.abs(rng_) > 1.0, rng_, 1.0)
    basis = feats.transpose(1, 2, 0).copy()
    basis[..., lo:] = (basis[..., lo:] - mm[b, :, 0]) / d
    terms = basis[..., None] * w[b]                      # [H, W, F, 3]
    got = np.maximum(terms.astype(np.float64).sum(axis=2), 0.0)
    got = np.where(np.isnan(terms.sum(axis=2)), np.nan, got)
    got = got.transpose(2, 0, 1)
    mag = np.abs(terms.astype(np.float64)).sum(axis=2).transpose(2, 0, 1)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = np.isfinite(want)
    assert ok.mean() > 0.9 and F == 10
    np.testing.assert_array_equal(got[~ok], want[~ok])
    assert np.all(np.abs(got[ok] - want[ok]) <= 2e-6 * mag[ok])


def replay_tiles(cfg, frame):
    """Kernel K's CTA -> pixel map replayed in numpy, launched as
    ``reconstruct_geometry`` says: per tile, thread and row of its band,
    the pixel it writes and the slot of the block whose values it takes.
    Returns the pixels written, (y, x, block row, block column) each, and
    per tile whether it is live and how many blocks a live one stages."""
    geo = reconstruct_geometry(cfg)
    be, half = cfg.block_edge, cfg.block_edge // 2
    H, W = cfg.image_height, cfg.image_width
    ox, oy = (BLOCK_OFFSETS[frame & 15] * be) >> 5
    # per tile: its first cell, the window and the blocks it touches
    ty, tx = np.divmod(np.arange(geo.tiles_y * geo.tiles_x, dtype=np.int32),
                       geo.tiles_x)
    mx0, my0 = tx * TILE, ty * TILE
    x0, y0 = mx0 - half + ox, my0 - half + oy
    xa, xb = np.maximum(x0, 0), np.minimum(x0 + TILE, W)
    ya, yb = np.maximum(y0, 0), np.minimum(y0 + TILE, H)
    live = (xa < xb) & (ya < yb)
    bx0, by0 = (mx0 + xa - x0) // be, (my0 + ya - y0) // be
    nbx = (mx0 + xb - 1 - x0) // be - bx0 + 1
    nby = (my0 + yb - 1 - y0) // be - by0 + 1
    if be % TILE == 0:
        # the kernel stages a tile inside one block before the frame is
        # read: the window's blocks must be that block
        assert (nbx[live] == 1).all() and (nby[live] == 1).all()
        assert (bx0 == mx0 // be)[live].all() and (by0 == my0 // be)[live].all()
    # per thread and row of its band: the pixel, kept where it is in the
    # window of a live tile
    t = np.arange(THREADS, dtype=np.int32)
    c, band = t % TILE, t // TILE
    x = x0[:, None] + c                                  # [tiles, THREADS]
    y = (y0[:, None, None] + (band * BAND)[:, None]
         + np.arange(BAND, dtype=np.int32))              # [.., BAND]
    written = (live[:, None, None]
               & ((x >= xa[:, None]) & (x < xb[:, None]))[:, :, None]
               & (y >= ya[:, None, None]) & (y < yb[:, None, None]))
    idx = np.flatnonzero(written)
    tile, rest = np.divmod(idx, THREADS * BAND)
    thread = rest // BAND
    slot = (((my0[tile] + band[thread] * BAND) // be - by0[tile]) * nbx[tile]
            + (mx0[tile] + c[thread]) // be - bx0[tile])
    assert ((slot >= 0) & (slot < nby[tile] * nbx[tile])).all()
    return (y.ravel()[idx], x.ravel()[idx // BAND],
            by0[tile] + slot // nbx[tile], bx0[tile] + slot % nbx[tile],
            live, (nby * nbx)[live])


@pytest.mark.parametrize("size", [(48, 64), (100, 332), (720, 1280)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("block_edge", [8, 16, 32, 64])
def test_block_reconstruct_tiles_cover_each_pixel_once(size, block_edge):
    """Kernel K's launch (``reconstruct_geometry``) and its CTA -> pixel
    map, replayed in numpy at every one of the 16 jitter frames: each
    image pixel is written exactly once, with the values of the block
    ``weighted_sum_image``'s mapping gives it, (y + half - oy) // be and
    (x + half - ox) // be; a tile stages no more blocks than the shared
    memory the launch gives it holds; the grid does not depend on the
    frame; at 720x1280 and block_edge 32 the last row of tiles is empty
    exactly when oy >= 0."""
    H, W = size
    cfg = bt.BMFRConfig(image_width=W, image_height=H, block_edge=block_edge)
    be, half = block_edge, block_edge // 2
    F, lo = cfg.feature_count, cfg.features_not_scaled_count
    geo = reconstruct_geometry(cfg)
    assert geo.default_basis
    # the blocks a tile's shared memory holds
    slots, rest = divmod(geo.smem, 4 * (2 * (F - lo) + 3 * F))
    assert rest == 0 and slots >= 1
    for frame in range(16):
        ox, oy = (BLOCK_OFFSETS[frame] * be) >> 5
        y, x, by, bx, live, staged = replay_tiles(cfg, frame)
        count = np.bincount(y * W + x, minlength=H * W)
        assert len(count) == H * W and (count == 1).all(), frame
        assert (by == (y + half - oy) // be).all(), frame
        assert (bx == (x + half - ox) // be).all(), frame
        assert (by < cfg.blocks_y).all() and (bx < cfg.blocks_x).all()
        assert staged.max() <= slots
        if size == (720, 1280) and be == 32:
            assert (geo.tiles_x, geo.tiles_y) == (41, 24)
            assert live.reshape(24, 41)[23].any() == (oy < 0)
    assert reconstruct_geometry(cfg) == geo


def test_reconstruct_geometry_picks_the_default_basis(tiny_cfg):
    """Kernel K's register instance serves the ten default features with
    the first four unscaled, each still built in; any other basis, or the
    same ten split otherwise, takes the table's instance."""
    cfg = bt.config_from_jax(tiny_cfg)
    assert reconstruct_geometry(cfg).default_basis
    first_order = cfg.replace(features_scaled=cfg.features_scaled[:3])
    assert not reconstruct_geometry(first_order).default_basis
    split = cfg.replace(features_not_scaled=cfg.all_features[:3],
                        features_scaled=cfg.all_features[3:])
    assert not reconstruct_geometry(split).default_basis
