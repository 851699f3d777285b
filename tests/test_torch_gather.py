"""The port's tap helpers against the JAX package's: ``floor_int`` at the
edges of the f32 -> s32 conversion, ``gather_planes``, the x-pair pack and
``gather_taps`` in all four modes, bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bmfr_tpu.ops import gather as jgather
from bmfr_tpu.ops import warp as jwarp
from bmfr_tpu_torch.ops import gather, warp

from torch_threads import one_intra_op_thread  # noqa: F401

#: NaN, +-inf, +-1e30, +-2**31 and the f32 neighbours of the int32 range
EDGES = np.float32([np.nan, np.inf, -np.inf, 1e30, -1e30, 2.0**31, -(2.0**31),
                    2147483520.0, -2147483904.0, 3e9, -3e9, 0.0, -0.0, 0.5,
                    -0.5, -1.0, -1.5, 1.999, 1279.99, -2.0001, 7e6])


def test_floor_int_matches_jax_at_the_edges():
    want = np.asarray(jgather.floor_int(jnp.asarray(EDGES)))
    got = gather.floor_int(torch.from_numpy(EDGES))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] == 0 and got[1] == 2**31 - 1 and got[2] == -(2**31)


H, W = 48, 64


def index_field(seed=0):
    """Reprojected coordinates through both screen edges (ix = -2, -1, W-1,
    W; iy off the bottom) plus saturated ones (NaN, +-inf, +-1e30), and
    their floors."""
    yy = np.arange(H, dtype=np.float32)[:, None] + np.zeros((1, W), np.float32)
    xx = np.arange(W, dtype=np.float32)[None, :] + np.zeros((H, 1), np.float32)
    pfx = xx * (1.0 + 3.0 / W) - 1.6 + yy * (1.5 / H)
    pfy = yy * 1.01 + 2.3 - xx * (2.0 / W)
    pfx[0, :8] = pfy[1, :8] = [np.nan, np.inf, -np.inf, 1e30, -1e30,
                               2.0**31, -(2.0**31), -1.0]
    pfx, pfy = pfx.astype(np.float32), pfy.astype(np.float32)
    ix = np.asarray(jgather.floor_int(jnp.asarray(pfx)))
    iy = np.asarray(jgather.floor_int(jnp.asarray(pfy)))
    assert {-2, -1, W - 1, W} <= set(ix.ravel()) and (iy >= H).any()
    return pfx, pfy, ix, iy


def planes16(seed=0):
    r = np.random.default_rng(seed)
    return (r.standard_normal((16, H, W)) * 10.0 ** r.integers(
        -2, 3, (16, H, W))).astype(np.float32)


def test_gather_planes_matches_jax():
    src = planes16()
    _, _, ix, iy = index_field()
    for dy, dx in ((0, 0), (1, 0), (0, 1), (1, 1)):
        yi = jnp.asarray(iy) + dy        # XLA's wrapping add
        xi = jnp.asarray(ix) + dx
        want = np.asarray(jgather.gather_planes(jnp.asarray(src), yi, xi))
        got = gather.gather_planes(torch.from_numpy(src),
                                   torch.from_numpy(np.asarray(yi)),
                                   torch.from_numpy(np.asarray(xi)))
        np.testing.assert_array_equal(got.numpy(), want)


def test_pack_x_pairs_bf16_bit_exact():
    src = planes16(1)
    want = np.asarray(jwarp.pack_x_pairs_bf16(jnp.asarray(src)))
    got = warp.pack_x_pairs_bf16(torch.from_numpy(src)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["float32", "packed_bf16", "packed_x_bf16",
                                  "pallas"])
def test_gather_taps_matches_jax(mode):
    """Every mode bit for bit on every pixel, edges and saturated
    coordinates included. Mode "pallas" is held to JAX's "packed_x_bf16",
    which tests/test_warp_pallas.py pins bit-equal to
    ``warp_rows_pallas``; on the CPU it runs kernel E's plain version."""
    src = planes16(2)
    _, _, ix, iy = index_field()
    jmode = "packed_x_bf16" if mode == "pallas" else mode
    want = np.asarray(jwarp.gather_taps(jnp.asarray(src), jnp.asarray(iy),
                                        jnp.asarray(ix), mode=jmode))
    n0 = warp.warp_rows.launches
    got = warp.gather_taps(torch.from_numpy(src), torch.from_numpy(iy),
                           torch.from_numpy(ix), mode=mode)
    assert warp.warp_rows.launches == n0
    assert got.dtype == torch.float32 and got.shape == (4, 16, H, W)
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


def test_warp_rows_plain_is_the_clipped_row_pair():
    """Kernel E's plain version is JAX's two packed_x_bf16 gathers on every
    pixel (``iy + 1`` wrapping at INT_MAX), not only on in-bounds taps."""
    src = warp.pack_x_pairs_bf16(torch.from_numpy(planes16(3)))
    _, _, ix, iy = index_field()
    row0, row1 = warp.warp_rows(src, torch.from_numpy(iy),
                                torch.from_numpy(ix))
    s = jnp.asarray(src.numpy())
    np.testing.assert_array_equal(row0.numpy(), np.asarray(
        jgather.gather_planes(s, jnp.asarray(iy), jnp.asarray(ix))))
    np.testing.assert_array_equal(row1.numpy(), np.asarray(
        jgather.gather_planes(s, jnp.asarray(iy) + 1, jnp.asarray(ix))))
    with pytest.raises(ValueError, match="unsupported device"):
        warp.warp_rows(src.to("meta"), torch.from_numpy(iy).to("meta"),
                       torch.from_numpy(ix).to("meta"))


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["float32", "packed_x_bf16"])
def test_tap_branches_match_jax(tiny_cfg, tiny_scene, residual, mode):
    """The tap branches of K1, K4 and K5: the port blends the gathered
    taps into the 13 planes (``blend_gathered_taps``) and runs the stages
    on them; JAX runs each stage's own tap branch on the same taps. The
    integer outputs are equal, the float ones within rtol = atol = 1e-5
    (tests/test_torch_stages.py's pin: only association differs)."""
    from bmfr_tpu.ops.accumulate import accumulate_filtered_data as jax_k4
    from bmfr_tpu.ops.reproject import accumulate_noisy_data as jax_k1
    from bmfr_tpu.ops.taa import taa as jax_taa

    import bmfr_tpu_torch as bt
    from bmfr_tpu_torch.ops.accumulate import accumulate_filtered_data
    from bmfr_tpu_torch.ops.reproject import (accumulate_noisy_data,
                                              reproject_coords)
    from bmfr_tpu_torch.ops.taa import taa
    from bmfr_tpu_torch.ops.warp_blend import blend_gathered_taps
    from conftest import to_chw

    jcfg = tiny_cfg.replace(residual_dtype=residual,
                            warp_mode=mode).validate()
    cfg = bt.config_from_jax(jcfg)
    sc = tiny_scene
    frame = 2
    r = np.random.default_rng(11)
    pos, nrm, noisy, alb = (to_chw(sc[k][frame]) for k in
                            ("positions", "normals", "noisy", "albedo"))
    # the previous state: frame 1's geometry, random history planes
    prev = np.concatenate([
        to_chw(sc["positions"][1]), to_chw(sc["normals"][1]),
        r.random((3, H, W)), r.integers(1, 40, (1, H, W)),
        r.random((6, H, W))]).astype(np.float32)
    cam = sc["camera_matrices"][1]
    off = sc["pixel_offsets"][frame]
    filtered = (r.random((3, H, W)) * 2.0).astype(np.float32)
    T = torch.from_numpy

    pfx, pfy = reproject_coords(cfg, T(pos), T(cam), T(off))
    ix, iy = gather.floor_int(pfx), gather.floor_int(pfy)
    taps = warp.gather_taps(T(prev), iy, ix, mode=mode)
    jtaps = jnp.asarray(taps.numpy())
    planes = blend_gathered_taps(cfg, taps, T(pos), T(nrm), pfx, pfy)

    j = lambda a: jnp.asarray(a)  # noqa: E731
    want1 = jax_k1(jcfg, j(nrm), j(pos), j(noisy), None, None, None, None,
                   j(cam), j(off), jnp.int32(frame), taps=jtaps[:, 0:10])
    got1 = accumulate_noisy_data(cfg, T(noisy), pfx, pfy, planes, frame)
    assert (got1["accept"].numpy() > 0).mean() > 0.2
    for k in ("spp", "accept"):
        np.testing.assert_array_equal(got1[k].numpy(), np.asarray(want1[k]))
    for k in ("accum", "prev_pixels"):
        np.testing.assert_allclose(got1[k].numpy(), np.asarray(want1[k]),
                                   rtol=1e-5, atol=1e-5)

    spp = np.array(want1["spp"])
    want4 = jax_k4(jcfg, j(filtered), want1["prev_pixels"], want1["accept"],
                   j(alb), j(spp), None, jnp.int32(frame),
                   taps=jtaps[:, 10:13])
    got4 = accumulate_filtered_data(cfg, T(filtered), planes, T(alb),
                                    T(spp), frame)
    for g, w in zip(got4, want4):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)

    pp = np.array(want1["prev_pixels"])
    tone = np.array(want4[1])
    want5 = jax_taa(jcfg, j(pp), j(tone), None, jnp.int32(frame),
                    taps=jtaps[:, 13:16])
    got5 = taa(cfg, T(pp), T(tone), planes, frame)
    np.testing.assert_allclose(got5.numpy(), np.asarray(want5), rtol=1e-5,
                               atol=1e-5)
