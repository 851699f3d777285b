"""The elementwise stages of the port against the JAX package's, fed the
same pre-blended warp planes: reprojection + the K1 tail, K4 and K5
(both residual dtypes). The integer outputs (spp, accept) must be equal;
the float outputs agree to rtol = atol = 1e-5 (the blend-plane pin of
docs/DIVERGENCES.md #11: only operation association differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.ops.accumulate import accumulate_filtered_data as jax_k4
from bmfr_tpu.ops.reproject import accumulate_noisy_data as jax_k1
from bmfr_tpu.ops.taa import taa as jax_taa
from bmfr_tpu_torch.ops.accumulate import accumulate_filtered_data
from bmfr_tpu_torch.ops.reproject import (accumulate_noisy_data,
                                          reproject_coords)
from bmfr_tpu_torch.ops.taa import taa
from conftest import to_chw
from torch_threads import one_intra_op_thread  # noqa: F401

TOL = 1e-5
H, W = 48, 64


def random_planes(rng):
    """13 blend planes shaped like the warp's output: zero total weight
    on ~1/5 of the pixels, accept bits 0..15, sums = weight x value."""
    tw = rng.random((H, W)).astype(np.float32)
    tw[rng.random((H, W)) < 0.2] = 0.0
    k5w = rng.random((H, W)).astype(np.float32)
    k5w[rng.random((H, W)) < 0.1] = 0.0
    spp = rng.integers(1, 300, (H, W)).astype(np.float32)
    return np.concatenate([
        tw * rng.random((3, H, W)), (tw * spp)[None], tw[None],
        rng.integers(0, 16, (1, H, W)), tw * rng.random((3, H, W)),
        k5w * rng.random((3, H, W)), k5w[None]], axis=0).astype(np.float32)


def taps_dict(planes):
    p = jnp.asarray(planes)
    return dict(k1_color_sum=p[0:3], k1_spp_sum=p[3], total_weight=p[4],
                accept=p[5].astype(jnp.uint8), k4_out_sum=p[6:9],
                k5_result_sum=p[9:12], k5_weight=p[12])


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("frame", [0, 3])
@pytest.mark.parametrize("skips", [False, True])
def test_stages_match_jax(tiny_cfg, tiny_scene, residual, frame, skips):
    jcfg = tiny_cfg.replace(residual_dtype=residual, skip_second_accum=skips,
                            skip_taa=skips).validate()
    cfg = bt.config_from_jax(jcfg)
    rng = np.random.default_rng(frame + 7 * skips)
    sc = tiny_scene
    pos, nrm, noisy, alb = (to_chw(sc[k][2]) for k in
                            ("positions", "normals", "noisy", "albedo"))
    cam = sc["camera_matrices"][1]
    # a large sub-pixel offset pushes the right and bottom edges off
    # screen, so the off-screen passthrough and the edge bits engage
    off = np.array([-5.0, 3.0], np.float32)
    planes = random_planes(rng)
    filtered = rng.random((3, H, W)).astype(np.float32) * 2.0
    T = torch.from_numpy

    # K1: reprojection + tail
    want1 = jax_k1(jcfg, jnp.asarray(nrm), jnp.asarray(pos),
                   jnp.asarray(noisy), None, None, None, None,
                   jnp.asarray(cam), jnp.asarray(off), jnp.int32(frame),
                   taps=taps_dict(planes))
    pfx, pfy = reproject_coords(cfg, T(pos), T(cam), T(off))
    got1 = accumulate_noisy_data(cfg, T(noisy), pfx, pfy, T(planes), frame)
    ix = np.floor(got1["prev_pixels"][0].numpy())
    if frame:
        assert (ix >= W).any()
    for k in ("spp", "accept"):
        np.testing.assert_array_equal(got1[k].numpy(), np.asarray(want1[k]))
    for k in ("accum", "prev_pixels"):
        np.testing.assert_allclose(got1[k].numpy(), np.asarray(want1[k]),
                                   rtol=TOL, atol=TOL)

    # K4 on K1's (shared) outputs
    spp = np.array(want1["spp"])
    want4 = jax_k4(jcfg, jnp.asarray(filtered), want1["prev_pixels"],
                   want1["accept"], jnp.asarray(alb), jnp.asarray(spp), None,
                   jnp.int32(frame), taps=taps_dict(planes))
    got4 = accumulate_filtered_data(cfg, T(filtered), T(planes), T(alb),
                                    T(spp), frame)
    for g, w in zip(got4, want4):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)

    # K5 on the shared reprojection map and tone
    pp = np.array(want1["prev_pixels"])
    tone = np.array(want4[1])
    want5 = jax_taa(jcfg, jnp.asarray(pp), jnp.asarray(tone), None,
                    jnp.int32(frame), taps=taps_dict(planes))
    got5 = taa(cfg, T(pp), T(tone), T(planes), frame)
    np.testing.assert_allclose(got5.numpy(), np.asarray(want5), rtol=TOL,
                               atol=TOL)
