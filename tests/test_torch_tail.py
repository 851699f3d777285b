"""Kernels F, G and H's wrappers on CPU tensors (their plain versions)
against the JAX package's functions that XLA fuses into the TPU step:
the reprojection (``bmfr_tpu.ops.reproject.reproject_coords``), the K1
tail (``accumulate_noisy_data`` on pre-blended taps), K4
(``accumulate_filtered_data``), K5 (``taa``) and the next state's words
(``bmfr_tpu.ops.warp.pack_pairs_bf16`` of the geometry, accum/spp and
out/result channels). Integer outputs are equal, float outputs agree to
rtol = atol = 1e-5 (the stage pin of ``tests/test_torch_stages.py``), and
the packed words to one bf16 ulp: a value 1e-5 from JAX's may round to
the neighbouring bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.ops.accumulate import accumulate_filtered_data as jax_k4
from bmfr_tpu.ops.reproject import accumulate_noisy_data as jax_k1
from bmfr_tpu.ops.reproject import reproject_coords as jax_reproject
from bmfr_tpu.ops.taa import taa as jax_taa
from bmfr_tpu.ops.warp import pack_pairs_bf16 as jax_pack
from bmfr_tpu_torch.ops.reproject import (noisy_tail, reproject_coords,
                                          reproject_coords_reference)
from bmfr_tpu_torch.ops.tail import filtered_tail
from conftest import to_chw
from test_torch_stages import H, W, TOL, random_planes, taps_dict
from torch_threads import one_intra_op_thread  # noqa: F401

SKIPS = {"none": {}, "skip_taa": dict(skip_taa=True),
         "skip_second_accum": dict(skip_second_accum=True)}


def bf16_order(words):
    """i32 words -> the ordered integer of each bf16 half ``[2, ...]``:
    neighbouring bf16 values differ by 1, +0 and -0 are both 0."""
    u = np.asarray(words).astype(np.int64) & 0xFFFFFFFF
    halves = np.stack([u & 0xFFFF, u >> 16]).astype(np.int64)
    mag = halves & 0x7FFF
    return np.where(halves & 0x8000, -mag, mag)


def assert_words_close(got, want):
    """Packed words within one bf16 ulp of each other, half by half."""
    diff = np.abs(bf16_order(got.numpy()) - bf16_order(want))
    assert diff.max() <= 1, f"{int((diff > 1).sum())} halves off by > 1 ulp"


def scene_frame(tiny_scene):
    sc = tiny_scene
    pos, nrm, noisy, alb = (to_chw(sc[k][2]) for k in
                            ("positions", "normals", "noisy", "albedo"))
    # a large sub-pixel offset pushes the right and bottom edges off
    # screen, so the off-screen passthrough and the edge bits engage
    return (pos, nrm, noisy, alb, sc["camera_matrices"][1],
            np.array([-5.0, 3.0], np.float32))


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("frame", [0, 3])
@pytest.mark.parametrize("skips", list(SKIPS))
def test_tail_kernels_match_jax(tiny_cfg, tiny_scene, residual, frame,
                                skips):
    """H, G and F composed as ``denoise_frame`` composes them, with a
    packed state, against the JAX stages and their words."""
    jcfg = tiny_cfg.replace(residual_dtype=residual,
                            **SKIPS[skips]).validate()
    cfg = bt.config_from_jax(jcfg)
    rng = np.random.default_rng(frame + 11 * len(skips))
    pos, nrm, noisy, alb, cam, off = scene_frame(tiny_scene)
    planes = random_planes(rng)
    filtered = rng.random((3, H, W)).astype(np.float32) * 2.0
    T = torch.from_numpy
    history = "always" if frame else "never"

    want1 = jax_k1(jcfg, jnp.asarray(nrm), jnp.asarray(pos),
                   jnp.asarray(noisy), None, None, None, None,
                   jnp.asarray(cam), jnp.asarray(off), jnp.int32(frame),
                   taps=taps_dict(planes))
    want4 = jax_k4(jcfg, jnp.asarray(filtered), want1["prev_pixels"],
                   want1["accept"], jnp.asarray(alb), want1["spp"], None,
                   jnp.int32(frame), taps=taps_dict(planes))
    want5 = jax_taa(jcfg, want1["prev_pixels"], want4[1], None,
                    jnp.int32(frame), taps=taps_dict(planes))
    want_words = np.concatenate([
        jax_pack(jnp.asarray(np.concatenate([pos, nrm]))),
        jax_pack(jnp.concatenate([want1["accum"],
                                  want1["spp"].astype(jnp.float32)[None]])),
        jax_pack(jnp.concatenate([want4[0], want5]))])

    pack = torch.full((8, H, W), 0x5A5A5A5A, dtype=torch.int32)
    prev_pixels = reproject_coords(cfg, T(pos), T(cam), T(off), history)
    k1 = noisy_tail(cfg, T(noisy), prev_pixels, T(planes), T(pos), T(nrm),
                    frame, pack=pack)
    out, tone, result = filtered_tail(cfg, T(filtered), T(planes), T(alb),
                                      k1["spp"], k1["prev_pixels"], frame,
                                      pack=pack)

    if frame:
        assert (np.floor(prev_pixels[0].numpy()) >= W).any()
        assert (k1["spp"].numpy() == 255).any()     # saturated spp
    for k in ("spp", "accept"):
        np.testing.assert_array_equal(k1[k].numpy(), np.asarray(want1[k]))
    for got, want in ((k1["accum"], want1["accum"]),
                      (prev_pixels, want1["prev_pixels"]),
                      (k1["prev_pixels"], want1["prev_pixels"]),
                      (out, want4[0]), (tone, want4[1]), (result, want5)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=TOL,
                                   atol=TOL)
    assert_words_close(pack, np.asarray(want_words))


def test_reproject_matches_jax(tiny_cfg, tiny_scene):
    """H's map: JAX's (pfx, pfy) with history, each pixel's own
    coordinates without (frame 0)."""
    cfg = bt.config_from_jax(tiny_cfg)
    pos, _, _, _, cam, off = scene_frame(tiny_scene)
    T = torch.from_numpy
    want = np.stack([np.asarray(a) for a in jax_reproject(
        tiny_cfg, jnp.asarray(pos), jnp.asarray(cam), jnp.asarray(off))])
    got = reproject_coords(cfg, T(pos), T(cam), T(off))
    assert got.shape == (2, H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    pfx, pfy = got      # the (pfx, pfy) unpacking the callers use
    assert torch.equal(pfx, got[0]) and torch.equal(pfy, got[1])
    own = reproject_coords(cfg, T(pos), T(cam), T(off), "never").numpy()
    yy, xx = np.mgrid[:H, :W].astype(np.float32)
    np.testing.assert_array_equal(own, np.stack([xx, yy]))
    with pytest.raises(ValueError):
        reproject_coords_reference(cfg, T(pos), T(cam), T(off), "sometimes")


@pytest.mark.parametrize("carry", ["packed", "temporal"])
def test_tails_write_only_their_words(tiny_cfg, tiny_scene, carry):
    """G writes words 0:5, F words 5:8 and nothing else; without a pack
    (a TemporalState carry) neither writes a word, and the outputs are
    those of the packed run."""
    cfg = bt.config_from_jax(tiny_cfg.replace(residual_dtype="bfloat16"))
    rng = np.random.default_rng(5)
    pos, nrm, noisy, alb, cam, off = (torch.from_numpy(a) for a in
                                      scene_frame(tiny_scene))
    planes = torch.from_numpy(random_planes(rng))
    filtered = torch.from_numpy(rng.random((3, H, W)).astype(np.float32))
    sentinel = torch.full((8, H, W), 0x5A5A5A5A, dtype=torch.int32)
    pack = sentinel.clone() if carry == "packed" else None

    def run(pack):
        pp = reproject_coords(cfg, pos, cam, off)
        k1 = noisy_tail(cfg, noisy, pp, planes, pos, nrm, 3, pack=pack)
        words_after_g = None if pack is None else pack.clone()
        return k1, filtered_tail(cfg, filtered, planes, alb, k1["spp"],
                                 k1["prev_pixels"], 3, pack=pack), \
            words_after_g

    k1, outs, after_g = run(pack)
    if carry == "packed":
        assert not torch.equal(after_g[0:5], sentinel[0:5])
        assert torch.equal(after_g[5:8], sentinel[5:8])
        assert torch.equal(pack[0:5], after_g[0:5])
        assert not torch.equal(pack[5:8], sentinel[5:8])
    else:
        k1_packed, outs_packed, _ = run(sentinel.clone())
        for a, b in zip(outs, outs_packed):
            assert torch.equal(a, b)
        assert torch.equal(k1["accum"], k1_packed["accum"])


@pytest.mark.parametrize("W,offsets,want", [
    (1280, (0, 0, 0, 0), "tma"),        # 1280x720: every plane on 16 B
    (332, (0, 16, 512, 48), "tma"),     # a width whose tiles end partial
    (4, (0, 0, 0, 0), "tma"),
    (53, (0, 0, 0, 0), "threads"),      # a row of 212 B
    (6, (0, 0, 0, 0), "threads"),       # 24 B: a multiple of 4 and 8 only
    (1, (0, 0, 0, 0), "threads"),
    (1280, (4, 0, 0, 0), "threads"),    # filtered 4 B off 16
    (1280, (0, 8, 0, 0), "threads"),    # planes 8 B off
    (1280, (0, 0, 12, 0), "threads"),   # albedo 12 B off
    (1280, (0, 0, 0, 20), "threads"),   # prev_pixels 4 B off
])
def test_filtered_tail_loader(W, offsets, want):
    """Kernel F's ring is fed by TMA only where every plane TMA reads
    starts on 16 B: the rows (4 W bytes) and the four tensors' addresses
    (filtered, planes, albedo, prev_pixels) multiples of 16."""
    from bmfr_tpu_torch.ops.tail import VARIANTS, filtered_tail_loader

    base = 1 << 40
    assert filtered_tail_loader(W, [base + o for o in offsets]) == want
    assert set(VARIANTS) == {"tma", "threads"} and 0 not in VARIANTS.values()
