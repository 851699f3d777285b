"""Kernel A's plain version (``bmfr_tpu_torch.ops.warp_blend``) against
the JAX package's fused warp+blend (``warp_blend_pallas``, interpret
mode on the CPU), and its pieces against theirs. The tolerance is the
repo's own pin for the fused kernel (tests/test_warp_pallas.py:259-261):
rtol = atol = 1e-6 on on-screen pixels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.ops.gather import floor_int as jfloor
from bmfr_tpu.ops.warp_pallas import _mask_bits as jax_mask_bits
from bmfr_tpu.ops.warp_pallas import blend_from_taps as jax_blend_from_taps
from bmfr_tpu.ops.warp_pallas import warp_blend_pallas
from bmfr_tpu_torch.ops.gather import floor_int
from bmfr_tpu_torch.ops.warp import pack_pairs_bf16
from bmfr_tpu_torch.ops.warp_blend import (blend_from_taps, mask_bits,
                                           warp_blend)

from torch_threads import one_intra_op_thread  # noqa: F401

Ht, Wt = 48, 160


def field(kind):
    yy = np.arange(Ht)[:, None] + np.zeros((1, Wt))
    xx = np.arange(Wt)[None, :] + np.zeros((Ht, 1))
    if kind == "coherent":          # tests/test_warp_pallas.py:238-241
        pfy = yy + 2.3 + xx * 0.01
        pfx = xx - 1.7 + yy * 0.02
    else:                           # ix = -2, -1 and W-1, W; iy off screen
        pfy = yy * 1.05 + 1.3 - xx * 0.004
        pfx = xx * 1.015 - 1.6 + yy * 0.01
    return pfx.astype(np.float32), pfy.astype(np.float32)


@pytest.fixture(scope="module")
def jax_warp_blend(tiny_cfg):
    """The JAX kernel at 48x160, jitted once: its interpret-mode compile
    takes seconds, a call milliseconds, and both fields share it."""
    jcfg = tiny_cfg.replace(image_height=Ht, image_width=Wt).validate()
    return jcfg, jax.jit(lambda *a: warp_blend_pallas(jcfg, *a))


@pytest.mark.parametrize("kind", ["coherent", "edges"])
def test_plain_matches_jax_warp_blend(jax_warp_blend, kind):
    rng = np.random.default_rng(21)
    jcfg, jax_fn = jax_warp_blend
    stacked = rng.standard_normal((16, Ht, Wt)).astype(np.float32)
    cur6 = rng.standard_normal((6, Ht, Wt)).astype(np.float32)
    pfx, pfy = field(kind)
    want, _ = jax_fn(jnp.asarray(stacked), jnp.asarray(cur6),
                     jnp.asarray(pfx), jnp.asarray(pfy))

    cfg = bt.config_from_jax(jcfg)
    src8 = pack_pairs_bf16(torch.from_numpy(stacked))
    cur = torch.from_numpy(cur6)
    got = warp_blend(cfg, src8, cur[0:3], cur[3:6], torch.from_numpy(pfx),
                     torch.from_numpy(pfy)).numpy()
    ix, iy = np.floor(pfx), np.floor(pfy)
    if kind == "edges":
        assert {-2, -1, Wt - 1, Wt} <= set(ix.astype(int).ravel())
        assert (iy >= Ht).any()
    # fully off-screen pixels are don't-cares for the K5 planes
    on = ((ix >= -1) & (iy >= -1) & (ix < Wt) & (iy < Ht))[None]
    np.testing.assert_allclose(np.where(on, got, 0),
                               np.where(on, np.asarray(want), 0),
                               rtol=1e-6, atol=1e-6)
    # the accept plane is exact everywhere
    np.testing.assert_array_equal(got[5], np.asarray(want)[5])


def test_blend_from_taps_and_mask_bits_match_jax(tiny_cfg):
    rng = np.random.default_rng(4)
    shape = (24, 40)
    taps = [rng.standard_normal((16,) + shape).astype(np.float32) * 0.2
            for _ in range(4)]
    cur6 = rng.standard_normal((6,) + shape).astype(np.float32) * 0.2
    pfx = (rng.random(shape) * 44 - 2).astype(np.float32)
    pfy = (rng.random(shape) * 28 - 2).astype(np.float32)
    jix, jiy = jfloor(jnp.asarray(pfx)), jfloor(jnp.asarray(pfy))
    jbits = jax_mask_bits(jiy, jix, *shape)
    ix, iy = floor_int(torch.from_numpy(pfx)), floor_int(torch.from_numpy(pfy))
    bits = mask_bits(iy, ix, *shape)
    np.testing.assert_array_equal(bits.numpy(), np.asarray(jbits))

    fx = pfx - np.floor(pfx)
    fy = pfy - np.floor(pfy)
    want = jax_blend_from_taps(tiny_cfg, *map(jnp.asarray, taps),
                               jnp.asarray(cur6), jbits, jnp.asarray(fx),
                               jnp.asarray(fy))
    got = blend_from_taps(bt.config_from_jax(tiny_cfg),
                          *map(torch.from_numpy, taps),
                          torch.from_numpy(cur6), bits,
                          torch.from_numpy(fx), torch.from_numpy(fy))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(got[5].numpy(), np.asarray(want)[5])
