"""The direct fitters' plain versions against the JAX package's
interpret-mode kernels on the CPU: kernel C's (``fit_blocks_direct``,
``fit_reconstruct_direct``) and, under reduced-precision tmp storage,
kernel B's (``fit_reconstruct_cholesky``).

Tolerances are the JAX tests' own: mins/maxs 1e-6, weights 2e-3 (f32)
and 5e-3 (f16/bf16) (tests/test_fitter_direct.py:37-53); the
reconstructions 5e-3, the pin of the fused kernels against the block
path (tests/test_fitter_direct.py:146), which is what the port's plain
versions are.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.ops.blockify import blockify_view, jitter_offset
from bmfr_tpu.ops.fitter_direct import fit_blocks_direct as jax_fbd
from bmfr_tpu.ops.fitter_direct import fit_reconstruct_cholesky as jax_frc
from bmfr_tpu.ops.fitter_direct import fit_reconstruct_direct as jax_frd
from bmfr_tpu_torch.ops import fitter_direct
from conftest import to_chw
from torch_threads import one_intra_op_thread  # noqa: F401


def tol(dtype):
    return 2e-3 if dtype == "float32" else 5e-3


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
    """One of the JAX direct kernels (interpret mode) on the sliced view
    of frame ``f`` (traced: the frames of one config share a compile),
    reconstructions sliced back to the image as the pipeline does."""
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


@pytest.mark.parametrize("dtype,frames", [("float32", (0, 7)),
                                          ("bfloat16", (1,))])
def test_fit_blocks_direct_plain_matches_jax(tiny_cfg, planes, dtype,
                                             frames):
    jcfg = tiny_cfg.replace(tmp_data_dtype=dtype).validate()
    cfg = bt.config_from_jax(jcfg)
    for frame in frames:
        w_j, mm_j = _jax_direct(jcfg, "fit_blocks_direct",
                                jnp.asarray(planes), jnp.int32(frame))
        w, mm = fitter_direct.fit_blocks_direct(cfg, *port_planes(planes),
                                                frame)
        np.testing.assert_allclose(mm.numpy(), np.asarray(mm_j), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(w.numpy(), np.asarray(w_j),
                                   rtol=tol(dtype), atol=tol(dtype))


@pytest.mark.parametrize("which,dtype,frames", [
    ("fit_reconstruct_direct", "float32", (0, 5, 13)),
    ("fit_reconstruct_direct", "float16", (1,)),
    ("fit_reconstruct_cholesky", "float16", (0, 5)),
    ("fit_reconstruct_cholesky", "bfloat16", (1,)),
])
def test_fit_reconstruct_plain_matches_jax(tiny_cfg, planes, which, dtype,
                                           frames):
    jcfg = tiny_cfg.replace(tmp_data_dtype=dtype).validate()
    cfg = bt.config_from_jax(jcfg)
    fit = getattr(fitter_direct, which)
    for frame in frames:
        want = np.asarray(_jax_direct(jcfg, which, jnp.asarray(planes),
                                      jnp.int32(frame)))
        got, w = fit(cfg, *port_planes(planes), frame)
        assert w.shape == (jcfg.n_blocks, 10, 3)
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3, atol=5e-3)


