"""The port's copies of the framework-neutral pieces, pinned to the JAX
package's originals: hash noise, bf16 channel-pair pack, jitter table and
mirror addressing, the synthetic fixture, the config, the small stage
helpers; and the import boundary (the port never loads JAX)."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu import geometry as jgeo
from bmfr_tpu import color as jcolor
from bmfr_tpu import features as jfeat
from bmfr_tpu import metrics as jmetrics
from bmfr_tpu import rng as jrng
from bmfr_tpu.config import BMFRConfig as JaxConfig
from bmfr_tpu.io.fixtures import synthetic_sequence as jax_synthetic
from bmfr_tpu.ops import warp as jwarp
from bmfr_tpu_torch import color, features, geometry, metrics, rng
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.ops import blockify, warp

from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("frame", [0, 1, 15, 1000, 400000])
def test_feature_noise_bit_exact(frame):
    want = np.asarray(jrng.feature_noise(frame, 10, 1024, 13, 1e-2))
    got = rng.feature_noise(frame, 10, 1024, 13, 1e-2).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_hash_uniform_bit_exact():
    a = np.random.default_rng(0).integers(0, 2**32, 4096, dtype=np.uint64)
    want = np.asarray(jrng.hash_uniform(jnp.asarray(a.astype(np.uint32))))
    got = rng.hash_uniform(torch.from_numpy(a.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("C", [16, 6, 3])
def test_pack_pairs_bf16_bit_exact(C):
    r = np.random.default_rng(C)
    planes = (r.standard_normal((C, 7, 9)) * 10.0 ** r.integers(
        -3, 4, (C, 7, 9))).astype(np.float32)
    want = np.array(jwarp.pack_pairs_bf16(jnp.asarray(planes)))
    got = warp.pack_pairs_bf16(torch.from_numpy(planes)).numpy()
    np.testing.assert_array_equal(got, want)
    # list-of-planes input into a preallocated buffer (the state pack)
    out = torch.full(want.shape, 7, dtype=torch.int32)
    warp.pack_pairs_bf16(list(torch.from_numpy(planes)), out=out)
    np.testing.assert_array_equal(out.numpy(), want)
    np.testing.assert_array_equal(
        warp.unpack_pairs_bf16(torch.from_numpy(want), C).numpy(),
        np.asarray(jwarp.unpack_pairs_bf16(jnp.asarray(want), C)))


def test_block_offsets_and_mirror():
    np.testing.assert_array_equal(geometry.BLOCK_OFFSETS,
                                  jgeo.BLOCK_OFFSETS)
    for f in range(40):
        assert blockify.jitter_offset(f) == tuple(jgeo.frame_offset(f))
    idx = np.arange(-40, 60)
    for size in (1, 5, 17, 48):
        sym = np.pad(np.arange(size), 60, mode="symmetric")[idx + 60]
        got = blockify.mirror_index(torch.from_numpy(idx), size).numpy()
        np.testing.assert_array_equal(got, sym)
        one = (idx >= -size) & (idx < 2 * size)
        np.testing.assert_array_equal(got[one], jgeo.mirror(idx[one], size))
        np.testing.assert_array_equal(geometry.mirror(idx[one], size),
                                      jgeo.mirror(idx[one], size))


def test_jittered_view_matches_blockify_view(tiny_cfg):
    from bmfr_tpu.ops.blockify import blockify_view

    planes = np.random.default_rng(3).standard_normal(
        (2, 48, 64)).astype(np.float32)
    for frame in (0, 5, 13):
        want = np.asarray(blockify_view(tiny_cfg, jnp.asarray(planes),
                                        jnp.int32(frame)))
        got = blockify.jittered_view(bt.config_from_jax(tiny_cfg),
                                     torch.from_numpy(planes), frame)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("aa_samples", [1, 2])
@pytest.mark.parametrize("scene", ["orbit", "corridor", "swing"])
def test_synthetic_sequence_byte_equal(scene, aa_samples):
    kw = dict(width=40, height=24, frames=3, seed=7, aa_samples=aa_samples,
              scene=scene)
    want, got = jax_synthetic(**kw), synthetic_sequence(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_config_from_jax_field_equal():
    jcfg = JaxConfig(image_width=320, image_height=200, solver="cholesky",
                     residual_dtype="bfloat16", noise_amount=0.02,
                     skip_taa=True)
    cfg = bt.config_from_jax(jcfg)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert ([f.name for f in dataclasses.fields(bt.BMFRConfig)]
            == [f.name for f in dataclasses.fields(JaxConfig)])
    for prop in ("blocks_x", "blocks_y", "n_blocks", "feature_count",
                 "buffer_count", "workset_with_margins_width",
                 "workset_with_margins_height", "all_features"):
        assert getattr(cfg, prop) == getattr(jcfg, prop), prop
    assert dataclasses.asdict(bt.BMFRConfig()) == dataclasses.asdict(
        JaxConfig())


def test_features_color_psnr():
    r = np.random.default_rng(9)
    n, p, rgb = (r.standard_normal((3, 5, 6)).astype(np.float32)
                 for _ in range(3))
    for name in jfeat.FEATURE_REGISTRY:
        want = np.asarray(jfeat.FEATURE_REGISTRY[name](jnp.asarray(n),
                                                       jnp.asarray(p)))
        got = features.FEATURE_REGISTRY[name](torch.from_numpy(n),
                                              torch.from_numpy(p))
        np.testing.assert_array_equal(got.numpy(), want)
    ycc = color.rgb_to_ycocg(torch.from_numpy(rgb))
    np.testing.assert_array_equal(
        ycc.numpy(), np.asarray(jcolor.rgb_to_ycocg(jnp.asarray(rgb))))
    np.testing.assert_array_equal(
        color.ycocg_to_rgb(ycc).numpy(),
        np.asarray(jcolor.ycocg_to_rgb(jnp.asarray(ycc.numpy()))))
    assert metrics.psnr(rgb, rgb * 0.99) == jmetrics.psnr(rgb, rgb * 0.99)


def test_port_imports_neither_jax_nor_reference():
    """Every module of the port, and chip_smoke.py, import in a fresh
    interpreter without loading jax or bmfr_tpu."""
    code = (
        "import importlib, pkgutil, runpy, sys\n"
        "import bmfr_tpu_torch\n"
        "for m in pkgutil.walk_packages(bmfr_tpu_torch.__path__, "
        "'bmfr_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "runpy.run_path('chip_smoke.py', run_name='chip_smoke')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'bmfr_tpu')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_port_scripts_import_neither_jax_nor_reference():
    """The port's scripts (``scripts/torch_*.py``, run on the card's host,
    which has no jax), child code in their strings included, import
    neither jax nor bmfr_tpu."""
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|bmfr_tpu)\b",
                         re.M)
    scripts = sorted((REPO / "scripts").glob("torch_*.py"))
    assert len(scripts) >= 2
    for path in scripts:
        assert not pattern.search(path.read_text()), path.name


def test_wrappers_take_the_plain_version_only_on_cpu(tiny_cfg):
    """A CPU tensor runs the plain version and counts no launch; any
    other non-CUDA device raises (no silent fallback)."""
    from bmfr_tpu_torch.ops.fitter_direct import fit_reconstruct_cholesky
    from bmfr_tpu_torch.ops.warp_blend import warp_blend

    cfg = bt.config_from_jax(tiny_cfg)
    H, W = 48, 64
    a0, b0 = warp_blend.launches, fit_reconstruct_cholesky.launches
    src8 = torch.zeros((8, H, W), dtype=torch.int32)
    p3 = torch.zeros((3, H, W))
    pf = torch.zeros((H, W))
    assert warp_blend(cfg, src8, p3, p3, pf, pf).shape == (13, H, W)
    out, w = fit_reconstruct_cholesky(cfg, p3, p3, p3 + 1, 0)
    assert out.shape == (3, H, W) and w.shape == (cfg.n_blocks, 10, 3)
    assert (warp_blend.launches, fit_reconstruct_cholesky.launches) == (
        a0, b0)
    meta = [t.to("meta") for t in (src8, p3, pf)]
    with pytest.raises(ValueError, match="unsupported device"):
        warp_blend(cfg, meta[0], meta[1], meta[1], meta[2], meta[2])
    with pytest.raises(ValueError, match="unsupported device"):
        fit_reconstruct_cholesky(cfg, meta[1], meta[1], meta[1], 0)
