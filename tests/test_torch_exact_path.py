"""The port's reference-exact paths against the JAX package's on the
64x48x3 tiny scene:

- the default ``BMFRConfig()`` path (f32 gather taps, raw-plane
  ``TemporalState``, blockified Householder fit, block reconstruction),
  which the NumPy oracle pins at 115-117 dB: the TAA result at >= 80 dB
  per frame, and every stage output at tests/test_pipeline_vs_oracle.py's
  tolerances;
- the ``TemporalState`` hand-over from JAX after frame 1;
- two more configurations of the non-fused warp and the block fitter;
- the flagship with ``solver="householder"`` (kernel A's and kernel C's
  plain versions) against the interpret-mode JAX path, >= 70 dB per
  frame, as tests/test_torch_pipeline.py holds the Cholesky flagship.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.pipeline.denoise import FrameInputs as JaxFrameInputs
from bmfr_tpu.pipeline.denoise import denoise_frame as jax_denoise_frame
from bmfr_tpu.pipeline.denoise import denoise_sequence as jax_denoise_sequence
from bmfr_tpu.pipeline.state import TemporalState as JaxTemporalState
from bmfr_tpu_torch.metrics import psnr

from torch_threads import one_intra_op_thread  # noqa: F401

EXACT_DB = 80.0
FLAGSHIP_DB = 70.0
#: the stage tolerances of tests/test_pipeline_vs_oracle.py, (rtol, atol)
STAGE_TOL = dict(accum=(1e-4, 1e-5), prev_pixels=(1e-4, 2e-3),
                 mins_maxs=(1e-5, 1e-5), weights=(5e-3, 5e-3),
                 filtered=(1e-3, 2e-3), out=(1e-3, 2e-3),
                 tone=(1e-3, 2e-3), result=(2e-3, 3e-3))


def jax_frame(sc, t):
    def tc(a):
        return jnp.asarray(np.moveaxis(a[t], -1, -3))

    return JaxFrameInputs(tc(sc["normals"]), tc(sc["positions"]),
                          tc(sc["noisy"]), tc(sc["albedo"]))


def torch_inputs(sc):
    return bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                      sc["noisy"], sc["albedo"], "cpu")


def run_jax_frames(cfg, sc):
    """JAX's jitted per-frame step over the scene from the zero
    ``TemporalState``: every frame's outputs, and the state after frame 1."""
    step = jax.jit(lambda s, i, c, o, f: jax_denoise_frame(cfg, s, i, c, o,
                                                           f))
    state = JaxTemporalState.initial(cfg)
    frames, state1 = [], None
    for t in range(sc["noisy"].shape[0]):
        state, outs = step(state, jax_frame(sc, t),
                           jnp.asarray(sc["camera_matrices"][max(t - 1, 0)]),
                           jnp.asarray(sc["pixel_offsets"][t]), jnp.int32(t))
        frames.append({k: np.asarray(v) for k, v in outs.items()
                       if v is not None})
        if t == 1:
            state1 = jax.tree.map(np.asarray, state)
    return frames, state1


def run_port_frames(cfg, sc, state=None, start=0):
    inputs = torch_inputs(sc)
    state = bt.zero_state(cfg, "cpu") if state is None else state
    frames = []
    for t in range(start, sc["noisy"].shape[0]):
        state, outs = bt.denoise_frame(
            cfg, state, bt.FrameInputs(*(x[t] for x in inputs)),
            torch.from_numpy(sc["camera_matrices"][max(t - 1, 0)]),
            torch.from_numpy(sc["pixel_offsets"][t]), t)
        frames.append({k: v.numpy() for k, v in outs.items()
                       if v is not None})
    return frames


@pytest.fixture(scope="module")
def jax_default(tiny_cfg, tiny_scene):
    cfg = tiny_cfg.replace(fitter_impl="auto").validate()
    frames, state1 = run_jax_frames(cfg, tiny_scene)
    return cfg, frames, state1


def test_default_config_is_the_exact_path():
    cfg = bt.BMFRConfig()
    assert (cfg.solver, cfg.fitter_impl, cfg.warp_mode,
            cfg.tmp_data_dtype) == ("householder", "auto", "float32",
                                    "float32")


def test_default_path_sequence_matches_jax(jax_default, tiny_scene):
    jcfg, frames, _ = jax_default
    cfg = bt.config_from_jax(jcfg)
    sc = tiny_scene
    got = bt.denoise_sequence(cfg, torch_inputs(sc),
                              torch.from_numpy(sc["camera_matrices"]),
                              torch.from_numpy(sc["pixel_offsets"])).numpy()
    dbs = [psnr(got[t], f["result"]) for t, f in enumerate(frames)]
    print("default path vs JAX, per-frame PSNR dB", dbs)
    assert np.isfinite(got).all()
    assert min(dbs) >= EXACT_DB, dbs


@pytest.fixture(scope="module")
def port_default(jax_default, tiny_scene):
    """The port's per-frame step over the scene at ``jax_default``'s
    configuration: every frame's outputs."""
    return run_port_frames(bt.config_from_jax(jax_default[0]), tiny_scene)


@pytest.mark.parametrize("t", [0, 1, 2])
def test_default_path_stages_match_jax(jax_default, port_default, t):
    got = port_default[t]
    want = jax_default[1][t]
    # accept bits: allow rare FMA-borderline flips, as against the oracle
    ok = got["accept"] == want["accept"]
    assert ok.mean() > 0.995, ok.mean()
    np.testing.assert_array_equal(got["spp"][ok], want["spp"][ok])
    for k, (rtol, atol) in STAGE_TOL.items():
        g, w = got[k], want[k]
        assert g.shape == w.shape, k
        if g.shape[-2:] == ok.shape:
            g, w = g[..., ok], w[..., ok]
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol, err_msg=k)


def test_temporal_state_handover_from_jax(jax_default, tiny_scene):
    """JAX runs frames 0-1 and hands its TemporalState to the port, which
    runs frame 2."""
    jcfg, frames, state1 = jax_default
    cfg = bt.config_from_jax(jcfg)
    state = bt.temporal_state_from_jax(state1, "cpu")
    assert state.spp.dtype == torch.uint8 and state.noisy.shape == (3, 48, 64)
    got = run_port_frames(cfg, tiny_scene, state=state, start=2)[0]
    db = psnr(got["result"], frames[2]["result"])
    print("frame 2 after the hand-over: PSNR dB", db)
    assert db >= EXACT_DB, db


@pytest.mark.parametrize("variant", [
    dict(warp_mode="packed_x_bf16", fitter_impl="xla",
         tmp_data_dtype="float16"),
    dict(warp_mode="packed_bf16", solver="cholesky", block_edge=16),
])
def test_other_exact_variants_match_jax(tiny_cfg, tiny_scene, variant):
    jcfg = tiny_cfg.replace(**variant).validate()
    sc = tiny_scene
    want = np.asarray(jax.jit(lambda *a: jax_denoise_sequence(jcfg, *a))(
        JaxFrameInputs(*(jnp.asarray(np.moveaxis(sc[k], -1, -3)) for k in
                         ("normals", "positions", "noisy", "albedo"))),
        jnp.asarray(sc["camera_matrices"]), jnp.asarray(sc["pixel_offsets"])))
    got = bt.denoise_sequence(bt.config_from_jax(jcfg), torch_inputs(sc),
                              torch.from_numpy(sc["camera_matrices"]),
                              torch.from_numpy(sc["pixel_offsets"])).numpy()
    dbs = [psnr(got[t], want[t]) for t in range(len(want))]
    print(variant, "per-frame PSNR dB", dbs)
    assert min(dbs) >= EXACT_DB, dbs


def test_householder_flagship_matches_jax(tiny_cfg, tiny_scene):
    jcfg = tiny_cfg.replace(warp_mode="pallas", fitter_impl="pallas_direct",
                            solver="householder",
                            residual_dtype="bfloat16").validate()
    sc = tiny_scene
    want = np.asarray(jax.jit(lambda *a: jax_denoise_sequence(jcfg, *a))(
        JaxFrameInputs(*(jnp.asarray(np.moveaxis(sc[k], -1, -3)) for k in
                         ("normals", "positions", "noisy", "albedo"))),
        jnp.asarray(sc["camera_matrices"]), jnp.asarray(sc["pixel_offsets"])))
    got = bt.denoise_sequence(bt.config_from_jax(jcfg), torch_inputs(sc),
                              torch.from_numpy(sc["camera_matrices"]),
                              torch.from_numpy(sc["pixel_offsets"])).numpy()
    dbs = [psnr(got[t], want[t]) for t in range(len(want))]
    errs = [float(np.abs(got[t] - want[t]).max()) for t in range(len(want))]
    print("householder flagship vs JAX: PSNR dB", dbs, "max |err|", errs)
    assert np.isfinite(got).all()
    assert min(dbs) >= FLAGSHIP_DB, dbs
