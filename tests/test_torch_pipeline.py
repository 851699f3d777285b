"""The whole PyTorch slice against the JAX package's flagship pipeline
(interpret-mode Pallas kernels on the CPU), on the 64x48x3 tiny scene.

The port differs from the JAX flagship only in summation order (the
fitter's Gram and colour sums), the same way the JAX pair "flagship vs
warp_mode='packed_x_bf16', fitter_impl='xla'" differs: that pair gives
85-105 dB per frame on this scene, max |err| <= 2.6e-3. The port is held
to >= 70 dB per frame (peak 1) on the final TAA output and max |err|
<= 1e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.config import BMFRConfig as JaxConfig
from bmfr_tpu.ops.warp_pallas import padded_src_shape
from bmfr_tpu.pipeline.denoise import (FrameInputs as JaxFrameInputs,
                                       PackedState as JaxPackedState,
                                       denoise_frame as jax_denoise_frame,
                                       denoise_sequence as jax_denoise_sequence)
from bmfr_tpu_torch.metrics import psnr

from torch_threads import one_intra_op_thread  # noqa: F401

MIN_DB = 70.0
MAX_ERR = 1e-2


def flagship_jax_cfg(tiny_cfg):
    return tiny_cfg.replace(warp_mode="pallas", fitter_impl="pallas_direct",
                            solver="cholesky",
                            residual_dtype="bfloat16").validate()


def jax_inputs(sc, t=None):
    def tc(a):
        a = a if t is None else a[t]
        return jnp.asarray(np.moveaxis(a, -1, -3))

    return JaxFrameInputs(tc(sc["normals"]), tc(sc["positions"]),
                          tc(sc["noisy"]), tc(sc["albedo"]))


def torch_inputs(sc):
    return bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                      sc["noisy"], sc["albedo"], "cpu")


@pytest.fixture(scope="module")
def jax_flagship(tiny_cfg, tiny_scene):
    """One interpret-mode run of the JAX flagship: ``denoise_sequence``'s
    results and tone-mapped frames, plus the state after frame 1 and
    frame 2's result from the per-frame step continued from that state."""
    cfg = flagship_jax_cfg(tiny_cfg)
    sc = tiny_scene
    cams = jnp.asarray(sc["camera_matrices"])
    offs = jnp.asarray(sc["pixel_offsets"])
    seq, tones = map(np.asarray, jax_denoise_sequence(
        cfg, jax_inputs(sc), cams, offs, lite_outputs=False))

    H, W = cfg.image_height, cfg.image_width
    state = JaxPackedState(jnp.zeros((8,) + padded_src_shape(H, W),
                                     jnp.int32))
    steps = {h: jax.jit(lambda s, i, c, o, f, h=h: jax_denoise_frame(
        cfg, s, i, c, o, f, history=h)) for h in ("never", "always")}
    states = []
    for t in range(3):
        state, outs = steps["never" if t == 0 else "always"](
            state, jax_inputs(sc, t), cams[max(t - 1, 0)], offs[t],
            jnp.int32(t))
        states.append(np.asarray(state.src8))
    return dict(cfg=cfg, seq=seq, tones=tones, state1=states[1],
                result2=np.asarray(outs["result"]))


def test_slice_matches_jax_flagship(jax_flagship, tiny_scene):
    cfg = bt.config_from_jax(jax_flagship["cfg"])
    sc = tiny_scene
    got, tones, stats = bt.denoise_sequence(
        cfg, torch_inputs(sc), torch.from_numpy(sc["camera_matrices"]),
        torch.from_numpy(sc["pixel_offsets"]), lite_outputs=False,
        return_stats=True)
    for name, g, want in (("result", got.numpy(), jax_flagship["seq"]),
                          ("tone", tones.numpy(), jax_flagship["tones"])):
        assert g.shape == want.shape
        assert np.isfinite(g).all()
        dbs = [psnr(g[t], want[t]) for t in range(len(want))]
        errs = [float(np.abs(g[t] - want[t]).max()) for t in range(len(want))]
        print(name, "per-frame PSNR dB", dbs, "max |err|", errs)
        assert min(dbs) >= MIN_DB, (name, dbs)
        assert max(errs) <= MAX_ERR, (name, errs)
    H, W = cfg.image_height, cfg.image_width
    np.testing.assert_array_equal(
        stats.numpy(), [[0] * 6] + [[0, 0, 0, 0, 0, H * W]] * 2)


def test_state_handover_from_jax(jax_flagship, tiny_scene):
    """JAX runs frames 0-1, hands its padded state to the port, and both
    continue for frame 2."""
    cfg = bt.config_from_jax(jax_flagship["cfg"])
    sc = tiny_scene
    state = bt.packed_state_from_jax(cfg, jax_flagship["state1"], "cpu")
    inputs = bt.frame_inputs_from_numpy(
        sc["normals"][2], sc["positions"][2], sc["noisy"][2], sc["albedo"][2],
        "cpu")
    _, got = bt.make_denoise_frame(cfg)(
        state, inputs, torch.from_numpy(sc["camera_matrices"][1]),
        torch.from_numpy(sc["pixel_offsets"][2]), 2)
    want = jax_flagship["result2"]
    db = psnr(got.numpy(), want)
    err = float(np.abs(got.numpy() - want).max())
    print("frame 2 after hand-over: PSNR dB", db, "max |err|", err)
    assert db >= MIN_DB and err <= MAX_ERR, (db, err)


def test_state_pack_matches_jax_carry(jax_flagship, tiny_scene):
    """The port's state after frames 0-1 is the JAX carry's image window,
    up to bf16 words whose f32 source differed by summation order."""
    cfg = bt.config_from_jax(jax_flagship["cfg"])
    sc = tiny_scene
    state = bt.PackedState.initial(cfg, "cpu")
    inputs = torch_inputs(sc)
    step = bt.make_denoise_frame(cfg)
    for t in range(2):
        state, _ = step(state, bt.FrameInputs(*(x[t] for x in inputs)),
                        torch.from_numpy(sc["camera_matrices"][max(t - 1, 0)]),
                        torch.from_numpy(sc["pixel_offsets"][t]), t)
    want = bt.packed_state_from_jax(cfg, jax_flagship["state1"], "cpu").src8
    # words 0:3 (positions, normals) are copies of the inputs: bit-equal
    np.testing.assert_array_equal(state.src8[0:3].numpy(),
                                  want[0:3].numpy())
    from bmfr_tpu_torch.ops.warp import unpack_pairs_bf16

    np.testing.assert_allclose(unpack_pairs_bf16(state.src8, 16).numpy(),
                               unpack_pairs_bf16(want, 16).numpy(),
                               rtol=2e-2, atol=2e-2)


def test_port_rejects_other_configs():
    """The one configuration the port still rejects, the TPU-only
    ``steady_only`` knob, raises NotImplementedError naming its ROADMAP
    item; the ones it rejected before (a custom basis on the direct
    fitters among them) run."""
    cfg = bt.BMFRConfig(image_width=64, image_height=48, **bt.FLAGSHIP)
    with pytest.raises(NotImplementedError, match="TPU-only.*ROADMAP"):
        bt.make_denoise_frame(cfg.replace(warp_tier_impl="steady_only"))
    # formerly rejected, and the tolerated variants
    for kw in (dict(features_scaled=("world_position_x",)),
               dict(solver="householder"), dict(warp_mode="packed_x_bf16"),
               dict(fitter_impl="xla"), dict(tmp_data_dtype="float16"),
               dict(fitter_impl="auto", block_edge=16),
               dict(fitter_impl="xla", features_scaled=("world_position_x",)),
               dict(residual_dtype="float32"), dict(skip_fitting=True),
               dict(skip_second_accum=True), dict(skip_taa=True)):
        bt.make_denoise_frame(cfg.replace(**kw))
    assert isinstance(bt.config_from_jax(JaxConfig()), bt.BMFRConfig)
