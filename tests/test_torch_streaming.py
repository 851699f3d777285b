"""The port's chunked streaming and checkpoint/resume on the CPU, on the
64x48x5 orbit scene at ``tiny_cfg`` (plain f32 taps, the plain fitter):

- ``stream_scene`` at 1, 2 and 5 frames a chunk equals the port's own
  ``denoise_sequence`` bit for bit, and meets the JAX package's
  ``stream_scene`` at the tolerance that holds the port's default path to
  JAX (``result`` rtol 2e-3 / atol 3e-3 and >= 80 dB a frame,
  tests/test_torch_exact_path.py);
- ``stream_scenes`` over two exported scene directories, each with its
  own discard limits;
- checkpoints cross between the two packages in both directions and
  resume to the uninterrupted run;
- the flagship carries a ``TemporalState`` (the streaming and checkpoint
  carry) to the same outputs as its ``PackedState``, bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu import checkpoint as jax_checkpoint
from bmfr_tpu.io.fixtures import synthetic_sequence
from bmfr_tpu.pipeline.denoise import FrameInputs as JaxFrameInputs
from bmfr_tpu.pipeline.denoise import denoise_frame as jax_denoise_frame
from bmfr_tpu.pipeline.state import TemporalState as JaxTemporalState
from bmfr_tpu.pipeline.streaming import stream_scene as jax_stream_scene
from bmfr_tpu_torch.io.dataset import discover_scenes
from bmfr_tpu_torch.io.export import export_scene
from bmfr_tpu_torch.metrics import psnr

from torch_threads import one_intra_op_thread  # noqa: F401

T = 5
RTOL, ATOL, MIN_DB = 2e-3, 3e-3, 80.0
KEYS = ("normals", "positions", "noisy", "albedo", "camera_matrices",
        "pixel_offsets")


def loader_of(sc):
    return lambda frames: {k: sc[k][frames] for k in KEYS}


def meets_jax(got, want):
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    dbs = [psnr(g, w) for g, w in zip(got, want)]
    assert min(dbs) >= MIN_DB, dbs


@pytest.fixture(scope="module")
def scene():
    return synthetic_sequence(width=64, height=48, frames=T, seed=2)


@pytest.fixture(scope="module")
def port_inputs(scene):
    return (bt.frame_inputs_from_numpy(*(scene[k] for k in KEYS[:4]), "cpu"),
            torch.from_numpy(scene["camera_matrices"]),
            torch.from_numpy(scene["pixel_offsets"]))


@pytest.fixture(scope="module")
def jax_ref(tiny_cfg, scene):
    """The JAX package's stream_scene over the scene."""
    return jax_stream_scene(tiny_cfg, loader=loader_of(scene), frame_count=T,
                            chunk_frames=2)


def sequence(cfg, port_inputs):
    return bt.denoise_sequence(cfg, *port_inputs).numpy()


@pytest.fixture(scope="module")
def port_ref(tiny_cfg, port_inputs):
    return sequence(bt.config_from_jax(tiny_cfg), port_inputs)


def flagship(tiny_cfg):
    return bt.config_from_jax(tiny_cfg).replace(**bt.FLAGSHIP)


@pytest.fixture(scope="module")
def flagship_ref(tiny_cfg, port_inputs):
    return sequence(flagship(tiny_cfg), port_inputs)


@pytest.mark.parametrize("chunk", [1, 2, 5])
def test_stream_scene_equals_sequence_and_meets_jax(tiny_cfg, scene, chunk,
                                                    port_ref, jax_ref):
    timings = {}
    got = bt.stream_scene(bt.config_from_jax(tiny_cfg),
                          loader=loader_of(scene), frame_count=T,
                          chunk_frames=chunk, device="cpu", timings=timings)
    assert got.dtype == np.float32 and got.shape == (T, 3, 48, 64)
    np.testing.assert_array_equal(got, port_ref)
    meets_jax(got, jax_ref)
    n_chunks = -(-T // chunk)
    assert [len(timings[k]) for k in ("ingest_s", "compute_ms")] == [
        n_chunks, n_chunks]


def test_flagship_stream_scene_equals_sequence(tiny_cfg, scene,
                                               flagship_ref):
    """The flagship streams on a TemporalState carry and equals its
    denoise_sequence on the packed carry, ragged last chunk included."""
    got = bt.stream_scene(flagship(tiny_cfg), loader=loader_of(scene),
                          frame_count=T, chunk_frames=2, device="cpu")
    np.testing.assert_array_equal(got, flagship_ref)


def test_stream_scenes_from_disk_per_scene_limits(tiny_cfg, scene, port_ref,
                                                  jax_ref, tmp_path):
    """Two exported scene directories of the same frames, the second
    with position_limit_squared 1e-8: the first equals the single run,
    the second must differ (its own limits were used)."""
    export_scene(scene, str(tmp_path / "a"))
    export_scene(scene, str(tmp_path / "b"), position_limit_squared=1e-8)
    scenes = discover_scenes(str(tmp_path))
    assert [s.frame_count for s in scenes] == [T, T]
    a, b = bt.stream_scenes(bt.config_from_jax(tiny_cfg), scenes,
                            chunk_frames=3, devices=["cpu"])
    np.testing.assert_array_equal(a, port_ref)
    meets_jax(a, jax_ref)
    assert np.abs(b - port_ref).max() > 1e-3


def test_stream_without_a_card_raises(tiny_cfg, scene):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.stream_scene(bt.config_from_jax(tiny_cfg),
                        loader=loader_of(scene), frame_count=T)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bt.stream_scenes(bt.config_from_jax(tiny_cfg), [])


def port_frames(cfg, state, port_inputs, frames):
    """The port's per-frame step over ``frames`` from ``state``: (state,
    the results)."""
    inputs, cams, offs = port_inputs
    results = []
    for t in frames:
        state, outs = bt.denoise_frame(
            cfg, state, bt.FrameInputs(*(x[t] for x in inputs)),
            cams[max(t - 1, 0)], offs[t], t)
        results.append(outs["result"].numpy())
    return state, np.stack(results)


@pytest.fixture(scope="module")
def jax_step(tiny_cfg):
    return jax.jit(lambda s, i, c, o, f: jax_denoise_frame(tiny_cfg, s, i, c,
                                                           o, f))


def jax_frames(step, state, scene, frames):
    results = []
    for t in frames:
        inputs = JaxFrameInputs(*(jnp.asarray(np.moveaxis(scene[k][t], -1, 0))
                                  for k in KEYS[:4]))
        cam = scene["camera_matrices"][max(t - 1, 0)]
        state, outs = step(state, inputs, jnp.asarray(cam),
                           jnp.asarray(scene["pixel_offsets"][t]),
                           jnp.int32(t))
        results.append(np.asarray(outs["result"]))
    return state, np.stack(results)


def test_jax_checkpoint_resumes_in_port(tiny_cfg, scene, port_inputs,
                                        jax_step, jax_ref, port_ref,
                                        tmp_path):
    state, _ = jax_frames(jax_step, JaxTemporalState.initial(tiny_cfg), scene,
                          range(3))
    path = str(tmp_path / "jax.npz")
    jax_checkpoint.save_state(path, state, 3)
    resumed, t0 = bt.load_state(path, device="cpu")
    assert t0 == 3 and resumed.spp.dtype == torch.uint8
    _, got = port_frames(bt.config_from_jax(tiny_cfg), resumed, port_inputs,
                         range(t0, T))
    meets_jax(got, jax_ref[3:])
    meets_jax(got, port_ref[3:])


def test_port_checkpoint_resumes_in_jax(tiny_cfg, scene, port_inputs,
                                        jax_step, jax_ref, tmp_path):
    cfg = bt.config_from_jax(tiny_cfg)
    state, _ = port_frames(cfg, bt.TemporalState.initial(cfg, "cpu"),
                           port_inputs, range(3))
    path = str(tmp_path / "port.npz")
    bt.save_state(path, state, 3)
    with np.load(path) as d:
        assert d["frame"].dtype == np.int64 and d["spp"].dtype == np.uint8
        assert sorted(d.files) == sorted(("frame",) + JaxTemporalState._fields)
    resumed, t0 = jax_checkpoint.load_state(path)
    assert t0 == 3
    _, got = jax_frames(jax_step, resumed, scene, range(t0, T))
    meets_jax(got, jax_ref[3:])


@pytest.mark.parametrize("variant", ["default", "flagship"])
def test_port_checkpoint_resumes_bit_equal(tiny_cfg, port_inputs, variant,
                                           tmp_path, request):
    """Frames 0-2, a checkpoint, and frames 3-4 resumed from it equal the
    uninterrupted ``denoise_sequence`` (the module's run of each
    configuration) bit for bit."""
    cfg = bt.config_from_jax(tiny_cfg)
    if variant == "flagship":
        cfg = flagship(tiny_cfg)
    state, head = port_frames(cfg, bt.TemporalState.initial(cfg, "cpu"),
                              port_inputs, range(3))
    path = str(tmp_path / "state.npz")
    bt.save_state(path, state, 3)
    resumed, t0 = bt.load_state(path, device="cpu")
    _, tail = port_frames(cfg, resumed, port_inputs, range(t0, T))
    want = request.getfixturevalue(
        {"default": "port_ref", "flagship": "flagship_ref"}[variant])
    np.testing.assert_array_equal(np.concatenate([head, tail]), want)
    with pytest.raises(TypeError, match="PackedState"):
        bt.save_state(path, bt.PackedState.initial(cfg, "cpu"), 0)


def test_flagship_temporal_state_carry_equals_packed(tiny_cfg,
                                                     port_inputs):
    """The fused warp on a TemporalState (packed at the read), the
    streaming and checkpoint carry, gives the packed carry's outputs bit
    for bit and hands a TemporalState on."""
    cfg = flagship(tiny_cfg)
    inputs, cams, offs = port_inputs
    packed = bt.PackedState.initial(cfg, "cpu")
    raw = bt.TemporalState.initial(cfg, "cpu")
    for t in range(3):
        frame = bt.FrameInputs(*(x[t] for x in inputs))
        args = (frame, cams[max(t - 1, 0)], offs[t], t)
        packed, want = bt.denoise_frame(cfg, packed, *args)
        raw, got = bt.denoise_frame(cfg, raw, *args)
        assert isinstance(raw, bt.TemporalState)
        assert isinstance(packed, bt.PackedState)
        for k, v in want.items():
            if isinstance(v, torch.Tensor):
                assert torch.equal(got[k], v), (t, k)
    with pytest.raises(ValueError, match="warp_mode='pallas'"):
        bt.denoise_frame(bt.config_from_jax(tiny_cfg), packed, *args)
