"""Scene-parallel denoising on the CPU (``bmfr_tpu_torch.parallel``) and
the ``__graft_entry__`` counterparts (``bmfr_tpu_torch.graft_entry``).

The port's ``denoise_scenes_sharded`` on a mesh of four CPU places is
held to the JAX package's ``shard_map`` run on four devices of
conftest's virtual CPU mesh at 1e-5 (``tests/test_sharding.py``'s bar),
and, bit for bit, to its own per-scene ``denoise_sequence``: the same
functions run on the same inputs in the same order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu import FrameInputs as JaxInputs
from bmfr_tpu.parallel import make_scene_mesh as jax_mesh
from bmfr_tpu.parallel.sharding import denoise_scenes_jit as jax_sharded_jit
from bmfr_tpu_torch import graft_entry

from torch_threads import one_intra_op_thread  # noqa: F401

CPU4 = ["cpu"] * 4


def scene_batch(S, T, H, W, seed=0):
    """``tests/test_sharding.py``'s scene batch as numpy: inputs, cameras,
    offsets."""
    r = np.random.RandomState(seed)
    inputs = [r.rand(S, T, 3, H, W).astype(np.float32) for _ in range(4)]
    cams = np.broadcast_to(np.eye(4, dtype=np.float32), (S, T, 4, 4)).copy()
    offs = np.full((S, T, 2), 0.5, np.float32)
    return inputs, cams, offs


def port_batch(batch):
    inputs, cams, offs = batch
    return (bt.FrameInputs(*(torch.from_numpy(x) for x in inputs)),
            torch.from_numpy(cams), torch.from_numpy(offs))


def per_scene(cfg, inputs, cams, offs):
    return torch.stack([
        bt.denoise_sequence(cfg, bt.FrameInputs(*(x[s] for x in inputs)),
                            cams[s], offs[s])
        for s in range(inputs.noisy.shape[0])])


def test_sharded_matches_jax_shard_map(tiny_cfg):
    """S = 4 scenes of 2 frames, 64x48, XLA fitter: the port on
    ``["cpu"] * 4`` against JAX's ``shard_map`` on four devices, jitted
    (``denoise_scenes_jit``: the eager ``shard_map`` takes ~100 s here)."""
    S, T = 4, 2
    batch = scene_batch(S, T, tiny_cfg.image_height, tiny_cfg.image_width)
    mesh = jax_mesh(jax.devices()[:4])
    inputs, cams, offs = batch
    with mesh:
        want = np.asarray(jax_sharded_jit(tiny_cfg, mesh)(
            JaxInputs(*(jnp.asarray(x) for x in inputs)),
            jnp.asarray(cams), jnp.asarray(offs)))
    cfg = bt.config_from_jax(tiny_cfg)
    got = bt.denoise_scenes_sharded(cfg, bt.make_scene_mesh(CPU4),
                                    *port_batch(batch))
    assert tuple(got.shape) == (S, T, 3, 64 - 16, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("path", ["flagship", "default"])
def test_sharded_equals_per_scene_bit_for_bit(path):
    """Four scenes over a mesh of two CPU places (two a place) equal
    their per-scene ``denoise_sequence`` bit for bit."""
    cfg = bt.BMFRConfig(image_width=64, image_height=48,
                        position_limit_squared=0.03, normal_limit_squared=0.5,
                        **(bt.FLAGSHIP if path == "flagship" else {}))
    inputs, cams, offs = port_batch(scene_batch(4, 3, 48, 64, seed=2))
    got = bt.denoise_scenes_sharded(cfg, bt.make_scene_mesh(["cpu"] * 2),
                                    inputs, cams, offs)
    want = per_scene(cfg, inputs, cams, offs)
    assert torch.equal(got, want)


def test_interleaved_scenes_keep_their_own_state():
    """Two scenes stepped together on one place (their frames
    interleaved), then again in the other order through the same runner:
    each scene equals its own ``denoise_sequence`` every time, so no
    scene's state reaches the other's frames."""
    cfg = bt.BMFRConfig(image_width=64, image_height=48, **bt.FLAGSHIP)
    inputs, cams, offs = port_batch(scene_batch(2, 3, 48, 64, seed=4))
    want = per_scene(cfg, inputs, cams, offs)
    assert not torch.equal(want[0], want[1])
    run = bt.denoise_scenes_jit(cfg, bt.make_scene_mesh(["cpu"]))
    assert torch.equal(run(inputs, cams, offs), want)
    swap = [1, 0]
    got = run(bt.FrameInputs(*(x[swap] for x in inputs)), cams[swap],
              offs[swap])
    assert torch.equal(got, want[swap])


def test_indivisible_scene_count_raises(tiny_cfg):
    cfg = bt.config_from_jax(tiny_cfg)
    inputs, cams, offs = port_batch(scene_batch(3, 1, 48, 64))
    with pytest.raises(ValueError, match="split evenly"):
        bt.denoise_scenes_sharded(cfg, bt.make_scene_mesh(["cpu"] * 2),
                                  inputs, cams, offs)
    with pytest.raises(ValueError, match="camera_matrices"):
        bt.denoise_scenes_sharded(cfg, bt.make_scene_mesh(["cpu"]), inputs,
                                  cams[:, :, :3], offs)


def test_scene_mesh_defaults_to_the_cards():
    """The default mesh is every visible card; without one it raises
    (there is no CPU fallback). Explicit places keep their order and
    repeats."""
    if torch.cuda.is_available():
        assert len(bt.make_scene_mesh()) == torch.cuda.device_count()
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            bt.make_scene_mesh()
    assert bt.make_scene_mesh(CPU4) == (torch.device("cpu"),) * 4
    with pytest.raises(ValueError):
        bt.make_scene_mesh([])


def test_dryrun_multichip_on_four_cpu_places():
    errs = graft_entry.dryrun_multichip(4, devices=CPU4)
    assert errs == [0.0, 0.0, 0.0]
    with pytest.raises(ValueError):
        graft_entry.dryrun_multichip(4, devices=["cpu"] * 2)


def test_entry_on_the_cpu():
    """``entry``'s example step at 1280x720 (the flagship datapath with
    the Householder solver) returns the next state and the result."""
    fn, args = graft_entry.entry(device="cpu")
    state, inputs, prev_cam, pixel_offset, frame = args
    cfg = graft_entry.entry_config()
    assert (cfg.solver, cfg.warp_mode, cfg.fitter_impl) == (
        "householder", "pallas", "pallas_direct")
    assert isinstance(state, bt.TemporalState)
    assert (frame.dtype, int(frame)) == (torch.int32, 1)
    # the JAX entry's first draw
    want0 = np.random.RandomState(0).rand(3).astype(np.float32)
    np.testing.assert_array_equal(inputs.normals.flatten()[:3].numpy(),
                                  want0)
    new_state, result = fn(*args)
    assert tuple(result.shape) == (3, 720, 1280)
    assert tuple(new_state.noisy.shape) == (3, 720, 1280)
    assert bool(torch.isfinite(result).all())
