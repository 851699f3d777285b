"""The frame number as the compiled step reads it, on the CPU at 64x48:

- ``denoise_frame`` with ``frame`` a 0-d int32 tensor (and ``history``)
  equals the host int bit for bit on the default path and on both
  flagships' plain versions, also at a jitter phase past the table's
  period;
- the jitter's gathers (``blockify_planes``, ``unblockify_planes``,
  ``weighted_sum_image``) equal their host-int results at all 16 phases;
- the formula the fitter kernels evaluate on the card (the jitter table in
  ``csrc/fitter_front.cuh`` and its scaling, the noise's frame term),
  replayed in numpy, equals ``jitter_offset`` and ``rng.noise_params``;
- ``make_denoise_frame`` equals ``denoise_sequence``, and
  ``donate=False`` leaves the caller's state intact;
- the stage ranges carry the JAX package's scope names, and
  ``profile_stages`` prints every stage.

The compiled step itself (a CUDA graph) runs only on a card:
tests/test_torch_gpu.py.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.xplane import STAGE_SCOPES
from bmfr_tpu_torch import profile_stages, rng
from bmfr_tpu_torch.geometry import BLOCK_OFFSETS
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.ops.blockify import (blockify_planes, jitter_offset,
                                         unblockify_planes)
from bmfr_tpu_torch.ops.frame import frame_tensor, has_history
from bmfr_tpu_torch.ops.weighted_sum import weighted_sum_image
from bmfr_tpu_torch.profiling import STAGES

from torch_threads import one_intra_op_thread  # noqa: F401

H, W = 48, 64
FRONT = Path(bt.__file__).parent / "csrc" / "fitter_front.cuh"
PATHS = {"default": {}, "flagship": bt.FLAGSHIP,
         "householder_flagship": dict(bt.FLAGSHIP, solver="householder")}


def cfg_of(path, **kw):
    return bt.BMFRConfig(image_width=W, image_height=H,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5, **PATHS[path], **kw)


def i32(frame):
    return torch.tensor(frame, dtype=torch.int32)


@pytest.fixture(scope="module")
def scene():
    sc = synthetic_sequence(width=W, height=H, frames=3, seed=0)
    return (bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                       sc["noisy"], sc["albedo"], "cpu"),
            torch.from_numpy(sc["camera_matrices"]),
            torch.from_numpy(sc["pixel_offsets"]))


def frame_in(inputs, t):
    return bt.FrameInputs(*(x[t] for x in inputs))


def copy_state(state):
    return type(state)(*(t.clone() for t in state))


@pytest.fixture(scope="module")
def after_frame0(scene):
    """Each path's state after frame 0."""
    inputs, cams, offs = scene
    out = {}
    for path in PATHS:
        cfg = cfg_of(path)
        out[path] = bt.denoise_frame(cfg, bt.zero_state(cfg, "cpu"),
                                     frame_in(inputs, 0), cams[0], offs[0],
                                     0)[0]
    return out


@pytest.mark.parametrize("frame", [1, 5, 17])
@pytest.mark.parametrize("path", list(PATHS))
def test_tensor_frame_equals_host_int(scene, after_frame0, path, frame):
    inputs, cams, offs = scene
    cfg = cfg_of(path)
    args = (frame_in(inputs, 1), cams[0], offs[1])
    s_int, o_int = bt.denoise_frame(cfg, copy_state(after_frame0[path]),
                                    *args, frame)
    s_dev, o_dev = bt.denoise_frame(cfg, copy_state(after_frame0[path]),
                                    *args, i32(frame), history="always")
    for key in ("result", "tone", "out", "filtered", "accum", "spp",
                "weights", "mins_maxs"):
        if o_int[key] is not None:
            assert torch.equal(o_int[key], o_dev[key]), key
    for a, b in zip(s_int, s_dev):
        assert torch.equal(a, b)


def test_first_frame_as_a_tensor_with_history_never(scene):
    inputs, cams, offs = scene
    cfg = cfg_of("default")
    want = bt.denoise_frame(cfg, bt.zero_state(cfg, "cpu"),
                            frame_in(inputs, 0), cams[0], offs[0], 0)[1]
    got = bt.denoise_frame(cfg, bt.zero_state(cfg, "cpu"),
                           frame_in(inputs, 0), cams[0], offs[0], i32(0),
                           history="never")[1]
    assert torch.equal(want["result"], got["result"])


def test_history_is_a_host_decision():
    assert has_history(3) and not has_history(0)
    assert has_history(i32(0), "always") and not has_history(5, "never")
    with pytest.raises(ValueError, match="history"):
        has_history(i32(3))
    with pytest.raises(ValueError, match="history"):
        has_history(3, "dynamic")


def test_frame_tensor():
    assert frame_tensor(7, "cpu").dtype == torch.int32
    assert int(frame_tensor(7, "cpu")) == 7
    t = i32(9)
    assert frame_tensor(t, t.device) is t
    for bad in (torch.tensor(9), torch.tensor([9], dtype=torch.int32)):
        with pytest.raises(ValueError, match="0-d int32"):
            frame_tensor(bad, "cpu")


@pytest.mark.parametrize("block_edge", [16, 32, 64])
def test_jitter_gathers_take_a_tensor_frame(block_edge):
    cfg = cfg_of("default", block_edge=block_edge)
    g = torch.Generator().manual_seed(block_edge)
    planes = torch.randn((5, H, W), generator=g)
    blocks = torch.randn((cfg.n_blocks, 5, cfg.block_pixels), generator=g)
    F, n_sc = cfg.feature_count, cfg.features_scaled_count
    weights = torch.randn((cfg.n_blocks, F, 3), generator=g)
    mm = torch.rand((cfg.n_blocks, n_sc, 2), generator=g)
    mm[..., 1] += mm[..., 0] + 0.5
    normals, positions = torch.randn((2, 3, H, W), generator=g)
    for f in range(16):
        assert torch.equal(blockify_planes(cfg, planes, f),
                           blockify_planes(cfg, planes, i32(f)))
        assert torch.equal(unblockify_planes(cfg, blocks, f),
                           unblockify_planes(cfg, blocks, i32(f)))
        assert torch.equal(
            weighted_sum_image(cfg, weights, mm, normals, positions,
                               planes[:3], f),
            weighted_sum_image(cfg, weights, mm, normals, positions,
                               planes[:3], i32(f)))


def kernel_table():
    """``kBlockOffsets`` as the kernels hold it (csrc/fitter_front.cuh)."""
    text = FRONT.read_text()
    body = re.search(r"kBlockOffsets\[16\]\[2\]\s*=\s*\{(.*?)\};", text,
                     re.S).group(1)
    return np.array([int(v) for v in re.findall(r"-?\d+", body)],
                     np.int64).reshape(16, 2)


def kernel_jitter(frames, be):
    """``jitter_offset`` of fitter_front.cuh: the table row ``frame & 15``
    times ``be``, arithmetic-shifted right by 5."""
    t = kernel_table()[np.asarray(frames, np.int64) & 15]
    return (t * be) >> 5


def kernel_noise_base(frames, bp, buffers):
    """``frame_noise`` of fitter_front.cuh: ``(uint32) frame * (uint32)
    (buffers * bp)``, wrapping mod 2**32."""
    f = np.asarray(frames, np.int64).astype(np.uint32)
    with np.errstate(over="ignore"):
        return f * np.uint32(buffers * bp)


LAST = 2**20 + 17


def test_kernel_jitter_table_is_the_reference_table():
    np.testing.assert_array_equal(kernel_table(), BLOCK_OFFSETS)


@pytest.mark.parametrize("block_edge", [8, 16, 32, 48, 64])
def test_kernel_jitter_formula_matches_jitter_offset(block_edge):
    frames = np.r_[0:4096, LAST - 4096:LAST + 1]
    want = np.array([jitter_offset(int(f), block_edge) for f in frames])
    np.testing.assert_array_equal(kernel_jitter(frames, block_edge), want)
    for f in (0, 5, 17, LAST):
        ox, oy = jitter_offset(i32(f), block_edge)
        assert (int(ox), int(oy)) == tuple(want[frames == f][0])


@pytest.mark.parametrize("block_edge,buffers", [(32, 13), (16, 13),
                                                (64, 16), (8, 7)])
def test_kernel_noise_base_matches_noise_params(block_edge, buffers):
    """Every frame to LAST through the tensor form of noise_params, and
    a sample of them (every 97th, and the last 4096) through the host
    int form."""
    bp = block_edge * block_edge
    frames = np.arange(LAST + 1)
    got = kernel_noise_base(frames, bp, buffers)
    every = rng.noise_params(torch.from_numpy(frames), bp, buffers, 0.01)[0]
    np.testing.assert_array_equal(got, every.numpy().astype(np.uint32))
    sample = np.r_[0:LAST:97, LAST - 4096:LAST + 1]
    want = np.array([rng.noise_params(int(f), bp, buffers, 0.01)[0]
                     for f in sample], np.uint32)
    np.testing.assert_array_equal(got[sample], want)


@pytest.mark.parametrize("path", ["default", "flagship"])
def test_make_denoise_frame_equals_denoise_sequence(scene, path):
    inputs, cams, offs = scene
    inputs = bt.FrameInputs(*(x[:2] for x in inputs))
    cfg = cfg_of(path)
    want = bt.denoise_sequence(cfg, inputs, cams, offs)
    step = bt.make_denoise_frame(cfg)
    state, got = bt.zero_state(cfg, "cpu"), []
    for t in range(want.shape[0]):
        state, res = step(state, frame_in(inputs, t), cams[max(t - 1, 0)],
                          offs[t], t)
        got.append(res)
    assert torch.equal(torch.stack(got), want)


def test_donate_false_leaves_the_callers_state_intact(scene):
    inputs, cams, offs = scene
    cfg = cfg_of("flagship")
    step = bt.make_denoise_frame(cfg, donate=False)
    state0, _ = step(bt.zero_state(cfg, "cpu"), frame_in(inputs, 0),
                     cams[0], offs[0], 0)
    kept = state0.src8.clone()
    state1, _ = step(state0, frame_in(inputs, 1), cams[0], offs[1], 1)
    assert torch.equal(state0.src8, kept)
    assert not torch.equal(state1.src8, kept)


def test_stage_names_are_the_jax_scopes():
    """The port's ranges are JAX's scopes less the TPU warp's own
    sub-scopes (its plan, kernel, fix-up and fallback tiers)."""
    tpu_warp = {s for s in STAGE_SCOPES
                if s.startswith("warp_") and s != "warp_taps"}
    assert tpu_warp >= {"warp_plan", "warp_fallback", "warp_fixup"}
    assert set(STAGES) == set(STAGE_SCOPES) - tpu_warp
    assert len(STAGES) == len(set(STAGES))


@pytest.mark.parametrize("flags", [
    [], ["--trace", "--warp-mode", "pallas", "--fitter-impl",
         "pallas_direct", "--solver", "cholesky", "--residual-dtype",
         "bfloat16"]])
def test_profile_stages_prints_every_stage(capsys, flags):
    assert profile_stages.main(["--device", "cpu", "--width", "64",
                                "--height", "48", "--reps", "1",
                                *flags]) == 0
    lines = capsys.readouterr().out.splitlines()
    for name in STAGES:
        assert any(line.startswith(name) for line in lines), name
    tail = ("total",) if "--trace" in flags else (
        "full frame, eager", "full frame, compiled")
    for name in tail:
        assert any(line.startswith(name) for line in lines), name
