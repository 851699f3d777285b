"""The raw-plane ``TemporalState`` carry written in place, on the CPU at
the 64x48 ``tiny_cfg``/``tiny_scene``:

- the flagship's warp on a ``TemporalState``: kernel I's plain version in
  ``"packed_bf16"`` on the six tensors equals kernel A's plain version on
  their ``pack_pairs_bf16`` (JAX packs the raw planes at the read) bit
  for bit, NaN where NaN, on states with NaN and infinite values and at
  NaN, +-3e9 and INT_MAX coordinates;
- kernels G and F with the destination ``into`` (their plain versions
  here): the values they give without it, stored into exactly the
  carry's six tensors, the pass-through result never aliasing the tone;
- ``denoise_frame``: eagerly, without ``into``, the caller's state is
  never written (as in JAX); with ``into`` (the compiled step's carry,
  ``state`` itself) the frames equal the eager ones and the carry holds
  the eager next state; a destination that shares a plane raises.

The kernels themselves run on the card (``tests/test_torch_gpu.py``);
the flagship on this carry is held to JAX in
``tests/test_torch_exact_path.py::test_householder_flagship_matches_jax``.
"""

import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch.ops.reproject import (noisy_tail, noisy_tail_reference,
                                          reproject_coords)
from bmfr_tpu_torch.ops.tail import filtered_tail, filtered_tail_reference
from bmfr_tpu_torch.ops.warp import pack_pairs_bf16
from bmfr_tpu_torch.ops.warp_blend import (warp_blend_planes_reference,
                                           warp_blend_reference)
from conftest import to_chw
from test_torch_default_kernels import H, INT_MAX, W, same_bits, state_planes
from test_torch_stages import random_planes
from torch_threads import one_intra_op_thread  # noqa: F401

T = torch.from_numpy
#: coordinates the warp must read as kernel A reads them: NaN (floor 0),
#: +-3e9 (saturated to the int32 limits) and INT_MAX itself (2**31 as f32)
COORDS = {"nan": np.nan, "+3e9": 3e9, "-3e9": -3e9,
          "int_max": float(INT_MAX)}


def raw_state(planes):
    """A TemporalState of the 16 channels ``[16, H, W]``."""
    return bt.TemporalState(
        positions=T(planes[0:3]), normals=T(planes[3:6]),
        noisy=T(planes[6:9]), spp=T(planes[9].astype(np.uint8)),
        out=T(planes[10:13]), result=T(planes[13:16]))


def carry_of(cfg, fill=7.0):
    """Six distinct tensors of a state, filled with a sentinel."""
    H_, W_ = cfg.image_height, cfg.image_width
    return bt.TemporalState(
        *(torch.full((3, H_, W_), fill) for _ in range(3)),
        torch.full((H_, W_), 99, dtype=torch.uint8),
        *(torch.full((3, H_, W_), fill) for _ in range(2)))


def flagship_cfg(tiny_cfg):
    return bt.config_from_jax(tiny_cfg).replace(**bt.FLAGSHIP)


def path_cfg(tiny_cfg, path):
    return {"flagship": flagship_cfg(tiny_cfg),
            "default": bt.config_from_jax(tiny_cfg)}[path]


def frame_args(sc, t):
    inputs = bt.frame_inputs_from_numpy(
        *(sc[k][t] for k in ("normals", "positions", "noisy", "albedo")),
        "cpu")
    return (inputs, T(sc["camera_matrices"][max(t - 1, 0)]),
            T(sc["pixel_offsets"][t]), t)


@pytest.mark.parametrize("coord", list(COORDS))
@pytest.mark.parametrize("seed", [0, 1])
def test_temporal_warp_is_kernel_a_on_the_pack(tiny_cfg, tiny_scene, seed,
                                               coord):
    """Kernel I's plain version in ``"packed_bf16"`` on a TemporalState
    equals kernel A's plain version on the state's channel-pair pack, bit
    for bit and NaN where NaN: what lets the flagship's TemporalState
    carry skip the pack."""
    cfg = flagship_cfg(tiny_cfg)
    planes = state_planes(seed)
    state = raw_state(planes)
    pos, nrm = (T(to_chw(tiny_scene[k][2])) for k in ("positions",
                                                      "normals"))
    pfx, pfy = reproject_coords(cfg, pos, T(tiny_scene["camera_matrices"][1]),
                                T(tiny_scene["pixel_offsets"][2]))
    pfx, pfy = pfx.clone(), pfy.clone()
    v = COORDS[coord]
    pfx[0, :W // 2] = v          # in x, in y and in both
    pfy[1, W // 2:] = v
    pfx[2:6, 3] = pfy[2:6, 3] = v
    pfx[7, 5] = v
    pfy[7, 5] = -v
    got = warp_blend_planes_reference(cfg, state, pos, nrm, pfx, pfy,
                                      "packed_bf16")
    src8 = pack_pairs_bf16([*state.positions, *state.normals, *state.noisy,
                            state.spp.float(), *state.out, *state.result])
    want = warp_blend_reference(cfg, src8, pos, nrm, pfx, pfy)
    assert bool(torch.isnan(want).any())
    same_bits(got.numpy(), want.numpy())


@pytest.mark.parametrize("case", ["taa", "skip_taa", "frame 0"])
def test_tails_write_exactly_the_carry(tiny_cfg, tiny_scene, case):
    """G and F with ``into`` give the values they give without it, and
    store them into the carry's six tensors and nothing else: G the
    positions, normals, accumulated colour and spp, F the out and result.
    Where K5 passes the frame through, ``into.result`` gets the tone's
    values in a tensor of its own."""
    cfg = flagship_cfg(tiny_cfg)
    if case == "skip_taa":
        cfg = cfg.replace(skip_taa=True)
    frame = 0 if case == "frame 0" else 2
    rng = np.random.default_rng(9)
    pos, nrm, noisy, alb = (T(to_chw(tiny_scene[k][2])) for k in
                            ("positions", "normals", "noisy", "albedo"))
    planes = T(random_planes(rng))
    filtered = T(rng.random((3, H, W)).astype(np.float32))
    pp = reproject_coords(cfg, pos, T(tiny_scene["camera_matrices"][1]),
                          T(tiny_scene["pixel_offsets"][2]))
    inputs = [t.clone() for t in (pos, nrm, noisy, alb, planes, filtered,
                                  pp)]
    k1 = noisy_tail_reference(cfg, noisy, pp, planes, pos, nrm, frame)
    want = filtered_tail_reference(cfg, filtered, planes, alb, k1["spp"],
                                   k1["prev_pixels"], frame)
    assert (want[2] is want[1]) == (case != "taa")

    into = carry_of(cfg)
    sentinel = [t.clone() for t in into]
    k1i = noisy_tail(cfg, noisy, pp, planes, pos, nrm, frame, into=into)
    assert k1i["accum"] is into.noisy and k1i["spp"] is into.spp
    for k in ("accum", "spp", "accept", "prev_pixels"):
        assert torch.equal(k1i[k], k1[k]), k
    assert torch.equal(into.positions, pos)
    assert torch.equal(into.normals, nrm)
    for name in ("out", "result"):        # F's, not yet written
        assert torch.equal(getattr(into, name),
                           sentinel[into._fields.index(name)]), name

    got = filtered_tail(cfg, filtered, planes, alb, k1i["spp"],
                        k1i["prev_pixels"], frame, into=into)
    assert got[0] is into.out and got[2] is into.result
    assert got[2].data_ptr() != got[1].data_ptr()
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(into.result, want[1] if case != "taa" else want[2])
    # the inputs are read, never written
    for a, b in zip((pos, nrm, noisy, alb, planes, filtered, pp), inputs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["flagship", "default"])
def test_eager_step_leaves_the_callers_state(tiny_cfg, tiny_scene, path):
    """Without ``into`` the eager step hands on a new TemporalState of
    this frame's tensors and writes nothing of the caller's, as JAX's
    eager step does."""
    cfg = path_cfg(tiny_cfg, path)
    state, _ = bt.denoise_frame(cfg, bt.TemporalState.initial(cfg, "cpu"),
                                *frame_args(tiny_scene, 0))
    kept = [t.clone() for t in state]
    nxt, outs = bt.denoise_frame(cfg, state, *frame_args(tiny_scene, 1))
    for a, b in zip(state, kept):
        assert torch.equal(a, b)
    assert not any(a is b for a, b in zip(nxt, state))
    assert outs["result"] is nxt.result and outs["accum"] is nxt.noisy


@pytest.mark.parametrize("path", ["flagship", "default"])
def test_step_into_its_own_carry_equals_eager(tiny_cfg, tiny_scene, path):
    """The compiled step's pattern: each frame with history writes its
    next state into the state it reads (``into=state``, six distinct
    tensors). The results and every field of the carry equal the eager
    step's, frame by frame."""
    cfg = path_cfg(tiny_cfg, path)
    eager, _ = bt.denoise_frame(cfg, bt.TemporalState.initial(cfg, "cpu"),
                                *frame_args(tiny_scene, 0))
    carry = bt.TemporalState(*(t.clone() for t in eager))
    for t in (1, 2):
        eager, want = bt.denoise_frame(cfg, eager,
                                       *frame_args(tiny_scene, t))
        nxt, got = bt.denoise_frame(cfg, carry, *frame_args(tiny_scene, t),
                                    into=carry)
        assert nxt is carry
        for k in ("result", "tone", "out", "accum", "spp", "accept"):
            assert torch.equal(got[k], want[k]), (t, k)
        for name, a, b in zip(carry._fields, carry, eager):
            assert torch.equal(a, b), (t, name)


def test_a_destination_must_be_six_distinct_tensors(tiny_cfg, tiny_scene):
    """``TemporalState.initial`` shares one zero plane among five fields:
    as a destination it raises, and so do a plane of another shape, a
    non-contiguous plane, a destination beside a pack and a destination
    for a packed step."""
    cfg = flagship_cfg(tiny_cfg)
    args = frame_args(tiny_scene, 1)
    state = carry_of(cfg, 0.0)
    with pytest.raises(ValueError, match="share memory"):
        bt.denoise_frame(cfg, state, *args,
                         into=bt.TemporalState.initial(cfg, "cpu"))
    halves = carry_of(cfg)._replace(
        normals=torch.zeros((3, H, 2 * W))[..., ::2])
    with pytest.raises(ValueError, match="contiguous"):
        bt.denoise_frame(cfg, state, *args, into=halves)
    with pytest.raises(ValueError, match="shape"):
        bt.denoise_frame(cfg, state, *args,
                         into=carry_of(cfg)._replace(spp=state.spp[1:]))
    big = torch.zeros(3 * H * W + 1)
    shifted = carry_of(cfg)._replace(out=big[:3 * H * W].view(3, H, W),
                                     result=big[1:].view(3, H, W))
    with pytest.raises(ValueError, match="share memory"):
        bt.denoise_frame(cfg, state, *args, into=shifted)
    zeros = [torch.zeros((c, H, W)) for c in (3, 2, 13, 3, 3)]
    with pytest.raises(ValueError, match="exclusive"):
        noisy_tail_reference(cfg, *zeros, 1,
                             pack=torch.zeros((8, H, W), dtype=torch.int32),
                             into=carry_of(cfg))
    with pytest.raises(ValueError, match="TemporalState step"):
        bt.denoise_frame(cfg, bt.PackedState.initial(cfg, "cpu"), *args,
                         into=carry_of(cfg))
