"""The frame driver on the CPU at the 64x48 ``tiny_cfg``/``tiny_scene``:

- the step object (``pipeline/graph.py::CompiledStep``) is the one rule
  of which frames replay: a frame with history on a card replays, and a
  frame without history, a frame on the CPU and a step built ``plain``
  run ``denoise_frame`` eagerly;
- on CPU tensors it equals ``denoise_frame`` bit for bit over frames 0-3
  on both carries, captures nothing, and without donation leaves the
  caller's states intact;
- the one loop (``pipeline/denoise.py::step_frames``) hands frame
  ``t0 + i`` the matrix of frame ``t0 + i - 1`` and frame 0 its own
  (``PreviousCameras``), the states from one frame to the next, and each
  scene-frame's outputs into the caller's tensors.

The step object on the card (frame 0 eagerly, no replay):
tests/test_torch_gpu.py (``test_step_object_runs_frame_zero_eagerly``).
"""

from types import SimpleNamespace

import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch.pipeline.denoise import PreviousCameras, step_frames
from bmfr_tpu_torch.pipeline.graph import CompiledStep

from torch_threads import one_intra_op_thread  # noqa: F401

T = 4


def flagship_cfg(tiny_cfg):
    return bt.config_from_jax(tiny_cfg).replace(**bt.FLAGSHIP)


@pytest.fixture(scope="module")
def frames():
    from bmfr_tpu_torch.io.fixtures import synthetic_sequence

    sc = synthetic_sequence(width=64, height=48, frames=T, seed=0)
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], "cpu")
    return (inputs, torch.from_numpy(sc["camera_matrices"]),
            torch.from_numpy(sc["pixel_offsets"]))


def frame_args(frames, t):
    inputs, cams, offs = frames
    return (bt.FrameInputs(*(x[t] for x in inputs)), PreviousCameras(cams)[t],
            offs[t], t)


def copy_of(state):
    return type(state)(*(x.clone() for x in state))


def on_card(frame):
    """Stand-in arguments of a scene whose inputs lie on a card: the rule
    reads only their device and the frame."""
    return (None, bt.FrameInputs(*[SimpleNamespace(is_cuda=True)] * 4),
            None, None, frame)


def test_the_rule_of_which_frames_replay(tiny_cfg):
    step = CompiledStep(flagship_cfg(tiny_cfg))
    i32 = torch.tensor(1, dtype=torch.int32)
    assert step.replays([on_card(1)])
    assert step.replays([on_card(1), on_card(7)])
    assert step.replays([on_card(i32)], history="always")
    assert not step.replays([on_card(0)])
    assert not step.replays([on_card(1), on_card(0)])
    assert not step.replays([on_card(5)], history="never")
    assert not step.replays([(None, bt.FrameInputs(*[torch.zeros(1)] * 4),
                              None, None, 1)])
    with pytest.raises(ValueError, match="needs history"):
        step.replays([on_card(i32)])
    assert not CompiledStep(flagship_cfg(tiny_cfg),
                            plain=True).replays([on_card(1)])


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("carry", ["packed", "temporal"])
def test_step_object_on_the_cpu_is_denoise_frame(tiny_cfg, frames, carry,
                                                 donate):
    """Frames 0-3 through the step object on CPU tensors equal the eager
    ``denoise_frame`` bit for bit, in the results and the states; none
    replays and nothing is captured. Without donation every state the
    caller held is intact."""
    cfg = flagship_cfg(tiny_cfg)
    initial = (bt.PackedState if carry == "packed"
               else bt.TemporalState).initial
    want, want_state = [], initial(cfg, "cpu")
    for t in range(T):
        want_state, out = bt.denoise_frame(cfg, want_state,
                                           *frame_args(frames, t))
        want.append(out["result"].clone())
    step = CompiledStep(cfg, donate=donate)
    state, held = initial(cfg, "cpu"), []
    for t in range(T):
        state, out = step.run(state, *frame_args(frames, t))
        assert not step.replayed
        assert torch.equal(out["result"], want[t])
        held.append((state, copy_of(state)))
    for a, b in zip(state, want_state):
        assert torch.equal(a, b)
    assert step.capture_seconds == {}
    if not donate:
        for kept, copy in held:
            for a, b in zip(kept, copy):
                assert torch.equal(a, b)


class RecordingStep:
    """A step object that records what each call hands it and returns a
    new state and the frame number as every output."""

    def __init__(self):
        self.calls = []

    def run_scenes(self, calls):
        self.calls.append(calls)
        return [(("state", s, frame), dict(result=torch.full((2,), frame),
                                           tone=torch.full((2,), -frame)))
                for s, (_, _, _, _, frame) in enumerate(calls)]


@pytest.mark.parametrize("t0", [0, 5])
def test_the_loop_hands_each_frame_the_previous_camera(t0):
    """Frame ``t0 + i`` reads the matrix of frame ``t0 + i - 1`` and frame
    0 its own; each call gets every scene's state from the call before;
    each output lands at its scene and frame."""
    S, n = 2, 4
    cams = torch.arange(S * 10, dtype=torch.float32)[:, None, None].expand(
        S * 10, 4, 4).reshape(S, 10, 4, 4)     # cams[s, t] = 10 s + t
    inputs = bt.FrameInputs(*(torch.zeros(S, n, 1) for _ in range(4)))
    offs = torch.zeros(S, n, 2)
    lag = [PreviousCameras(cams[s, t0:t0 + n], cams[s, t0 - 1] if t0 else None)
           for s in range(S)]
    out = dict(result=torch.zeros(S, n, 2), tone=torch.zeros(S, n, 2))
    step = RecordingStep()
    states = step_frames(step, ["a", "b"], inputs, lag, offs, t0, out)
    assert states == [("state", s, t0 + n - 1) for s in range(S)]
    assert len(step.calls) == n
    for i, calls in enumerate(step.calls):
        t = t0 + i
        for s, (state, _, cam, _, frame) in enumerate(calls):
            assert frame == t
            assert torch.equal(cam, cams[s, max(t - 1, 0)])
            assert state == (["a", "b"][s] if i == 0
                             else ("state", s, t - 1))
    frame_of = torch.arange(t0, t0 + n, dtype=torch.float32)
    assert torch.equal(out["result"], frame_of[None, :, None].expand(S, n, 2))
    assert torch.equal(out["tone"], -out["result"])
