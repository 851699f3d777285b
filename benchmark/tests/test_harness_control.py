"""The control: the plain reference computed one step below the float32
every configuration states (every product's operands rounded to TF32) in
the program's place. It must come out not correct under each
configuration's limits. On the card, at the cells' size, its readings
come from ``benchmark/readings.py``; here it runs at 160x96 on the CPU."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import cells, check, scenes, window  # noqa: E402
from benchmark.reference.bmfr import settings_from_config  # noqa: E402
from bmfr_tpu_torch.pipeline.denoise import FrameInputs  # noqa: E402

W, H, T = 160, 96, 30
CPU = torch.device("cpu")


@pytest.mark.parametrize("name", ["flagship_cholesky_720p",
                                  "reference_exact_720p",
                                  "householder_flagship_720p_temporal"])
def test_the_tf32_control_is_not_correct(name):
    bench = cells.load_benchmark()
    config = cells.config(bench, name)
    config = dict(config, bmfr=dict(config["bmfr"], image_width=W,
                                    image_height=H))
    s = settings_from_config(config)
    traffic = dict(cells.traffic("orbit_pipelined"), width=W, height=H,
                   frames=T)
    clip = window.Clip(FrameInputs, *scenes.render_clip(traffic, 7, CPU))
    last_t = T + 9
    picks = {last_t - 3, last_t - 1}
    ref_state, ref_results = check.replay(s, clip, 0, last_t, picks)
    ctl_state, ctl_results = check.replay(s, clip, 0, last_t, picks, "tf32")
    got = check.numbers(ctl_results, ctl_state, ref_results, ref_state)
    limits = config["correct"]["limits"]
    compared = {k: (got[k], lim) for k, lim in limits.items()}
    assert not check.passed(compared), compared


def test_the_tf32_control_of_a_scene_runners_call_is_not_correct():
    """The scene runner's configuration, its 4 clips from the zero state:
    the control over each scene's compared frames, frame 0 and the last
    among them, against the reference."""
    bench = cells.load_benchmark()
    config = cells.config(bench, "flagship_cholesky_720p_x4")
    config = dict(config, bmfr=dict(config["bmfr"], image_width=W,
                                    image_height=H))
    s = settings_from_config(config)
    traffic = dict(cells.traffic("orbit4_clips60"), width=W, height=H,
                   frames=8)
    batch = window.Scenes(FrameInputs,
                          *scenes.render_scenes(traffic, 7, CPU))
    results = torch.zeros((batch.S, batch.T, 3, H, W))
    _, got = check.clip_numbers(s, batch, results, 7,
                                traffic["check"]["sampled"], "tf32")
    limits = config["correct"]["limits"]
    compared = {k: (got[k], lim) for k, lim in limits.items()}
    assert not check.passed(compared), compared
