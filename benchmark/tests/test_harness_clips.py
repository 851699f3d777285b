"""The scene runner's cell on the CPU: a run of the clip mode end to end
at 128x96 through ``run_cell`` (4 scenes of 6 frames, 2 calls in flight),
the check under faults of the runner, the S views that
:func:`benchmark.scenes.render_scenes` renders, and ``clip_edge_ms``'s
reader on a synthetic trace of two calls."""

import math
import sys
import time
import types
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import cells, check, scenes, trace, window  # noqa: E402
from benchmark import yardstick  # noqa: E402
from benchmark.harness import run_cell  # noqa: E402
from benchmark.reference.bmfr import Settings  # noqa: E402
from benchmark.reference.bmfr import settings_from_config  # noqa: E402
from bmfr_tpu_torch.pipeline.denoise import FrameInputs  # noqa: E402

CELL = "flagship_x4.orbit.clips60"
S, T = 4, 6
SMALL = {"width": 128, "height": 96, "frames": T, "warm_calls": 1,
         "in_flight": 2}
SEED = 2**31 + 4099
CPU = torch.device("cpu")
BENCH = cells.load_benchmark()


def rehearse(trace_on=False, fault=None, seconds=0.3):
    return run_cell(CELL, SEED, seconds, trace_on, device=CPU,
                    t_start=time.perf_counter(), overrides=SMALL,
                    fault=fault)


@pytest.mark.parametrize("trace_on", [0, 1])
def test_a_clip_run_is_correct_and_counts_scene_frames(trace_on):
    rec = rehearse(bool(trace_on))
    assert rec["correct"] is True, rec["compared"]
    assert rec["failed"] == 0
    # one warm-up call and, untraced, at least one timed call: S x T each
    assert rec["attempted"] % (S * T) == 0
    assert rec["attempted"] >= (1 + (not trace_on)) * S * T
    assert set(rec["compared"]) == {"result_rel_rms"}
    assert rec["metrics"] == {} and rec["device"]["platform"] == "cpu"
    assert list(rec)[-1] == "compared"


@pytest.mark.parametrize("fault", ["answer_altered", "scenes_swapped",
                                   "scenes_halved"])
def test_a_broken_runner_is_not_correct(fault):
    rec = rehearse(fault=fault)
    assert rec["correct"] is False, rec["compared"]


def test_a_runner_whose_steps_keep_their_state_is_not_correct(monkeypatch):
    """Each scene's step hands back the state it was given (the zero
    state), never the one it computed."""
    from bmfr_tpu_torch.parallel import sharding

    step = sharding.denoise_frame

    def unchanged(cfg, state, *args, **kw):
        _, out = step(cfg, type(state)(*(t.clone() for t in state)), *args,
                      **kw)
        return state, out
    monkeypatch.setattr(sharding, "denoise_frame", unchanged)
    rec = rehearse()
    assert rec["correct"] is False, rec["compared"]


def test_a_raising_runner_fails_its_scene_frames(monkeypatch):
    import bmfr_tpu_torch as bt

    def runner(cfg, mesh):
        def call(*args):
            raise RuntimeError("planted")
        return call
    monkeypatch.setattr(bt, "denoise_scenes_jit", runner)
    rec = rehearse()
    assert rec["correct"] is False
    # the warm-up's call and the window's first each fail S x T
    assert rec["failed"] == 2 * S * T == rec["attempted"]


@pytest.fixture(scope="module")
def small_traffic():
    return dict(cells.traffic("orbit4_clips60"), width=64, height=48,
                frames=3)


@pytest.fixture(scope="module")
def rendered(small_traffic):
    return scenes.render_scenes(small_traffic, SEED, CPU)


def test_four_scenes_are_four_views(small_traffic, rendered):
    planes, cams, offs = rendered
    assert planes["noisy"].shape == (S, 3, 3, 48, 64)
    assert cams.shape == (S, 3, 4, 4) and offs.shape == (S, 3, 2)
    for a in range(S):
        for b in range(a + 1, S):
            assert not torch.equal(cams[a], cams[b])
            assert not torch.equal(planes["positions"][a],
                                   planes["positions"][b])
        assert torch.equal(offs[a], offs[0])
    for s in range(S):
        for t in range(3):
            ang = small_traffic["start_angle"] + s * 1.5708 + 0.02 * t
            assert scenes.angle(small_traffic, t, s) == pytest.approx(
                ang, abs=1e-15)


def test_four_scenes_draw_four_noises(small_traffic):
    """Four scenes on one view (no spacing) share their geometry and
    differ in their noise alone."""
    same_view = dict(small_traffic, scene_spacing=0.0)
    planes, _, _ = scenes.render_scenes(same_view, SEED, CPU)
    for a in range(S):
        assert torch.equal(planes["positions"][a], planes["positions"][0])
        for b in range(a + 1, S):
            assert not torch.equal(planes["noisy"][a], planes["noisy"][b])
    again, _, _ = scenes.render_scenes(same_view, SEED, CPU)
    assert torch.equal(again["noisy"], planes["noisy"])


def test_scene_zero_is_the_single_clip(small_traffic, rendered):
    planes, cams, offs = scenes.render_clip(small_traffic, SEED, CPU)
    for k in planes:
        assert torch.equal(rendered[0][k][0], planes[k])
    assert torch.equal(rendered[1][0], cams)
    assert torch.equal(rendered[2][0], offs)


def test_compared_frames_hold_the_first_and_the_last():
    for sc in range(S):
        picks = check.clip_picks(SEED, sc, 60, 4)
        assert picks[0] == 0 and picks[-1] == 59
        assert 5 <= len(picks) <= 6
        assert picks == check.clip_picks(SEED, sc, 60, 4)


def test_a_scene_against_another_scenes_reference_fails():
    """The reference's own results pass the limit; handed to the
    neighbouring scene's reference, they fail it."""
    config = cells.config(BENCH, "flagship_cholesky_720p_x4")
    config = dict(config, bmfr=dict(config["bmfr"], image_width=64,
                                    image_height=48))
    s = settings_from_config(config)
    traffic = dict(cells.traffic("orbit4_clips60"), width=64, height=48,
                   frames=4)
    batch = window.Scenes(FrameInputs,
                          *scenes.render_scenes(traffic, SEED, CPU))
    results = torch.empty((S, 4, 3, 48, 64))
    for sc in range(S):
        _, got = check.replay(s, batch.clip(sc), 0, 3, set(range(4)))
        for t in range(4):
            results[sc, t] = got[t]
    limit = config["correct"]["limits"]["result_rel_rms"]
    same, _ = check.clip_numbers(s, batch, results, SEED, 2)
    assert same["result_rel_rms"] == 0.0
    shifted, _ = check.clip_numbers(s, batch, results.roll(1, 0), SEED, 2)
    assert min(shifted["scene_result_rel_rms"]) > 100 * limit


def test_a_nan_in_any_scene_is_the_worst():
    assert math.isnan(check.worst([1e-5, math.nan, 2e-5]))
    assert check.worst([1e-5, 3e-5, 2e-5]) == 3e-5


def fake_events():
    """Two calls of the runner as the profiler lists them: each call's
    frame 0 run eagerly (two port kernels and a fill), then two graph
    replays of two kernels, each after a copy; then the gather."""
    cuda = torch.autograd.DeviceType.CUDA
    cpu = torch.autograd.DeviceType.CPU
    events, corr = [], [100]

    def ev(name, start, dur, device_type=cuda, cid=0):
        events.append(types.SimpleNamespace(
            name=name, device_type=device_type, id=cid,
            is_user_annotation=False,
            time_range=types.SimpleNamespace(
                start=start, end=start + dur,
                elapsed_us=lambda d=dur: d)))

    def launch(host, start):
        corr[0] += 1
        ev("cudaGraphLaunch", host, 5.0, cpu, corr[0])
        ev("fit_chol_kernel<0>", start, 50.0, cuda, corr[0])
        ev("filtered_tail_kernel", start + 50, 30.0, cuda, corr[0])

    ev(trace.RANGE, 0.0, 2000.0, cpu)
    for base in (0.0, 1000.0):
        ev("Memset (Device)", base + 10, 5.0)
        ev("reproject_kernel", base + 20, 10.0)
        ev("filtered_tail_kernel", base + 40, 30.0)
        for r in range(2):
            ev("Memcpy DtoD (Device -> Device)", base + 100 + 200 * r, 5.0)
            launch(base + 90 + 200 * r, base + 120 + 200 * r)
        ev("Memcpy DtoD (Device -> Device)", base + 600, 200.0)
    return events


def test_the_trace_puts_kernels_down_to_their_graph_replay():
    events = fake_events()
    dev, lo, hi, _ = trace.reduce_events(events, ())
    ids = trace.replay_of(events, ())
    assert len(ids) == len(dev) == 2 * (3 + 2 * 3 + 1)
    replayed = [d[0] for d, i in zip(dev, ids) if i is not None]
    assert len(replayed) == 8 and len(set(i for i in ids if i)) == 4
    assert all("kernel" in n for n in replayed)


def test_clip_edge_reads_the_stretch_between_two_calls():
    events = fake_events()
    dev, lo, hi, _ = trace.reduce_events(events, ())
    reading = trace.Reading(
        settings=Settings(64, 48), config={"carry": "PackedState"},
        frames=2 * S * T, window_us=hi - lo, busy_us=0.0, device=dev,
        host_spans_s=[], gaps=[], replay_of=trace.replay_of(events, ()))
    # call 1's last replay ends at 320 + 80 = 400 us; call 2's first
    # starts at 1120 us
    assert yardstick.load("metrics", "clip_edge_ms").read(reading) == (
        pytest.approx(0.720))
    # the steps between replays of one call (copies alone) are no edge,
    # nor is a trace without replays
    no_replays = trace.Reading(**{**vars(reading),
                                  "replay_of": [None] * len(dev)})
    assert yardstick.load("metrics", "clip_edge_ms").read(no_replays) is None
