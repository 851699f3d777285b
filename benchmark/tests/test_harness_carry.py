"""The carry a configuration names: the start state the harness builds
from the configuration file's ``carry`` (:func:`benchmark.cells.
start_state`), and the carried state as the check compares it
(:func:`benchmark.check.carried`)."""

import sys
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import bmfr_tpu_torch as bt  # noqa: E402
from benchmark import cells, check  # noqa: E402
from benchmark.reference import bmfr  # noqa: E402
from bmfr_tpu_torch.graft_entry import entry_config  # noqa: E402

BENCH = cells.load_benchmark()
CONFIGS = [c["name"] for c in BENCH["configs"]]
#: the configurations whose start state ``bt.zero_state`` built before the
#: harness built the carry a configuration names
BEFORE = ("flagship_cholesky_720p", "reference_exact_720p")
TEMPORAL = "householder_flagship_720p_temporal"
CPU = torch.device("cpu")


def program_config(name, **bmfr_keys):
    config = cells.config(BENCH, name)
    config = dict(config, bmfr=dict(config["bmfr"], image_width=64,
                                    image_height=48, **bmfr_keys))
    return config, bt.config.check_supported(bt.BMFRConfig(**config["bmfr"]))


@pytest.mark.parametrize("name", BEFORE)
def test_the_start_state_is_what_zero_state_built(name):
    config, cfg = program_config(name)
    got = cells.start_state(bt, config, cfg, CPU)
    want = bt.zero_state(cfg, CPU)
    assert type(got) is type(want)
    assert type(got).__name__ == config["carry"]
    for a, b in zip(got, want, strict=True):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.device == b.device
        assert torch.equal(a, b) and not a.any()


@pytest.mark.parametrize("name", CONFIGS)
def test_the_start_state_is_the_carry_each_configuration_names(name):
    config, cfg = program_config(name)
    state = cells.start_state(bt, config, cfg, CPU)
    assert type(state).__name__ == config["carry"]
    assert all(not t.any() for t in state)


def test_the_graft_entry_configuration_starts_from_a_temporal_state():
    config, cfg = program_config(TEMPORAL)
    assert cfg.warp_mode == "pallas"
    state = cells.start_state(bt, config, cfg, CPU)
    assert isinstance(state, bt.TemporalState)
    # what zero_state would have built, and the harness refused
    assert isinstance(bt.zero_state(cfg, CPU), bt.PackedState)


def test_the_configuration_is_the_graft_entry_s():
    config = cells.config(BENCH, TEMPORAL)
    assert bt.BMFRConfig(**config["bmfr"]).validate() == entry_config()
    assert config["kernels"] == ["H", "I", "G", "C", "F"]


def test_a_carry_the_step_does_not_take_raises_naming_both():
    config, cfg = program_config("reference_exact_720p")
    assert cfg.warp_mode == "float32"
    with pytest.raises(SystemExit, match="PackedState.*float32"):
        cells.start_state(bt, dict(config, carry="PackedState"), cfg, CPU)
    with pytest.raises(SystemExit, match="'FlatState'"):
        cells.start_state(bt, dict(config, carry="FlatState"), cfg, CPU)


def random_temporal_state(seed=3, H=6, W=10):
    g = torch.Generator().manual_seed(seed)

    def plane():
        return torch.randn((3, H, W), generator=g) * 7.0

    return bt.TemporalState(
        normals=plane(), positions=plane(), noisy=plane(),
        spp=torch.randint(0, 256, (H, W), generator=g, dtype=torch.uint8),
        out=plane(), result=plane())


def test_a_bf16_temporal_carry_is_compared_as_the_next_frame_reads_it():
    state = random_temporal_state()
    got = check.carried(cells.config(BENCH, TEMPORAL), state)
    s = bmfr.Settings(10, 6, state_dtype="bfloat16")
    for k in bmfr.STATE_FIELDS:
        raw = getattr(state, k).float()
        assert got[k].dtype == torch.float32
        # rounded to bf16 nearest-even, as the reference stores it
        assert torch.equal(got[k], bmfr.store(s, raw)), k
        if k != "spp":
            assert not torch.equal(got[k], raw), k
    assert torch.equal(got["spp"], state.spp.float())


def test_an_f32_temporal_carry_is_compared_bit_for_bit():
    state = random_temporal_state()
    got = check.carried(cells.config(BENCH, "reference_exact_720p"), state)
    for k in bmfr.STATE_FIELDS:
        assert torch.equal(got[k], getattr(state, k).float()), k


def test_a_packed_carry_is_read_as_before():
    """The words' bf16 halves, channel 2k low and 2k+1 high."""
    g = torch.Generator().manual_seed(5)
    ch = (torch.randn((16, 4, 6), generator=g) * 3).to(torch.bfloat16)
    words = ch.view(8, 2, 4, 6).permute(0, 2, 3, 1).contiguous().view(
        torch.int32).view(8, 4, 6)
    got = check.carried(cells.config(BENCH, "flagship_cholesky_720p"),
                        bt.PackedState(words))
    want = ch.float()
    for k, sl in (("positions", slice(0, 3)), ("normals", slice(3, 6)),
                  ("noisy", slice(6, 9)), ("out", slice(10, 13)),
                  ("result", slice(13, 16))):
        assert torch.equal(got[k], want[sl]), k
    assert torch.equal(got["spp"], want[9])


@pytest.mark.parametrize("name", BEFORE + (TEMPORAL,))
def test_the_configurations_before_the_scene_runner_name_the_per_frame_step(
        name):
    config = cells.config(BENCH, name)
    assert "entry" not in config and "scenes" not in config
    assert cells.entry(config) == ("make_denoise_frame", 1)


def test_the_scene_runners_configuration():
    config = cells.config(BENCH, "flagship_cholesky_720p_x4")
    assert cells.entry(config) == ("denoise_scenes_jit", 4)
    flagship = cells.config(BENCH, "flagship_cholesky_720p")
    assert config["bmfr"] == flagship["bmfr"]
    assert config["carry"] == "PackedState" == flagship["carry"]
    _, cfg = program_config("flagship_cholesky_720p_x4")
    assert type(bt.zero_state(cfg, CPU)).__name__ == config["carry"]
    with pytest.raises(SystemExit):
        cells.entry(dict(config, entry="denoise_sequence"))
    with pytest.raises(SystemExit):
        cells.entry(dict(config, entry="make_denoise_frame"))


@pytest.mark.parametrize("cell, entry", [
    ("flagship.orbit.pipelined", "make_denoise_frame"),
    ("householder_temporal.orbit.pipelined", "make_denoise_frame"),
    ("flagship_x4.orbit.clips60", "denoise_scenes_jit")])
def test_each_cell_runs_the_entry_its_configuration_names(monkeypatch, cell,
                                                          entry):
    """A cell whose configuration names no entry builds the per-frame step
    and never the scene runner; the scene runner's cell the reverse."""
    import time

    from benchmark.harness import run_cell

    built = []
    for name in ("make_denoise_frame", "denoise_scenes_jit"):
        def spy(*args, _name=name, _fn=getattr(bt, name), **kw):
            built.append(_name)
            return _fn(*args, **kw)
        monkeypatch.setattr(bt, name, spy)
    rec = run_cell(cell, 2**31 + 5, 0.1, False, device=CPU,
                   t_start=time.perf_counter(),
                   overrides={"width": 128, "height": 96, "frames": 4,
                              "warm_frames": 2, "warm_calls": 1})
    assert built == [entry]
    assert rec["correct"] is True, rec["compared"]
