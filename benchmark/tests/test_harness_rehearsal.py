"""A rehearsal of the benchmark on the CPU: ``BENCHMARK.json`` against
the contract's rules, each cell's run end to end at 128x96 through the
port's eager step (the check, the result's line, no device metric), the
timed path broken underneath (``correct`` false), and the command
without a card (non-zero, no result)."""

import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import cells, yardstick  # noqa: E402
from benchmark.harness import run_cell  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
#: 128x96: at 64x48 a bf16 state's one flipped rounding in ~9000 values
#: moves a relative RMS by ~4e-5, the size of the limits set at 1280x720;
#: a scene runner's cell warms up with one call
SMALL = {"width": 128, "height": 96, "frames": 24, "warm_frames": 6,
         "warm_calls": 1, "trace": {"host_span_frames": 5}}
CELLS = [w["name"] for w in BENCH["workloads"]]


def one_line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(one_line(w) for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir()
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    # a full check of 24 cells (2 + 14 runs a cell, each allowed the window
    # and 60 s; 180 s a cell to compile; 1200 s spare) fits 12 hours
    runs = 2 + 14 * 24
    assert (runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
            <= 43200)
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_names_units_and_keys():
    names = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"})):
        for e in BENCH[group]:
            assert set(e) == keys
            assert NAME.match(e["name"]) and e["name"] not in names
            names.add(e["name"])
            assert one_line(e["why"])
    metric_names = set()
    for group, keys in (("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for m in BENCH[group]:
            assert set(m) - {"workloads"} == keys, m["name"]
            assert NAME.match(m["name"]) and m["name"] not in metric_names
            metric_names.add(m["name"])
            assert UNIT.match(m["unit"])
            assert m["better"] in ("lower", "higher")
            assert m["source"] in ("device_trace", "program_span",
                                   "program_counter", "host_clock")
            assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for c in BENCH["configs"]:
        assert one_line(c["source"]) and c["source"].startswith("https://")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])


def test_cells_and_their_files():
    pairs = set()
    configs = {c["name"]: c for c in BENCH["configs"]}
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert (ROOT / configs[w["config"]]["file"]).is_file()
        assert (ROOT / "benchmark" / "traffic"
                / f"{w['traffic']}.json").is_file()
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == set(configs)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(set(files)) == len(files)
    assert all(f.startswith("benchmark/") for f in files)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(
        1, len(BENCH["workloads"]) // 4)


def test_end_to_end_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and 1 <= len(e2e) <= 16
    for m in e2e.values():
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_what_the_contract_asks(cell):
    e2e = [m["name"] for m in cells.end_to_end(BENCH, cell)]
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = cells.per_layer(BENCH, cell)
    assert layers
    for m in layers:
        # the end-to-end metric it moves is reported in this cell
        assert m["moves"] in e2e, (cell, m["name"])


def test_per_layer_metrics_have_readers_and_layers():
    layers = {}
    for m in BENCH["per_layer"]:
        assert (ROOT / "benchmark" / "metrics"
                / f"{m['name']}.py").is_file()
        assert one_line(m["layer"])
        layers.setdefault(m["layer"], set()).add(m["name"])
        if m["name"].endswith("_roofline") and m["name"] != "frame_roofline":
            kernel = m["name"][:-len("_roofline")]
            assert (ROOT / "benchmark" / "roofline"
                    / f"{kernel}.py").is_file()
            assert m["unit"] == "%"
    perf = (ROOT / "PERF.md").read_text()
    for layer in layers:
        assert f"`{layer}`" in perf, layer


@pytest.mark.parametrize("trace_on", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cpu_rehearsal_of_a_run(cell, trace_on):
    rec = run_cell(cell, 2**31 + 977, 0.5, bool(trace_on),
                   device=torch.device("cpu"), t_start=time.perf_counter(),
                   overrides=SMALL)
    assert rec["correct"] is True, rec["compared"]
    assert rec["failed"] == 0 and rec["attempted"] > SMALL["warm_frames"]
    # a CPU run writes no metric under a device metric's name, and no
    # device reading
    assert rec["metrics"] == {}
    assert rec["device"]["platform"] == "cpu"
    assert "memory_peak_bytes" not in rec["device"]
    assert list(rec)[-1] == "compared"
    config = cells.config(BENCH, cells.cell(BENCH, cell)["config"])
    assert set(rec["compared"]) == set(config["correct"]["limits"])


@pytest.mark.parametrize("fault", ["state_unchanged", "answer_altered"])
@pytest.mark.parametrize("cell", ["flagship.orbit.pipelined",
                                  "reference_exact.orbit.interactive",
                                  "householder_temporal.orbit.pipelined"])
def test_a_broken_timed_path_is_not_correct(cell, fault):
    rec = run_cell(cell, 31337, 0.3, False, device=torch.device("cpu"),
                   t_start=time.perf_counter(), overrides=SMALL, fault=fault)
    assert rec["correct"] is False, rec["compared"]


def _command(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_the_command_without_a_card_prints_no_result():
    out = _command(ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_the_command_without_the_program_prints_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _command(tmp_path)
    assert out.returncode != 0
    assert out.stdout.strip() == ""


def test_metric_readers_return_nothing_from_an_empty_trace():
    from benchmark.reference.bmfr import Settings
    from benchmark.trace import Reading

    empty = Reading(settings=Settings(64, 48), config={"carry":
                                                       "PackedState"},
                    frames=10, window_us=1000.0, busy_us=0.0, device=[],
                    host_spans_s=[], gaps=[])
    for m in BENCH["per_layer"]:
        assert yardstick.load("metrics", m["name"]).read(empty) is None
