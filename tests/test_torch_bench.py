"""The port's bench (``python -m bmfr_tpu_torch.bench``) against the JAX
package's ``bench.py``, on the CPU at 64x48x4: its ``BENCH_*`` names and
defaults, its JSON keys and metric name and its default configuration,
read from ``bench.py``'s source; its output equal to ``denoise_sequence``
bit for bit; its warp record; no device number on the CPU; no run
without a card unless the CPU is asked for; and the per-stage split of
the sequence (``profile_stages.sequence_trace_report``) on the CPU."""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu.config import BMFRConfig as JaxConfig
from bmfr_tpu_torch import bench
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.profile_stages import (eager_sequence,
                                           sequence_trace_report)
from bmfr_tpu_torch.profiling import STAGES

from torch_threads import one_intra_op_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
JAX_BENCH = ast.parse((REPO / "bench.py").read_text())
PORT_BENCH = ast.parse((REPO / "bmfr_tpu_torch" / "bench.py").read_text())
#: bench.py's backend retry knobs: the documented divergence (no retry)
JAX_ONLY = {"BENCH_INIT_ATTEMPTS", "BENCH_INIT_BACKOFF_S"}
#: the port's device knob (a card unless the CPU is asked for)
PORT_ONLY = {"BENCH_DEVICE"}
SMALL = {"BENCH_WIDTH": "64", "BENCH_HEIGHT": "48", "BENCH_FRAMES": "4",
         "BENCH_REPS": "2"}
EXACT = {"BENCH_WARP_MODE": "float32", "BENCH_FITTER": "auto",
         "BENCH_SOLVER": "householder", "BENCH_RESIDUAL": "float32"}


def env_defaults(tree):
    """``{name: default}`` of every ``os.environ.get("BENCH_...", ...)``
    call in a module's source."""
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "get"
                and ast.unparse(node.func.value) == "os.environ"
                and node.args[0].value.startswith("BENCH_")):
            out[node.args[0].value] = ast.literal_eval(node.args[1])
    return out


def jax_record_dict():
    """The dict literal of ``bench.py``'s result line (the one
    ``json.dumps`` call with ``spread_ms``)."""
    for node in ast.walk(JAX_BENCH):
        if (isinstance(node, ast.Call) and ast.unparse(node.func)
                == "json.dumps" and isinstance(node.args[0], ast.Dict)):
            d = node.args[0]
            if "spread_ms" in [k.value for k in d.keys]:
                return d
    raise AssertionError("no result line in bench.py")


def jax_bench_config(width, height):
    """The JAX ``BMFRConfig`` that ``bench.py`` builds with no ``BENCH_*``
    set: its call's keywords evaluated with an empty environment."""
    env = {"os": types.SimpleNamespace(environ={}), "width": width,
           "height": height}
    for node in ast.walk(JAX_BENCH):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "BMFRConfig"):
            kw = {k.arg: eval(compile(ast.Expression(k.value), "bench.py",
                                      "eval"), env)
                  for k in node.keywords}
            return JaxConfig(**kw).validate()
    raise AssertionError("no BMFRConfig call in bench.py")


@pytest.fixture
def clean_env(monkeypatch):
    for name in env_defaults(PORT_BENCH):
        monkeypatch.delenv(name, raising=False)
    return monkeypatch


def run_main(monkeypatch, env, argv):
    """``bench.main(argv)`` under ``env``: (its stdout lines, stderr)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert bench.main(argv) == 0
    return out.getvalue().splitlines(), err.getvalue()


def test_env_names_and_defaults_match_jax():
    want = env_defaults(JAX_BENCH)
    got = env_defaults(PORT_BENCH)
    assert JAX_ONLY <= set(want)
    assert {k: v for k, v in want.items() if k not in JAX_ONLY} == {
        k: v for k, v in got.items() if k not in PORT_ONLY}
    assert got["BENCH_DEVICE"] == "cuda"


def test_default_config_matches_jax(clean_env):
    s = bench.settings()
    want = env_defaults(JAX_BENCH)
    assert (s["frames"], s["scene"], s["reps"]) == (
        int(want["BENCH_FRAMES"]), want["BENCH_SCENE"],
        int(want["BENCH_REPS"]))
    jcfg = jax_bench_config(int(want["BENCH_WIDTH"]),
                            int(want["BENCH_HEIGHT"]))
    assert s["cfg"] == bt.config_from_jax(jcfg)
    assert s["cfg"] == bt.BMFRConfig(position_limit_squared=0.03,
                                     normal_limit_squared=0.5, **bt.FLAGSHIP)


def test_steady_only_tier_raises(clean_env):
    clean_env.setenv("BENCH_TIER", "steady_only")
    with pytest.raises(NotImplementedError):
        bench.settings()


@pytest.mark.parametrize("scene,env", [("orbit", {}), ("swing", {}),
                                       ("orbit", EXACT)],
                         ids=["flagship", "flagship-swing", "exact"])
def test_json_line_on_cpu(clean_env, scene, env):
    lines, err = run_main(clean_env, {**SMALL, **env, "BENCH_SCENE": scene},
                          ["--device", "cpu"])
    rec = json.loads(lines[-1])
    jax_keys = [k.value for k in jax_record_dict().keys]
    assert set(rec) == set(jax_keys) | set(bench.ADDED_KEYS)
    metric = next(v for k, v in zip(jax_record_dict().keys,
                                     jax_record_dict().values)
                  if k.value == "metric")
    assert rec["metric"] == eval(compile(ast.Expression(metric), "bench.py",
                                         "eval"), {"width": 64, "height": 48})
    assert rec["device"] == "cpu"
    for key in ("device_span_ms_per_frame", "busy_ms_per_frame",
                "steady_ms_per_frame"):
        assert rec[key] is None, key
    assert rec["unit"] == "ms" and len(rec["reps_ms"]) == 2
    # both rounded to 4 decimals: a slow host makes vs_baseline tiny
    assert rec["value"] > 0
    assert rec["vs_baseline"] == pytest.approx(
        bench.BASELINE_MS / rec["value"], rel=1e-3, abs=1e-4)
    assert f"scene={scene} " in rec["config"]
    # the fused warp serves every pixel; the tap paths report zeros
    served = 100.0 if "BENCH_WARP_MODE" not in env else 0.0
    assert rec["warp_kernel_served_pct"] == served
    assert rec["warp_fallback_frames"] == 0
    assert "first run" in err and "launches per run" in err


def test_output_equals_denoise_sequence():
    cfg = bt.BMFRConfig(image_width=64, image_height=48,
                        position_limit_squared=0.03,
                        normal_limit_squared=0.5, **bt.FLAGSHIP)
    inputs, cams, offs = bench.scene_inputs(
        synthetic_sequence(64, 48, 4, scene="swing"), "cpu")
    record, out, launches = bench.run_bench(
        cfg, inputs, cams, offs, reps=1, scene="swing", log=io.StringIO())
    assert torch.equal(out, bt.denoise_sequence(cfg, inputs, cams, offs))
    assert torch.equal(out, eager_sequence(cfg, inputs, cams, offs))
    assert set(launches.values()) == {0}    # the CPU runs plain versions
    assert record["config"].startswith("scene=swing ")


def test_expected_launches():
    flagship = bt.BMFRConfig(**bt.FLAGSHIP)
    # the reprojection (H), the K1 tail (G) and K4 + K5 (F) on every path
    every_path = {**dict.fromkeys(bench.COUNTERS, 0),
                  "reproject_coords": 60, "noisy_tail": 60,
                  "filtered_tail": 60}
    assert bench.expected_launches(flagship, 60) == {
        **every_path, "warp_blend": 59, "fit_reconstruct_cholesky": 60}
    assert bench.expected_launches(
        flagship.replace(solver="householder"), 60) == {
        **every_path, "warp_blend": 59, "fit_reconstruct_direct": 60}
    # the default path: the raw-plane tap warp (I) on every frame with
    # history, the feature-block store (J) and the block reconstruction
    # (K) around the block fitter (D) on every frame
    block_path = {**every_path, "warp_blend_planes": 59,
                  "build_feature_blocks": 60, "weighted_sum": 60}
    assert bench.expected_launches(bt.BMFRConfig(), 60) == {
        **block_path, "fit_blocks_pallas": 60}
    assert bench.expected_launches(bt.BMFRConfig(fitter_impl="xla"),
                                   60) == block_path


def test_no_card_exits_nonzero(clean_env, capsys):
    clean_env.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in SMALL.items():
        clean_env.setenv(k, v)
    with pytest.raises(SystemExit) as exc:
        bench.main([])
    assert exc.value.code not in (0, None)
    assert "no CUDA device" in str(exc.value.code)
    assert not [line for line in capsys.readouterr().out.splitlines()
                if line.startswith("{")]


def test_module_without_card_exits_nonzero():
    """The real command on a host with no card: a non-zero exit and no
    JSON line."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the bench would run")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BENCH_")}
    proc = subprocess.run([sys.executable, "-m", "bmfr_tpu_torch.bench"],
                          cwd=REPO, env={**env, **SMALL}, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not [line for line in proc.stdout.splitlines()
                if line.startswith("{")]


def test_profiled_run_goes_through_checked_trace(monkeypatch):
    """``bench.profiled_run`` on the CPU with a stub run of three frames
    that counts three launches of kernel F: it traces through
    ``profile_stages.checked_trace`` (the warm-up first, inside the same
    trace and outside the run's tally), holds the run's tallied launches
    to ``expected`` and takes busy and span from the device events inside
    the run's range. A stand-in adds three device events to the CPU's
    trace, and one outside the range that must not count."""
    from torch.autograd.profiler_util import Interval

    from bmfr_tpu_torch import profiling
    from bmfr_tpu_torch.ops import _lib

    F = bench.COUNTERS["filtered_tail"]
    monkeypatch.setattr(F, "launches", 0)
    order = []

    def warm():
        order.append(("warm", profiling._recording()))
        _lib.count_launch(F)

    def run():
        order.append(("run", profiling._recording()))
        _lib.count_launch(F, 3)

    def kernel(start, end):
        return types.SimpleNamespace(
            name="filtered_tail_kernel", is_user_annotation=False,
            device_type=torch.autograd.DeviceType.CUDA,
            time_range=Interval(start, end))

    calls = []

    def with_device_events(label, acts, run_, device, **kwargs):
        calls.append((label, kwargs["warm"], device))
        events = checked_trace(label, acts, run_, device, **kwargs)
        (rng,) = [e for e in events if e.name == profiling.RUN_RANGE]
        t0 = rng.time_range.start
        return list(events) + [kernel(t0 + 10, t0 + 40),
                               kernel(t0 + 100, t0 + 130),
                               kernel(t0 + 200, t0 + 260),
                               kernel(t0 - 1e6, t0 - 1e6 + 500)]

    checked_trace = bench.checked_trace
    monkeypatch.setattr(bench, "checked_trace", with_device_events)
    expected = {**dict.fromkeys(bench.COUNTERS, 0), "filtered_tail": 3}
    log = io.StringIO()
    span, busy = bench.profiled_run(warm, run, torch.device("cpu"), 3,
                                    expected, log)
    assert calls == [("[bench] profiled run", warm, torch.device("cpu"))]
    assert order == [("warm", True), ("run", True)]
    assert F.launches == 1      # the warm-up's; the run's went to the tally
    assert busy == pytest.approx(120 / 3 / 1e3)
    assert span == pytest.approx(250 / 3 / 1e3)
    assert "1 outside the run's range left out" in log.getvalue()
    with pytest.raises(RuntimeError, match="launches"):
        bench.profiled_run(warm, run, torch.device("cpu"), 3,
                           {**expected, "filtered_tail": 2}, log)
    monkeypatch.setattr(bench, "checked_trace", checked_trace)
    with pytest.raises(RuntimeError, match="no device event"):
        bench.profiled_run(warm, run, torch.device("cpu"), 3, expected, log)


def test_sequence_trace_report_on_cpu(capsys):
    cfg = bt.BMFRConfig(image_width=64, image_height=48,
                        position_limit_squared=0.03,
                        normal_limit_squared=0.5, **bt.FLAGSHIP)
    inputs, cams, offs = bench.scene_inputs(synthetic_sequence(64, 48, 3),
                                            "cpu")
    rows = sequence_trace_report(cfg, inputs, cams, offs,
                                 torch.device("cpu"), scope="k5")
    assert tuple(rows["stages"]) == STAGES
    assert sum(rows["stages"].values()) + rows["unattributed"] == (
        pytest.approx(rows["total"], rel=1e-9))
    assert rows["stages"]["k2_fitter"] > 0 and rows["stages"]["k5_taa"] > 0
    assert rows["busy"] is None and rows["span"] is None
    out = capsys.readouterr().out
    for name in STAGES + ("(unattributed)", "total"):
        assert any(line.startswith(name) for line in out.splitlines()), name
    assert "kernels inside stage or name ~'k5'" in out
