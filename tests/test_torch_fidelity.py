"""The port's fidelity harness (``bmfr_tpu_torch/fidelity.py``) and its
SSIM on the CPU, against the JAX package's:

- ``ssim`` equal to :func:`bmfr_tpu.metrics.ssim` within 1e-9 on HWC, CHW
  and 2-D images, given numpy arrays or torch tensors;
- ``default_config_matrix`` field by field equal to JAX's, every entry
  supported by the port;
- ``run_sweep`` at 64x48 over 2 frames with ``aa_samples=2`` against
  JAX's on the same scene for four configurations (the flagships' rows
  against the port's own default row: the interpret-mode JAX flagship is
  too slow here);
- the skipped-row and OpenCL-PNG-only cases of
  tests/test_round2_fixes.py, ``print_report`` on both, and ``main`` with
  ``--device cpu``.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu import fidelity as jax_fidelity
from bmfr_tpu import metrics as jax_metrics
from bmfr_tpu.config import BMFRConfig as JaxConfig
from bmfr_tpu_torch import fidelity, metrics
from bmfr_tpu_torch.config import check_supported
from bmfr_tpu_torch.io.fixtures import synthetic_sequence

from torch_threads import one_intra_op_thread  # noqa: F401

LIMITS = dict(position_limit_squared=0.03, normal_limit_squared=0.5)
JAX_BASE = JaxConfig(image_width=64, image_height=48, **LIMITS)
BASE = bt.config_from_jax(JAX_BASE)


@pytest.mark.parametrize("as_tensor", [False, True], ids=["numpy", "torch"])
@pytest.mark.parametrize("shape", [(48, 64, 3), (3, 48, 64), (48, 64)],
                         ids=["hwc", "chw", "2d"])
def test_ssim_and_psnr_match_jax(shape, as_tensor):
    r = np.random.RandomState(len(shape))
    a = r.rand(*shape).astype(np.float32)
    b = np.clip(a + 0.05 * r.randn(*shape), 0, 1).astype(np.float32)
    x, y = (torch.from_numpy(a), torch.from_numpy(b)) if as_tensor else (a, b)
    assert metrics.ssim(x, y) == pytest.approx(jax_metrics.ssim(a, b),
                                               abs=1e-9)
    assert metrics.ssim(x, x) == pytest.approx(1.0, abs=1e-12)
    assert metrics.psnr(x, y) == pytest.approx(jax_metrics.psnr(a, b),
                                               abs=1e-9)
    assert metrics.psnr(x, x) == float("inf")


def test_default_config_matrix_matches_jax():
    got = fidelity.default_config_matrix(BASE)
    want = jax_fidelity.default_config_matrix(JAX_BASE)
    assert list(got) == list(want) and len(got) == 11
    for name, cfg in want.items():
        assert dataclasses.asdict(got[name]) == dataclasses.asdict(
            bt.config_from_jax(cfg)), name
        check_supported(got[name])
    assert got["first_order"].fitter_impl == "auto"


@pytest.fixture(scope="module")
def scene():
    return synthetic_sequence(width=64, height=48, frames=2, seed=0,
                              aa_samples=2)


@pytest.fixture(scope="module")
def port_rows(scene):
    return {r["config"]: r for r in fidelity.run_sweep(
        {"orbit": scene}, BASE, device="cpu")}


def test_run_sweep_matches_jax(scene, port_rows):
    names = ("default", "first_order", "no_taa", "residual_bf16")
    matrix = jax_fidelity.default_config_matrix(JAX_BASE)
    want = jax_fidelity.run_sweep({"orbit": scene}, JAX_BASE,
                                  configs={n: matrix[n] for n in names})
    for w in want:
        g = port_rows[w["config"]]
        assert g["scene"] == w["scene"] == "orbit"
        assert g["noisy_psnr"] == w["noisy_psnr"]
        for key in ("psnr_mean", "psnr_first", "psnr_last"):
            assert g[key] == pytest.approx(w[key], abs=0.01), (w, key)
        assert g["ssim_mean"] == pytest.approx(w["ssim_mean"], abs=1e-4)


def test_flagship_rows_near_default(port_rows):
    assert len(port_rows) == 11
    for name in ("flagship", "flagship_cholesky", "flagship_f32res"):
        assert port_rows[name]["psnr_mean"] == pytest.approx(
            port_rows["default"]["psnr_mean"], abs=0.05), name
        assert port_rows[name]["noisy_psnr"] == port_rows["default"][
            "noisy_psnr"]


def test_sweep_skips_scene_without_reference(capsys):
    sc = synthetic_sequence(width=64, height=48, frames=2, seed=0)
    noref = {k: v for k, v in sc.items() if k not in ("clean", "clean_aa")}
    rows = fidelity.run_sweep({"noref": noref}, BASE, device="cpu")
    assert len(rows) == 1 and rows[0]["skipped"]
    fidelity.print_report(rows)
    assert "(skipped)" in capsys.readouterr().out


def test_sweep_against_opencl_pngs_only(capsys):
    """A scene with only reference-output PNGs (no clean EXRs) still
    produces the vs-OpenCL PSNR column, as in the JAX harness."""
    sc = synthetic_sequence(width=64, height=48, frames=2, seed=1)
    clean_tone = np.clip(
        np.power(np.maximum(0.0, sc.pop("clean")), 0.454545), 0, 1)
    sc["opencl"] = clean_tone  # stand-in for decoded output PNGs
    rows = fidelity.run_sweep({"s": sc}, BASE, configs={"default": BASE},
                              device="cpu")
    want = jax_fidelity.run_sweep({"s": sc}, JAX_BASE,
                                  configs={"default": JAX_BASE})
    assert rows[0]["opencl_psnr_mean"] > 15.0
    assert "psnr_mean" not in rows[0] and rows[0]["noisy_psnr"] is None
    assert rows[0]["opencl_psnr_mean"] == pytest.approx(
        want[0]["opencl_psnr_mean"], abs=0.01)
    fidelity.print_report(rows)
    assert f"{rows[0]['opencl_psnr_mean']:.2f}" in capsys.readouterr().out


def test_main_writes_the_record(tmp_path, capsys):
    out = tmp_path / "fid.json"
    assert fidelity.main(["--synthetic", "--device", "cpu", "--width", "40",
                          "--height", "24", "--frames", "2", "--json-out",
                          str(out)]) == 0
    record = json.loads(out.read_text())
    assert record["meta"] == dict(width=40, height=24, frames=2,
                                  device="cpu")
    rows = record["rows"]
    assert len(rows) == 44
    assert {r["scene"] for r in rows} == {"orbit-a", "orbit-b", "corridor",
                                          "swing"}
    assert all(r["psnr_mean"] > r["noisy_psnr"] for r in rows)
    assert "flagship_cholesky" in capsys.readouterr().out
