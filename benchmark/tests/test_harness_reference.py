"""The benchmark's plain PyTorch reference (:mod:`benchmark.reference.
bmfr`) against the frozen NumPy oracle, at a tiny size, and what the
benchmark may import."""

import ast
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from benchmark import cells, scenes  # noqa: E402
from benchmark.reference import bmfr  # noqa: E402
from benchmark.reference.oracle_reference_vec import (  # noqa: E402
    oracle_denoise_sequence_vec)

W, H, T = 48, 32, 4
CPU = torch.device("cpu")
CONFIGS = ("flagship_cholesky_720p", "reference_exact_720p",
           "householder_flagship_720p_temporal")


def settings(name, **kw):
    config = cells.config(cells.load_benchmark(), name)
    s = bmfr.settings_from_config(config)
    return bmfr.Settings(**{**s.__dict__, "image_width": W,
                            "image_height": H, **kw})


@pytest.fixture(scope="module")
def clip():
    traffic = dict(cells.traffic("orbit_pipelined"), width=W, height=H,
                   frames=T)
    return scenes.render_clip(traffic, 99, CPU)


def run_reference(s, clip, precision="highest"):
    planes, cams, offs = clip
    state = bmfr.zero_state(s, CPU)
    outs = []
    with bmfr.tf32_off():
        for t in range(T):
            state, out = bmfr.frame_step(
                s, state, planes["positions"][t], planes["normals"][t],
                planes["noisy"][t], planes["albedo"][t],
                cams[max(t - 1, 0)], offs[t], t, history=t > 0,
                precision=precision)
            outs.append(out)
    return outs


def run_oracle(s, clip):
    planes, cams, offs = clip
    frames = [{k: planes[k][t].permute(1, 2, 0).numpy()
               for k in ("normals", "positions", "noisy", "albedo")}
              for t in range(T)]
    return oracle_denoise_sequence_vec(s, frames, cams.numpy(), offs.numpy())


def hwc(x):
    return x.permute(1, 2, 0).numpy() if x.dim() == 3 else x.numpy()


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_the_oracle_in_float32(clip, name):
    """Each configuration's settings with the state and the TAA residual
    in float32 (what the oracle states): every stage within float32
    rounding of the oracle's, the accept bits and spp exact."""
    s = settings(name, state_dtype="float32", residual_dtype="float32")
    ref = run_reference(s, clip)
    orc = run_oracle(s, clip)
    for t in range(T):
        for k in ("accum", "filtered", "out", "tone", "result"):
            np.testing.assert_allclose(hwc(ref[t][k]), orc[t][k], rtol=1e-4,
                                       atol=2e-5, err_msg=f"{k} frame {t}")
        np.testing.assert_array_equal(hwc(ref[t]["spp"]),
                                      orc[t]["spp"].astype(np.float32))
        np.testing.assert_array_equal(hwc(ref[t]["accept"]),
                                      orc[t]["accept"].astype(np.int32))


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_as_each_configuration_states_it(clip, name):
    """The stated settings (the flagship: a bf16 state and a bf16 TAA
    residual): frame 0 reads no state and equals the oracle's; the later
    frames stay within what bf16 rounding of the state moves."""
    s = settings(name)
    ref = run_reference(s, clip)
    orc = run_oracle(s, clip)
    np.testing.assert_allclose(hwc(ref[0]["result"]), orc[0]["result"],
                               rtol=1e-4, atol=2e-5)
    for t in range(1, T):
        got, want = hwc(ref[t]["result"]), orc[t]["result"]
        rms = np.sqrt(((got - want) ** 2).sum() / (want ** 2).sum())
        assert rms < (2e-2 if s.state_dtype == "bfloat16" else 1e-5), t


def test_state_store_rounds_to_bf16_nearest_even():
    s = bmfr.Settings(4, 4, state_dtype="bfloat16")
    x = torch.tensor([1.0 + 2 ** -8, 1.0 + 3 * 2 ** -8, 255.0, 3.0e-3])
    assert bmfr.store(s, x).tolist() == [1.0, 1.015625, 255.0,
                                         float(torch.tensor(3.0e-3).to(
                                             torch.bfloat16).float())]


def test_tf32_control_moves_the_fit(clip):
    s = settings("reference_exact_720p")
    ref = run_reference(s, clip)
    ctl = run_reference(s, clip, "tf32")
    assert not torch.equal(ref[-1]["filtered"], ctl[-1]["filtered"])
    assert torch.equal(ref[-1]["accum"], ctl[-1]["accum"])


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_jax_anywhere_in_the_benchmark():
    """By top-level name, compared whole: ``bmfr_tpu_torch`` begins with
    ``bmfr_tpu`` and is the program under test."""
    files = sorted((ROOT / "benchmark").rglob("*.py"))
    assert files
    for f in files:
        found = set(_imports(f)) & {"jax", "jaxlib", "flax", "bmfr_tpu"}
        assert not found, f"{f} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    files = sorted((ROOT / "benchmark" / "reference").rglob("*.py"))
    assert files
    for f in files:
        found = set(_imports(f)) & {"bmfr_tpu_torch", "jax", "bmfr_tpu"}
        assert not found, f"{f} imports {found}"
