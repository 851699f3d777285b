"""Kernel B's solve schedule and its phase instrumentation, on the CPU.

``csrc/fitter_chol.cu`` factors the augmented system [G; b^T] right-looking
on one warp (lane r holds row r; the forward solve L y = b is three more
rows of the factorization) and back-solves on 30 lanes, one per (colour,
row). This file replays that schedule step by step in f32 PyTorch and
holds it bit for bit to the plain version's left-looking loops
(``fitter.cholesky_solve``, ``_chol_kernel``'s order), which shows that
every entry takes its subtractions in the same order. It also checks that
``scripts/torch_chol_phases.py`` finds every phase marker of the kernel.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bmfr_tpu_torch.ops.fitter import cholesky_solve

ROOT = Path(__file__).resolve().parents[1]
F, B = 10, 13


def phases_script():
    """scripts/torch_chol_phases.py as a module (it imports no torch at
    the top)."""
    path = ROOT / "scripts" / "torch_chol_phases.py"
    spec = importlib.util.spec_from_file_location("torch_chol_phases", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def warp_schedule_solve(G):
    """The kernel's schedule over ``[nb]`` vectors. G: ``[nb, F, B]``.
    Returns weights ``[nb, F, 3]`` with NaN -> 0."""
    # lane r < B: row r of [G; b^T] (the upper entries are never used)
    a = [[G[:, min(r, c), max(r, c)] for c in range(F)] for r in range(B)]
    for j in range(F):
        ljj = torch.sqrt(a[j][j])
        for r in range(B):
            a[r][j] = ljj if r == j else a[r][j] / ljj
        for r in range(B):
            for c in range(j + 1, F):
                a[r][c] = a[r][c] - a[r][j] * a[c][j]
    # lane (ch, i): x_i of colour ch from column i of L and y = row F + ch
    w = torch.empty(G.shape[0], F, 3, dtype=G.dtype)
    for ch in range(3):
        x = [None] * F
        for s in reversed(range(F)):
            v = a[F + ch][s]
            for k in range(s + 1, F):
                v = v - a[k][s] * x[k]
            x[s] = v / a[s][s]
        w[:, :, ch] = torch.stack(x, dim=1)
    return torch.where(torch.isnan(w), 0.0, w)


def gram_of(data):
    return torch.einsum("bfe,bge->bfg", data[:, :F], data)


@pytest.mark.parametrize("case", ["random", "near_singular", "singular"])
def test_warp_schedule_equals_left_looking_bitwise(case):
    r = np.random.default_rng(5)
    data = r.standard_normal((64, B, 256)).astype(np.float32)
    if case == "near_singular":
        data[:, 3] = data[:, 2] + 1e-4 * data[:, 3]
    elif case == "singular":
        data[:32, 5] = 0.0                  # a zero column: NaN -> 0
        data[32:, 6] = data[32:, 1]         # a repeated one
    G = gram_of(torch.from_numpy(data))
    got = warp_schedule_solve(G)
    want = cholesky_solve(G, F)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    if case == "singular":
        assert bool((want[:32] == 0).all())


def test_phase_script_stamps_every_phase():
    torch_chol_phases = phases_script()
    src = (ROOT / "bmfr_tpu_torch" / "csrc" / "fitter_chol.cu").read_text()
    stamped, names = torch_chol_phases.stamped_source(src)
    assert sorted(names) == [1, 2, 3, 4, 5]
    for slot in [*names, torch_chol_phases.SLOTS - 1]:
        assert stamped.count(f"BMFR_STAMP({slot});") == 1
    # the closing stamp follows a barrier at the kernel's end, which every
    # thread reaches: the kernel has no early return
    kernel = stamped[stamped.index("__global__"):stamped.index("int launch(")]
    assert "__syncthreads();\n  BMFR_STAMP(15);" in kernel
    assert "return" not in kernel


def test_phase_summary_from_fake_stamps():
    """Two CTAs of 2 warps on one SM, one after the other; warp 1 alone
    stamps a marker inside a branch (slot 6)."""
    tcp = phases_script()
    clk = np.zeros((4, tcp.MAX_WARPS, tcp.SLOTS), np.int64)
    for cta, t0 in ((0, 1000), (1, 3000)):
        for w in range(2):
            clk[cta, w, [1, 2, tcp.SLOTS - 1]] = [t0, t0 + 400, t0 + 1000]
        clk[cta, 1, 6] = t0 + 700
    rec = tcp.summarize(clk, np.zeros(4, np.uint32),
                        {1: "one", 2: "two", 6: "inside"})
    assert (rec["ctas"], rec["warps"], rec["most_resident_per_sm"]) == (2, 2, 1)
    assert rec["life_mean_cycles"] == 1000
    assert rec["sm_span_max_cycles"] == 3000
    assert {k: v["mean_cycles"] for k, v in rec["phases"].items()} == {
        "1. one": 400, "2. two": 600}
    assert rec["warp_arrival_cycles"] == {
        "one": [0, 0], "two": [400, 400], "inside": [None, 700],
        "end": [1000, 1000]}
