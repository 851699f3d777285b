"""Kernel B's solve schedule and its phase instrumentation, on the CPU.

``csrc/fitter_chol.cu`` factors the augmented system [G; b^T] right-looking
on one warp (lane r holds row r; the forward solve L y = b is three more
rows of the factorization) and back-solves on 30 lanes, one per (colour,
row). This file replays that schedule step by step in f32 PyTorch and
holds it bit for bit to the plain version's left-looking loops
(``fitter.cholesky_solve``, ``_chol_kernel``'s order), which shows that
every entry takes its subtractions in the same order. It also checks that
``scripts/torch_chol_phases.py`` finds every phase marker of kernel B and
of the basis kernels B and C.
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from bmfr_tpu_torch.ops.fitter import cholesky_solve

from torch_threads import one_intra_op_thread  # noqa: F401

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


def basis_schedule_solve(G, nf):
    """``csrc/fitter_chol_basis.cu``'s schedule for ``nf`` features: the
    same factorization on lanes 0..nf+2, and the back solve one lane per
    (colour, row) in passes of ``min(32 // nf, 3)`` colours."""
    nb = nf + 3
    a = [[G[:, min(r, c), max(r, c)] for c in range(nf)] for r in range(nb)]
    for j in range(nf):
        ljj = torch.sqrt(a[j][j])
        for r in range(nb):
            a[r][j] = ljj if r == j else a[r][j] / ljj
        for r in range(nb):
            for c in range(j + 1, nf):
                a[r][c] = a[r][c] - a[r][j] * a[c][j]
    cpp = min(32 // nf, 3)
    w = torch.empty(G.shape[0], nf, 3, dtype=G.dtype)
    for p in range(-(-3 // cpp)):
        for ch in range(p * cpp, min(p * cpp + cpp, 3)):
            x = [None] * nf
            for s in reversed(range(nf)):
                v = a[nf + ch][s]
                for k in range(s + 1, nf):
                    v = v - a[k][s] * x[k]
                x[s] = v / a[s][s]
            w[:, :, ch] = torch.stack(x, dim=1)
    return torch.where(torch.isnan(w), 0.0, w)


@pytest.mark.parametrize("nf", [1, 4, 7, 11, 13])
def test_basis_schedule_equals_left_looking_bitwise(nf):
    """The basis kernel's schedule (4..16 columns; two colours a pass
    above 10 features) equals the plain left-looking loops bit for bit."""
    r = np.random.default_rng(nf)
    data = r.standard_normal((64, nf + 3, 256)).astype(np.float32)
    if nf > 2:
        data[:16, 2] = data[:16, 1]         # a repeated column: NaN -> 0
    t = torch.from_numpy(data)
    G = torch.einsum("bfe,bge->bfg", t[:, :nf], t)
    got = basis_schedule_solve(G, nf)
    want = cholesky_solve(G, nf)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("kernel,phases", [
    ("B", [1, 2, 3, 4, 5]), ("B-basis", [1, 2, 3, 4, 5]),
    ("C-basis", [1, 2, 3, 4])])
def test_phase_script_stamps_every_phase(kernel, phases):
    torch_chol_phases = phases_script()
    source = torch_chol_phases.KERNELS[kernel][0]
    src = (ROOT / "bmfr_tpu_torch" / "csrc" / source).read_text()
    stamped, names = torch_chol_phases.stamped_source(src)
    assert sorted(names) == phases
    for slot in [*names, torch_chol_phases.SLOTS - 1]:
        assert stamped.count(f"BMFR_STAMP({slot});") == 1
    # the closing stamp follows a barrier at the kernel's end, which every
    # thread reaches: the kernel has no early return
    kernel = stamped[stamped.index("__global__"):stamped.index("int launch(")]
    assert "__syncthreads();\n  BMFR_STAMP(15);" in kernel
    assert "return" not in kernel
    # the stamps' prelude follows the source's last header
    assert stamped.index("bmfr_phase_clock[") > stamped.rindex('#include "')


def test_phase_script_stamps_early_returns():
    """A kernel that returns early gets the closing stamp at each return
    and at its end, with no closing barrier (it would wait for threads
    that have left)."""
    tcp = phases_script()
    src = ('#include "x.cuh"\n__global__ void k(int* o) {\n'
           '  // ---- 1. one ----\n  if (o == nullptr) return;\n'
           '  // ---- 2. two ----\n  o[0] = 1;\n}\nint launch() {}\n')
    stamped, names = tcp.stamped_source(src)
    assert names == {1: "one", 2: "two"}
    kernel = stamped[stamped.index("__global__"):stamped.index("int launch(")]
    assert kernel.count("BMFR_STAMP(15);") == 2
    assert "{ BMFR_STAMP(15); return; }" in kernel
    assert "__syncthreads()" not in kernel


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


def test_phase_script_adds_up_kernel_f_loop():
    """Kernel F's CTAs are persistent and meet its markers once a tile:
    the stamps of its ring kernel (not the K4-only kernel before it) add
    up, from a BMFR_BEGIN at its start to a BMFR_END at its end, with no
    closing barrier; the other kernels' sources stamp as before."""
    tcp = phases_script()
    source, _, _, name = tcp.KERNELS["F"]
    assert "F" in tcp.LOOPED and name == "filtered_tail_kernel"
    src = (ROOT / "bmfr_tpu_torch" / "csrc" / source).read_text()
    stamped, names = tcp.stamped_source(src, name, loop=True)
    assert sorted(names) == [1, 2, 3, 4]
    assert max(names) < tcp.LOOP_SLOTS
    for slot in names:
        assert stamped.count(f"BMFR_STAMP({slot});") == 1
    head = stamped.index(name + "(const Params")
    body = stamped[head:stamped.index("// ---- the host side ----")]
    assert body.count("BMFR_BEGIN;") == 1 and body.count("BMFR_END;") == 1
    assert body.index("BMFR_BEGIN;") < body.index("BMFR_STAMP(1);")
    assert body.rindex("BMFR_STAMP(4);") < body.index("BMFR_END;")
    assert "__syncthreads();\n  BMFR_END;" not in body
    k4_only = stamped[:head]
    assert "BMFR_BEGIN" not in k4_only.split("LOOP_PRELUDE")[-1].split(
        "#define BMFR_END")[-1]
    assert "__shared__ unsigned bmfr_acc" in stamped
    # a tile spec sets the kernel's tile and ring
    assert tcp.tile_defines("64x16x2") == [
        "-DBMFR_F_TX=64", "-DBMFR_F_TY=16", "-DBMFR_F_STAGES=2"]
    assert tcp.tile_defines(None) == []


def test_phase_script_adds_up_kernel_k_loop():
    """Kernel K's CTAs walk their pixels in a loop: its stamps add up
    (set-up, loads and products, stores; the last two in both of its
    instances), each return and its end close a warp's record; a second
    checkout's package loads beside this one under another name, with its
    own ``_lib`` and wrappers, and its ``weighted_sum`` takes this
    checkout's config and gives the same image (the plain version, on
    the CPU)."""
    tcp = phases_script()
    source, wrapper, _, name = tcp.KERNELS["K"]
    assert "K" in tcp.LOOPED and wrapper == "weighted_sum"
    src = (ROOT / "bmfr_tpu_torch" / "csrc" / source).read_text()
    stamped, names = tcp.stamped_source(src, name, loop=True)
    assert sorted(names) == [1, 2, 3]
    body = stamped[stamped.index(name + "(FeatureTable"):
                   stamped.index("}  // namespace", stamped.index(name))]
    assert body.count("BMFR_BEGIN;") == 1
    assert body.count("BMFR_STAMP(1);") == 1
    assert body.count("BMFR_STAMP(2);") == body.count("BMFR_STAMP(3);") == 2
    assert body.count("{ BMFR_END; return; }") == 2
    assert body.rstrip().endswith("BMFR_END;\n}")
    assert body.count("BMFR_END;") == 3
    import sys

    import bmfr_tpu_torch as bt
    from bmfr_tpu_torch.ops import weighted_sum as ws

    alias = "bmfr_tpu_torch_phases_test"
    other = tcp.other_package(ROOT, alias)
    try:
        assert other is not bt and other.__name__ == alias
        ows = sys.modules[alias + ".ops.weighted_sum"]
        assert ows is not ws and ows.weighted_sum is not ws.weighted_sum
        assert sys.modules[alias + ".ops._lib"].CSRC == ws._lib.CSRC
        H, W = 24, 40
        cfg = bt.BMFRConfig(image_width=W, image_height=H, block_edge=8)
        g = torch.Generator().manual_seed(5)
        n, pos, noisy = torch.randn(3, 3, H, W, generator=g)
        w = torch.randn(cfg.n_blocks, cfg.feature_count, 3, generator=g)
        mm = torch.randn(cfg.n_blocks, cfg.feature_count
                         - cfg.features_not_scaled_count, 2, generator=g)
        args = (cfg, w, mm, n, pos, noisy, 3)
        assert torch.equal(ows.weighted_sum(*args), ws.weighted_sum(*args))
    finally:
        for name in [m for m in sys.modules
                     if m == alias or m.startswith(alias + ".")]:
            del sys.modules[name]


def test_loop_phase_summary_from_fake_stamps():
    """Two persistent CTAs of 2 warps on one SM at once: each warp's
    cycles per phase (slot 0 before the first marker), start and end."""
    tcp = phases_script()
    clk = np.zeros((4, tcp.MAX_WARPS, tcp.SLOTS), np.int64)
    for cta in (0, 1):
        for w in range(2):
            clk[cta, w, [0, 1, 2]] = [100, 300 + 100 * w, 600 - 100 * w]
            clk[cta, w, [tcp.SLOTS - 2, tcp.SLOTS - 1]] = [5000, 6000]
    rec = tcp.summarize_loop(clk, np.zeros(4, np.uint32),
                             {1: "wait", 2: "work"})
    assert (rec["ctas"], rec["warps"], rec["most_resident_per_sm"]) == (2, 2, 2)
    assert rec["life_mean_cycles"] == 1000
    phases = rec["phases"]
    assert list(phases) == ["0. set-up", "1. wait", "2. work"]
    assert phases["1. wait"]["mean_cycles"] == 300
    assert phases["1. wait"]["share"] == pytest.approx(2 * 700 / 4000)
    assert phases["2. work"]["share_warp0"] == pytest.approx(0.6)
