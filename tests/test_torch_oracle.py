"""The port pinned to the NumPy oracle on the CPU:

- the port's copy of the oracle (``bmfr_tpu_torch/oracle/``) is the JAX
  package's but its module docstrings, and gives the same arrays bit for
  bit: the literal oracle at 64x48 over 2 frames, the vectorized one at
  72x48 over 2 frames;
- the port's default path (plain versions) against the literal oracle at
  72x48 over 2 frames (the workset rounds on both axes), and against the
  vectorized oracle on corridor and swing at 72x48 over 4 frames (swing's
  eye jumps at frame 2), at the tolerances of
  tests/test_nonaligned_width.py (``bmfr_tpu_torch/parity.py``);
- the flagships (plain versions) against the oracle at 72x48 over 3
  frames: at least 58 dB per frame, at least 97 % of accept bits equal
  on orbit, and the accept bits those of the oracle on the bf16 state;
- the flagship's per-frame floor of equal accept bits rejects the
  control, the oracle on a state truncated to bf16, on corridor.
"""

import ast
import inspect

import numpy as np
import pytest

import bmfr_tpu_torch as bt
from bmfr_tpu import oracle as jax_oracle
from bmfr_tpu.config import BMFRConfig as JaxConfig
from bmfr_tpu.oracle import reference_vec as jax_reference_vec
from bmfr_tpu_torch import oracle, parity
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.oracle import reference, reference_vec

from torch_threads import one_intra_op_thread  # noqa: F401

LIMITS = dict(position_limit_squared=0.03, normal_limit_squared=0.5)
CFG = bt.BMFRConfig(image_width=72, image_height=48, **LIMITS)


def frames_of(sc, T):
    return [{k: sc[k][t] for k in ("normals", "positions", "noisy",
                                   "albedo")} for t in range(T)]


def assert_outputs_equal(got, want):
    assert len(got) == len(want)
    for t, (g, w) in enumerate(zip(got, want)):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype, (t, k)
            np.testing.assert_array_equal(g[k], w[k], err_msg=f"{t} {k}")


@pytest.mark.parametrize("copy,original", [
    (reference, jax_oracle.reference),
    (reference_vec, jax_reference_vec)], ids=["reference", "reference_vec"])
def test_oracle_copy_is_the_original_but_its_docstring(copy, original):
    def body(module):
        tree = ast.parse(inspect.getsource(module))
        assert isinstance(tree.body[0].value, ast.Constant)
        return ast.dump(ast.Module(tree.body[1:], []))

    assert body(copy) == body(original)
    assert oracle.__all__ == jax_oracle.__all__


def test_literal_oracle_copy_bit_equal():
    sc = synthetic_sequence(width=64, height=48, frames=2, seed=0)
    args = (frames_of(sc, 2), sc["camera_matrices"], sc["pixel_offsets"])
    jcfg = JaxConfig(image_width=64, image_height=48, **LIMITS)
    assert_outputs_equal(
        oracle.oracle_denoise_sequence(bt.config_from_jax(jcfg), *args),
        jax_oracle.oracle_denoise_sequence(jcfg, *args))


@pytest.fixture(scope="module")
def orbit():
    """The 72x48 orbit scene and the port's vectorized oracle over its 3
    frames."""
    sc = synthetic_sequence(width=72, height=48, frames=3, seed=0)
    return sc, reference_vec.oracle_denoise_sequence_vec(
        CFG, frames_of(sc, 3), sc["camera_matrices"], sc["pixel_offsets"])


def test_vectorized_oracle_copy_bit_equal(orbit):
    sc, got = orbit
    want = jax_reference_vec.oracle_denoise_sequence_vec(
        JaxConfig(image_width=72, image_height=48, **LIMITS),
        frames_of(sc, 2), sc["camera_matrices"], sc["pixel_offsets"])
    assert_outputs_equal(got[:2], want)


def check_default(sc, oracle_outs):
    port = parity.port_frames(CFG, sc, "cpu")
    for t, (p, o) in enumerate(zip(port, oracle_outs)):
        rec = parity.compare(p, o)
        assert parity.default_faults(rec) == [], (t, rec)
        assert rec["psnr_db"] > 120.0, (t, rec)


def test_default_path_meets_literal_oracle_72x48():
    assert CFG.workset_width == 96 and CFG.blocks_x == 4
    sc = synthetic_sequence(width=72, height=48, frames=2, seed=9)
    check_default(sc, oracle.oracle_denoise_sequence(
        CFG, frames_of(sc, 2), sc["camera_matrices"], sc["pixel_offsets"]))


@pytest.fixture(scope="module")
def corridor():
    """The 72x48 corridor scene and the vectorized oracle over its 4
    frames."""
    sc = synthetic_sequence(width=72, height=48, frames=4, scene="corridor")
    return sc, parity.oracle_frames(CFG, sc)


@pytest.mark.parametrize("scene", ["corridor", "swing"])
def test_default_path_meets_vectorized_oracle(scene, request):
    if scene == "corridor":
        sc, oracle_outs = request.getfixturevalue("corridor")
    else:
        sc = synthetic_sequence(width=72, height=48, frames=4, scene=scene)
        oracle_outs = parity.oracle_frames(CFG, sc)
    check_default(sc, oracle_outs)


def test_flagship_floor_rejects_truncated_state(corridor):
    sc, oracle_outs = corridor
    # frames 0 and 1: the control's lowest frame is 1
    control = parity.oracle_frames(CFG, {k: v[:2] for k, v in sc.items()},
                                   round_state=parity.bf16_truncate)
    shares = [parity.compare(c, o)["accept_share"]
              for c, o in zip(control, oracle_outs)]
    assert min(shares) < parity.FLAGSHIP_ACCEPT_SHARE, shares


@pytest.fixture(scope="module")
def orbit_bf16(orbit):
    return parity.oracle_frames(CFG, orbit[0], round_state=parity.bf16_round)


@pytest.mark.parametrize("solver", ["cholesky", "householder"])
def test_flagship_meets_oracle(orbit, orbit_bf16, solver):
    sc, oracle_outs = orbit
    port = parity.port_frames(CFG.replace(**{**bt.FLAGSHIP, "solver": solver}),
                              sc, "cpu")
    recs = [parity.compare(p, o) for p, o in zip(port, oracle_outs)]
    bf16 = [parity.compare(p, o) for p, o in zip(port, orbit_bf16)]
    assert parity.flagship_faults(recs, bf16) == []
    # the default path's bar is beyond the flagship: the check has teeth
    assert any(parity.default_faults(r) for r in recs[1:])
    # on orbit every frame holds 97 %, above the floor set by corridor
    for r in recs:
        assert r["psnr_db"] >= parity.FLAGSHIP_DB, recs
        assert r["accept_share"] >= 0.97, recs
