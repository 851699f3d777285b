"""The port's public names and command defaults against the JAX
package's: ``DEFAULT_CONFIG``, ``geometry.BLOCK_OFFSETS_COUNT`` and
``frame_offset``, and the defaults of ``profile_stages``' parser (JAX's
is built inside its ``main``, so its ``add_argument`` calls are read from
the source)."""

import ast
from pathlib import Path

import numpy as np

import bmfr_tpu
import bmfr_tpu_torch as bt
from bmfr_tpu import geometry as jgeo
from bmfr_tpu_torch import geometry, profile_stages
from bmfr_tpu_torch.config import check_supported
from bmfr_tpu_torch.ops.blockify import jitter_offset

REPO = Path(__file__).resolve().parents[1]


def jax_parser_defaults():
    """``{dest: default}`` of every ``add_argument`` call in the JAX
    ``profile_stages.py`` that passes a literal ``default``."""
    tree = ast.parse((REPO / "bmfr_tpu" / "profile_stages.py").read_text())
    out = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            flag = node.args[0].value
            kw = {k.arg: k.value for k in node.keywords}
            dest = flag.lstrip("-").replace("-", "_")
            if "default" in kw:
                out[dest] = ast.literal_eval(kw["default"])
            else:
                out[dest] = None
    return out


def test_profile_stages_defaults_match_jax():
    want = jax_parser_defaults()
    assert want["warp_mode"] == "packed_x_bf16"
    got = vars(profile_stages._build_argparser().parse_args([]))
    for dest, default in want.items():
        if dest == "xplane":      # the TPU trace; the port's is --trace
            assert got["trace"] is False
            continue
        assert got[dest] == default, dest


def test_profile_stages_default_config_is_jax_command_config():
    """With no flags the port profiles the configuration the JAX command
    builds (``BMFRConfig`` with the limits and ``--warp-mode``)."""
    args = profile_stages._build_argparser().parse_args([])
    assert (args.fitter_impl, args.solver, args.tmp_dtype,
            args.residual_dtype) == (
        bt.DEFAULT_CONFIG.fitter_impl, bt.DEFAULT_CONFIG.solver,
        bt.DEFAULT_CONFIG.tmp_data_dtype, bt.DEFAULT_CONFIG.residual_dtype)
    assert args.trace is False and args.device.type == "cuda"


def test_default_config_matches_jax():
    assert "DEFAULT_CONFIG" in bt.__all__
    assert bt.config_from_jax(bmfr_tpu.DEFAULT_CONFIG) == bt.DEFAULT_CONFIG
    assert bt.DEFAULT_CONFIG == bt.BMFRConfig()
    assert check_supported(bt.DEFAULT_CONFIG) is bt.DEFAULT_CONFIG


def test_block_offsets_count_matches_jax():
    assert geometry.BLOCK_OFFSETS_COUNT == jgeo.BLOCK_OFFSETS_COUNT == 16
    assert geometry.BLOCK_OFFSETS_COUNT == len(geometry.BLOCK_OFFSETS)


def test_frame_offset_matches_jax_and_jitter_offset():
    for f in range(41):
        got = geometry.frame_offset(f)
        assert isinstance(got, np.ndarray) and got.dtype == np.int32
        np.testing.assert_array_equal(got, jgeo.frame_offset(f))
        assert tuple(int(v) for v in got) == jitter_offset(f)
