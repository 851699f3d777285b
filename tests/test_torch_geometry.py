"""Kernel D's launch geometry, the kernels' noise arguments, the
entry points' device default (the card) and the build's list of
sources, on the CPU."""

import inspect

import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch import rng
from bmfr_tpu_torch.ops.fitter_pallas import (MAX_BUFFERS, MAX_SMEM,
                                              MIN_BUFFERS, THREADS,
                                              launch_geometry)

from torch_threads import one_intra_op_thread  # noqa: F401


@pytest.mark.parametrize("fn", [
    bt.zero_state, bt.PackedState.initial, bt.TemporalState.initial,
    bt.frame_inputs_from_numpy, bt.packed_state_from_jax,
    bt.temporal_state_from_jax, bt.load_state,
], ids=lambda f: f.__qualname__)
def test_entry_points_default_to_the_card(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


def test_default_device_is_the_card_or_raises():
    """No silent CPU fallback: the default state lies on the card, or
    building it raises where there is none."""
    cfg = bt.BMFRConfig(image_width=64, image_height=48)
    if torch.cuda.is_available():
        assert bt.zero_state(cfg).spp.device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            bt.zero_state(cfg)


@pytest.mark.parametrize("block_edge", range(8, 72, 8))
def test_launch_geometry_covers_every_block(block_edge):
    bp = block_edge * block_edge
    for columns in range(MIN_BUFFERS, MAX_BUFFERS + 1):
        geo = launch_geometry(block_edge, columns)
        assert geo.route == ("registers" if bp <= 1024 else "shared")
        assert geo.group * geo.rows_per_thread >= bp
        assert geo.blocks_per_cta * geo.group <= THREADS
        assert geo.blocks_per_cta >= 1
        assert 0 < geo.smem_bytes <= MAX_SMEM
        if geo.route == "registers":
            # whole warps, or one half warp (block_edge 8)
            assert geo.group % 32 == 0 or geo.group == 16
            assert geo.reg_columns == 0
        else:
            # columns in shared memory plus the ones kept in registers
            assert geo.smem_bytes >= 4 * (columns - geo.reg_columns) * bp
            assert geo.reg_columns == 0 or (bp == 4096 and columns >= 15)


def test_launch_geometry_at_the_defaults():
    assert tuple(launch_geometry(32, 13))[:3] == ("registers", 256, 1)
    assert tuple(launch_geometry(8, 13))[:3] == ("registers", 16, 16)
    assert tuple(launch_geometry(16, 13))[:3] == ("registers", 64, 4)
    assert tuple(launch_geometry(24, 13))[:3] == ("registers", 160, 1)
    assert launch_geometry(64, 13).route == "shared"
    for bad in ((32, 3), (32, 17), (12, 13), (0, 13)):
        with pytest.raises(ValueError):
            launch_geometry(*bad)


def kernel_noise(frame, feature_count, block_pixels, buffer_count, amount):
    """csrc/fitter_front.cuh's noise_at in numpy uint32 arithmetic."""
    base, amp = rng.noise_params(frame, block_pixels, buffer_count, amount)
    e = np.arange(block_pixels, dtype=np.uint32)[None]
    f = np.arange(feature_count, dtype=np.uint32)[:, None]
    a = e + f * np.uint32(block_pixels) + np.uint32(base)
    a = (a + np.uint32(0x7ED55D16)) + (a << np.uint32(12))
    a = (a ^ np.uint32(0xC761C23C)) ^ (a >> np.uint32(19))
    a = (a + np.uint32(0x165667B1)) + (a << np.uint32(5))
    a = (a + np.uint32(0xD3A2646C)) ^ (a << np.uint32(9))
    a = (a + np.uint32(0xFD7046C5)) + (a << np.uint32(3))
    a = (a ^ np.uint32(0xB55A4F09)) ^ (a >> np.uint32(16))
    u = a.astype(np.float32) * np.float32(2.0 ** -32)
    out = np.float32(amp) * (u - np.float32(0.5))
    out[0] = 0.0
    return out


@pytest.mark.parametrize("frame,block_edge", [
    (0, 32), (5, 32), (400000, 32), (2**32 + 7, 8), (13, 64)])
def test_kernel_noise_formula_matches_feature_noise(frame, block_edge):
    """The noise the kernels hash (seed frame term and amplitude from
    noise_params) equals feature_noise bit for bit, also past the seed's
    2**32 wrap (frame 400000 at 13 x 1024)."""
    bp = block_edge * block_edge
    with np.errstate(over="ignore"):
        want = kernel_noise(frame, 10, bp, 13, 0.37)
    got = rng.feature_noise(frame, 10, bp, 13, 0.37).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_build_compiles_and_digests_every_kernel_source():
    """Every ``csrc/*.cu`` is compiled into the library and every
    ``csrc/*.cuh`` counts in its digest, so an edited header rebuilds
    it."""
    from bmfr_tpu_torch.ops import _lib

    assert sorted(_lib.SOURCES) == sorted(
        p.name for p in _lib.CSRC.glob("*.cu"))
    assert sorted(_lib.HEADERS) == sorted(
        p.name for p in _lib.CSRC.glob("*.cuh"))
