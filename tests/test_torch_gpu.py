"""The two CUDA kernels against their plain PyTorch versions on the card,
at a few shapes (including H and W not multiples of 32), and the whole
slice with kernels against the slice with plain versions.

Needs a CUDA device: every test skips without one (decided inside the
``cuda`` fixture, never at import). This file imports no JAX, so it runs
on a machine without it:

    python -m pytest tests/test_torch_gpu.py --noconftest -m gpu
"""

import numpy as np
import pytest
import torch

import bmfr_tpu_torch as bt
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.metrics import psnr
from bmfr_tpu_torch.ops.fitter_direct import (
    fit_reconstruct_cholesky, fit_reconstruct_cholesky_reference)
from bmfr_tpu_torch.ops.gather import floor_int
from bmfr_tpu_torch.ops.reproject import reproject_coords
from bmfr_tpu_torch.ops.warp import pack_pairs_bf16
from bmfr_tpu_torch.ops.warp_blend import warp_blend, warp_blend_reference

pytestmark = pytest.mark.gpu

SHAPES = [(48, 160), (37, 83), (120, 200)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def scene_cfg(H, W):
    return bt.BMFRConfig(image_width=W, image_height=H,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5, **bt.FLAGSHIP)


def scene(H, W, dev, frames=3):
    sc = synthetic_sequence(width=W, height=H, frames=frames)
    inputs = bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                        sc["noisy"], sc["albedo"], dev)
    return (inputs, torch.from_numpy(sc["camera_matrices"]).to(dev),
            torch.from_numpy(sc["pixel_offsets"]).to(dev))


@pytest.mark.parametrize("H,W", SHAPES)
def test_warp_blend_kernel_matches_plain(cuda, H, W):
    cfg = scene_cfg(H, W)
    rng = np.random.default_rng(H * W)
    src8 = pack_pairs_bf16(torch.from_numpy(
        rng.standard_normal((16, H, W)).astype(np.float32) * 0.3).to(cuda))
    cur = torch.from_numpy(
        rng.standard_normal((6, H, W)).astype(np.float32) * 0.3).to(cuda)
    yy = torch.arange(H, device=cuda, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=cuda, dtype=torch.float32)[None, :]
    pfx = (xx * 1.02 - 1.6 + 0.01 * yy).contiguous()
    pfy = (yy * 1.05 + 1.3 - 0.004 * xx).contiguous()
    # saturated reprojections (w -> 0 in reproject_coords): off screen,
    # and their clipped taps must stay inside the state
    extreme = torch.tensor([float("inf"), -float("inf"), 1e30, -1e30])
    pfx[0, :4] = extreme
    pfy[1, :4] = extreme
    n0 = warp_blend.launches
    got = warp_blend(cfg, src8, cur[0:3], cur[3:6], pfx, pfy)
    assert warp_blend.launches == n0 + 1
    want = warp_blend_reference(cfg, src8, cur[0:3], cur[3:6], pfx, pfy)
    torch.cuda.synchronize()
    ix, iy = floor_int(pfx), floor_int(pfy)
    on = ((ix >= -1) & (iy >= -1) & (ix < W) & (iy < H))[None]
    torch.testing.assert_close(torch.where(on, got, 0.0),
                               torch.where(on, want, 0.0),
                               rtol=1e-5, atol=1e-5)
    assert bool((got[5] == want[5]).all())


@pytest.mark.parametrize("H,W", SHAPES)
@pytest.mark.parametrize("frame", [0, 5, 13])
def test_fit_kernel_matches_plain(cuda, H, W, frame):
    cfg = scene_cfg(H, W)
    inputs, _, _ = scene(H, W, cuda, frames=1)
    n, p, a = inputs.normals[0], inputs.positions[0], inputs.noisy[0]
    n0 = fit_reconstruct_cholesky.launches
    got, w = fit_reconstruct_cholesky(cfg, n, p, a, frame)
    assert fit_reconstruct_cholesky.launches == n0 + 1
    want, w_ref = fit_reconstruct_cholesky_reference(cfg, n, p, a, frame)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
    assert torch.equal((w == 0).all(dim=(1, 2)), (w_ref == 0).all(dim=(1, 2)))


def test_slice_kernels_match_plain(cuda):
    H, W = 96, 160
    cfg = scene_cfg(H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=4)
    warp_blend.launches = fit_reconstruct_cholesky.launches = 0
    got = bt.denoise_sequence(cfg, inputs, cams, offs)
    assert (warp_blend.launches, fit_reconstruct_cholesky.launches) == (3, 4)
    want = bt.denoise_sequence(cfg, inputs, cams, offs, plain=True)
    assert (warp_blend.launches, fit_reconstruct_cholesky.launches) == (3, 4)
    got, want = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(got).all()
    for t in range(4):
        assert psnr(got[t], want[t]) >= 70.0


def test_reproject_on_card_matches_cpu(cuda):
    H, W = 48, 64
    cfg = scene_cfg(H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=2)
    got = reproject_coords(cfg, inputs.positions[1], cams[0], offs[1])
    want = reproject_coords(cfg, inputs.positions[1].cpu(), cams[0].cpu(),
                            offs[1].cpu())
    for g, w in zip(got, want):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-6, atol=1e-5)
