"""The CUDA kernels against their plain PyTorch versions on the card, at
a few shapes (including H and W not multiples of 32), the port's paths
with kernels against the same paths with plain versions, and the
compiled step (a replayed CUDA graph) against the eager step, bit for
bit, the metrics and the fidelity sweep on the card against the CPU, and
the default path and the flagship against the NumPy oracle.

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
from bmfr_tpu_torch.ops import fitter, fitter_direct
from bmfr_tpu_torch.ops.blockify import (STORAGE_DTYPES,
                                         build_feature_blocks, jitter_offset)
from bmfr_tpu_torch.ops.fitter_direct import (
    fit_reconstruct_cholesky, fit_reconstruct_cholesky_reference)
from bmfr_tpu_torch.ops.fitter_pallas import (fit_blocks_pallas,
                                              fit_blocks_pallas_reference)
from bmfr_tpu_torch.ops.gather import floor_int, gather_planes
from bmfr_tpu_torch.ops.reproject import noisy_tail, reproject_coords
from bmfr_tpu_torch.ops.tail import filtered_tail
from bmfr_tpu_torch.ops.warp import (add_wrap, pack_pairs_bf16,
                                     pack_x_pairs_bf16, warp_rows)
from bmfr_tpu_torch.ops.warp_blend import (warp_blend, warp_blend_planes,
                                           warp_blend_reference)
from bmfr_tpu_torch.ops.weighted_sum import weighted_sum

pytestmark = pytest.mark.gpu

SHAPES = [(48, 160), (37, 83), (120, 200)]
#: kernel B's shapes: also one of 12 blocks, far fewer than the CTAs an
#: H100 holds at once
FIT_SHAPES = SHAPES + [(64, 96)]


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


@pytest.mark.parametrize("H,W", FIT_SHAPES)
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


@pytest.mark.parametrize("H,W", FIT_SHAPES)
@pytest.mark.parametrize("frame", [0, 5, 13])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_fit_kernel_reduced_precision_matches_plain(cuda, monkeypatch, H, W,
                                                    frame, dtype):
    """Kernel B on f16/bf16 tmp. The normal equations square the
    condition number, and on f16 data the f32 summation order alone moves
    the ill-conditioned edge blocks of a small image: at 37x83 the plain
    version on the card sits 49-59 dB from the exact answer and puts up
    to 0.8% of the values past 5e-3. So the kernel is held to the exact
    answer (the plain version with its Gram sums in f64, on the same
    rounded data): 5e-3 on all but 0.1% of the values, and no less
    accurate than the plain version on the card (within 3 dB)."""
    cfg = scene_cfg(H, W).replace(tmp_data_dtype=dtype)
    inputs, _, _ = scene(H, W, cuda, frames=1)
    n, p, a = inputs.normals[0], inputs.positions[0], inputs.noisy[0]
    n0 = fit_reconstruct_cholesky.launches
    got, w = fit_reconstruct_cholesky(cfg, n, p, a, frame)
    assert fit_reconstruct_cholesky.launches == n0 + 1
    want, w_ref = fit_reconstruct_cholesky_reference(cfg, n, p, a, frame)
    gram = fitter.gram
    monkeypatch.setattr(fitter, "gram",
                        lambda data, F: gram(data.double(), F).float())
    exact, _ = fit_reconstruct_cholesky_reference(cfg, n, p, a, frame)
    torch.cuda.synchronize()
    off = ((got - exact).abs() > 5e-3 + 5e-3 * exact.abs()).float().mean()
    assert float(off) <= 1e-3, float(off)
    got, want, exact = (x.cpu().numpy() for x in (got, want, exact))
    assert psnr(got, exact) >= psnr(want, exact) - 3.0
    assert torch.equal((w == 0).all(dim=(1, 2)), (w_ref == 0).all(dim=(1, 2)))


def planes_with_flat_block(cfg, frame, by, bx, dev):
    """Seeded random normals, positions and colours, except on the image
    footprint of block (by, bx) at frame's jitter: there the normals and
    positions are constant (powers of two, so every Gram sum is exact)
    and the colours vary a little around a constant."""
    r = np.random.default_rng(11)
    H, W = cfg.image_height, cfg.image_width
    n, p = (r.uniform(-1, 1, (3, H, W)).astype(np.float32) for _ in "np")
    a = r.uniform(0, 1, (3, H, W)).astype(np.float32)
    ox, oy = jitter_offset(frame)
    y0, x0 = by * 32 - 16 + oy, bx * 32 - 16 + ox
    assert 0 <= y0 and y0 + 32 <= H and 0 <= x0 and x0 + 32 <= W
    flat = (slice(None), slice(y0, y0 + 32), slice(x0, x0 + 32))
    n[flat] = np.float32([0.5, 0.25, 1.0])[:, None, None]
    p[flat] = np.float32([0.75, -0.5, 0.25])[:, None, None]
    a[flat] = (np.float32([0.3, 0.6, 0.9])[:, None, None]
               + 0.05 * r.standard_normal((3, 32, 32)).astype(np.float32))
    return [torch.from_numpy(x).to(dev) for x in (n, p, a)]


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("noise,singular", [(0.0, True), (1e-3, False)],
                         ids=["singular", "near-degenerate"])
def test_fit_kernel_degenerate_block(cuda, dtype, noise, singular):
    """Kernel B on a block whose features are constant. Without noise its
    Gram has rank 1: the second pivot is exactly 0, the weights NaN, and
    the block's weights are all zero, as in the plain version. With
    noise 1e-3 the noise alone conditions it (weights of norm ~15): the
    reconstruction holds to 5e-3 (the plain version's f32 sums sit ~2e-5
    from f64 ones there)."""
    H, W, frame, by, bx = 96, 160, 5, 1, 2
    cfg = scene_cfg(H, W).replace(tmp_data_dtype=dtype, noise_amount=noise)
    planes = planes_with_flat_block(cfg, frame, by, bx, cuda)
    n0 = fit_reconstruct_cholesky.launches
    got, w = fit_reconstruct_cholesky(cfg, *planes, frame)
    assert fit_reconstruct_cholesky.launches == n0 + 1
    want, w_ref = fit_reconstruct_cholesky_reference(cfg, *planes, frame)
    torch.cuda.synchronize()
    zero = (w == 0).all(dim=(1, 2))
    assert torch.equal(zero, (w_ref == 0).all(dim=(1, 2)))
    assert zero.nonzero().flatten().tolist() == (
        [by * cfg.blocks_x + bx] if singular else [])
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)


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


def random_blocks(cfg, dev, dtype):
    """tests/test_fitter_pallas.py's random blocks, in the storage dtype."""
    r = np.random.RandomState(3)
    data = r.rand(cfg.n_blocks, cfg.buffer_count,
                  cfg.block_pixels).astype(np.float32)
    lo, F = cfg.features_not_scaled_count, cfg.feature_count
    data[:, lo:F, :] = data[:, lo:F, :] * 7.0 - 2.0
    return torch.from_numpy(data).to(dev, STORAGE_DTYPES[dtype])


@pytest.mark.parametrize("block_edge", [8, 16, 24, 32, 48, 64])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_block_fitter_kernel_matches_plain(cuda, dtype, block_edge):
    """Kernel D on tests/test_fitter_pallas.py's random blocks, both
    routes (registers up to block_edge 32, shared memory above); weights
    to the JAX tests' tolerances (2e-3 f32, 5e-3 f16/bf16)."""
    cfg = scene_cfg(120, 200).replace(fitter_impl="auto",
                                      solver="householder",
                                      tmp_data_dtype=dtype,
                                      block_edge=block_edge)
    tmp = random_blocks(cfg, cuda, dtype)
    n0 = fit_blocks_pallas.launches
    w, mm = fit_blocks_pallas(cfg, tmp, 5)
    assert fit_blocks_pallas.launches == n0 + 1
    w_ref, mm_ref = fit_blocks_pallas_reference(cfg, tmp, 5)
    torch.cuda.synchronize()
    tol = 2e-3 if dtype == "float32" else 5e-3
    torch.testing.assert_close(mm, mm_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w, w_ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("block_edge", [16, 64, 8, 32])
@pytest.mark.parametrize("basis", [
    dict(features_not_scaled=("const",), features_scaled=()),
    dict(features_scaled=("world_position_x",)),
    dict(features_not_scaled=("const", "normal_x", "normal_x", "normal_y",
                              "normal_y", "normal_z", "normal_z")),
    dict(features_not_scaled=("const", "normal_x", "normal_y", "normal_z"),
         features_scaled=()),
], ids=["4-columns", "8-columns", "16-columns", "7-columns"])
def test_block_fitter_kernel_custom_basis(cuda, basis, block_edge):
    """Kernel D on custom bases of 4, 7, 8 and 16 columns (16, the most it
    takes, keeps two colour columns in registers at block_edge 64), both
    routes: registers at block_edge 8 (half a warp a block), 16 and 32,
    shared memory at 64. The 16-column basis repeats features, so
    noise_amount 0.5 conditions it."""
    cfg = scene_cfg(120, 200).replace(fitter_impl="auto",
                                      solver="householder", noise_amount=0.5,
                                      block_edge=block_edge, **basis)
    tmp = random_blocks(cfg, cuda, "float32")
    w, mm = fit_blocks_pallas(cfg, tmp, 7)
    w_ref, mm_ref = fit_blocks_pallas_reference(cfg, tmp, 7)
    torch.cuda.synchronize()
    assert w.shape == (cfg.n_blocks, cfg.feature_count, 3)
    torch.testing.assert_close(mm, mm_ref, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(w, w_ref, rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("frame", [3, 400000])
@pytest.mark.parametrize("kernel", ["B", "C", "D"])
def test_kernels_hash_the_noise_as_feature_noise(cuda, kernel, frame):
    """The noise each kernel hashes for itself is feature_noise's, which
    the plain versions add: at noise_amount 0.5 the noise dominates the
    fit, so a wrong hash moves the output far past the tolerance; frame
    400000 is past the seed's 2**32 / (13 * 1024) wrap."""
    H, W = 48, 160
    cfg = scene_cfg(H, W).replace(noise_amount=0.5)
    if kernel == "D":
        cfg = cfg.replace(fitter_impl="auto", solver="householder")
        got, _ = fit_blocks_pallas(cfg, random_blocks(cfg, cuda, "float32"),
                                   frame)
        want, _ = fit_blocks_pallas_reference(
            cfg, random_blocks(cfg, cuda, "float32"), frame)
        tol = 2e-3
    else:
        inputs, _, _ = scene(H, W, cuda, frames=1)
        planes = (inputs.normals[0], inputs.positions[0], inputs.noisy[0])
        if kernel == "B":
            fit, plain = (fit_reconstruct_cholesky,
                          fit_reconstruct_cholesky_reference)
        else:
            cfg = cfg.replace(solver="householder")
            fit, plain = (fitter_direct.fit_reconstruct_direct,
                          fitter_direct.fit_reconstruct_direct_reference)
        got, want = fit(cfg, *planes, frame)[0], plain(cfg, *planes, frame)[0]
        tol = 5e-3
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("H,W", SHAPES[:2] + [(720, 1280)])
@pytest.mark.parametrize("frame", [0, 5, 13])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_direct_householder_kernel_matches_plain(cuda, H, W, frame, dtype):
    """Kernel C through both entries, in each storage mode, also at
    1280x720: the reconstruction to kernel B's pin (5e-3), the
    mins/maxs to 1e-6; f16 and bf16 at 1280x720 as
    test_basis_kernels_match_plain holds reduced precision."""
    cfg = scene_cfg(H, W).replace(solver="householder", tmp_data_dtype=dtype)
    inputs, _, _ = scene(H, W, cuda, frames=1)
    planes = (inputs.normals[0], inputs.positions[0], inputs.noisy[0])
    n0 = fitter_direct.fit_reconstruct_direct.launches
    got, _ = fitter_direct.fit_reconstruct_direct(cfg, *planes, frame)
    assert fitter_direct.fit_reconstruct_direct.launches == n0 + 1
    want, _ = fitter_direct.fit_reconstruct_direct_reference(cfg, *planes,
                                                             frame)
    n0 = fitter_direct.fit_blocks_direct.launches
    w, mm = fitter_direct.fit_blocks_direct(cfg, *planes, frame)
    assert fitter_direct.fit_blocks_direct.launches == n0 + 1
    w_ref, mm_ref = fitter_direct.fit_blocks_direct_reference(cfg, *planes,
                                                              frame)
    torch.cuda.synchronize()
    torch.testing.assert_close(mm, mm_ref, rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(w).all())
    if dtype == "float32" or (H, W) != (720, 1280):
        torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
        return
    # f16/bf16 at 1280x720: single weights of ill-conditioned blocks move
    # with the summation order alone (on f16, 32-79 of the 2.8 M values of
    # one frame's image, all in one row of blocks, lie past 5e-3 of the
    # plain version's), so the weights are held no less exact than the
    # plain version's against the f64 least-squares weights of the same
    # stored system, and the image to 5e-3 on all but 1e-3 of its values
    exact = stored_lstsq(cfg, planes, frame)
    d_got = float((w.double() - exact).norm() / exact.norm())
    d_ref = float((w_ref.double() - exact).norm() / exact.norm())
    assert d_got <= 2 ** 0.5 * d_ref, (d_got, d_ref)
    off = ((got - want).abs() > 5e-3 + 5e-3 * want.abs()).float()
    assert float(off.mean()) <= 1e-3, float(off.mean())


def saturated_field(H, W, dev):
    """Coordinates through both edges plus NaN, +-inf, +-1e30 and +-2**31
    on the first row and column."""
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    pfx = (xx * 1.02 - 1.6 + 0.01 * yy).contiguous()
    pfy = (yy * 1.05 + 1.3 - 0.004 * xx).contiguous()
    extreme = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30,
                            -1e30, 2.0**31, -(2.0**31)], device=dev)
    pfx[0, :7] = extreme
    pfy[1:8, 0] = extreme
    return pfx, pfy


@pytest.mark.parametrize("H,W", SHAPES)
def test_warp_rows_kernel_is_bit_equal(cuda, H, W):
    """Kernel E equals the two clipped gathers on every pixel."""
    r = np.random.default_rng(H + W)
    src = pack_x_pairs_bf16(torch.from_numpy(
        r.standard_normal((16, H, W)).astype(np.float32)).to(cuda))
    pfx, pfy = saturated_field(H, W, cuda)
    ix, iy = floor_int(pfx), floor_int(pfy)
    n0 = warp_rows.launches
    row0, row1 = warp_rows(src, iy, ix)
    assert warp_rows.launches == n0 + 1
    torch.cuda.synchronize()
    assert torch.equal(row0, gather_planes(src, iy, ix))
    assert torch.equal(row1, gather_planes(src, add_wrap(iy, 1), ix))


def test_floor_int_on_card_matches_cpu(cuda):
    x = torch.tensor([float("nan"), float("inf"), -float("inf"), 1e30, -1e30,
                      2.0**31, -(2.0**31), 2147483520.0, 3e9, -3e9, -0.5,
                      -1.0, 1.5, 719.99, -2.0001])
    assert torch.equal(floor_int(x.to(cuda)).cpu(), floor_int(x))


@pytest.mark.parametrize("variant", [
    dict(),                                            # the default path
    dict(bt.FLAGSHIP, solver="householder"),
    dict(warp_mode="packed_x_bf16", tmp_data_dtype="float16"),
])
def test_exact_paths_kernels_match_plain(cuda, variant):
    H, W = 96, 160
    cfg = bt.BMFRConfig(image_width=W, image_height=H,
                        position_limit_squared=0.03,
                        normal_limit_squared=0.5, **variant)
    inputs, cams, offs = scene(H, W, cuda, frames=4)
    got = bt.denoise_sequence(cfg, inputs, cams, offs).cpu().numpy()
    want = bt.denoise_sequence(cfg, inputs, cams, offs,
                               plain=True).cpu().numpy()
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


def exported(tmp_path, H, W, frames, limits=(0.03, 0.5)):
    """The orbit scene exported to ``tmp_path/<limits>`` in the TUNI
    layout; returns (descriptor, the in-memory scene)."""
    from bmfr_tpu_torch.io.dataset import probe_scene
    from bmfr_tpu_torch.io.export import export_scene

    sc = synthetic_sequence(width=W, height=H, frames=frames)
    path = str(tmp_path / f"orbit-{limits[0]:g}")
    export_scene(sc, path, *limits)
    return probe_scene(path), sc


def on_card(sc, dev):
    return (bt.frame_inputs_from_numpy(sc["normals"], sc["positions"],
                                       sc["noisy"], sc["albedo"], dev),
            torch.from_numpy(sc["camera_matrices"]).to(dev),
            torch.from_numpy(sc["pixel_offsets"]).to(dev))


@pytest.mark.parametrize("variant", ["flagship", "default"])
def test_stream_scene_on_card_equals_sequence(cuda, tmp_path, variant):
    """A scene streamed from disk (5 frames, chunks of 2: a ragged last
    chunk) equals denoise_sequence of the same frames bit for bit, and
    launches the path's kernels once per frame."""
    H, W, T = 64, 96, 5
    cfg = scene_cfg(H, W)
    # the stream carries a TemporalState: the flagship warps it with
    # kernel I in packed_bf16, never kernel A
    counters = {"flagship": (warp_blend_planes, fit_reconstruct_cholesky,
                             warp_blend),
                "default": (fit_blocks_pallas,)}[variant]
    if variant == "default":
        cfg = bt.BMFRConfig(image_width=W, image_height=H,
                            position_limit_squared=0.03,
                            normal_limit_squared=0.5)
    sd, sc = exported(tmp_path, H, W, T)
    for fn in counters:
        fn.launches = 0
    got = bt.stream_scene(cfg, sd, chunk_frames=2, device=cuda)
    launches = [fn.launches for fn in counters]
    assert launches == ([T - 1, T, 0] if variant == "flagship" else [T])
    want = bt.denoise_sequence(cfg, *on_card(sc, cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, want)


def test_staged_scene_every_codec_streams_bit_equal(cuda, tmp_path):
    """A 64x48x3 scene staged on the card's host with the EXR codec
    cycled per file (ZIP, ZIPS, PIZ, PXR24, B44) loads as the arrays
    staging returns, and streamed on the card through the flagship equals
    denoise_sequence of those arrays in memory bit for bit."""
    from bmfr_tpu_torch.io.dataset import probe_scene
    from bmfr_tpu_torch.io.staging import stage_scene

    H, W, T = 48, 64, 3
    cfg = scene_cfg(H, W)
    sc = synthetic_sequence(width=W, height=H, frames=T)
    expected = stage_scene(str(tmp_path / "orbit"), sc)
    sd = probe_scene(str(tmp_path / "orbit"))
    data = sd.load_frames()
    for buf, key in (("color", "noisy"), ("shading_normal", "normals"),
                     ("world_position", "positions"), ("albedo", "albedo")):
        np.testing.assert_array_equal(data[key].view(np.uint32),
                                      expected[buf].view(np.uint32))
    warp_blend.launches = warp_blend_planes.launches = 0
    fit_reconstruct_cholesky.launches = 0
    got = bt.stream_scene(cfg, sd, chunk_frames=2, device=cuda)
    assert [warp_blend_planes.launches, fit_reconstruct_cholesky.launches,
            warp_blend.launches] == [T - 1, T, 0]
    inputs = bt.frame_inputs_from_numpy(
        expected["shading_normal"], expected["world_position"],
        expected["color"], expected["albedo"], cuda)
    want = bt.denoise_sequence(
        cfg, inputs, torch.from_numpy(sc["camera_matrices"]).to(cuda),
        torch.from_numpy(sc["pixel_offsets"]).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, want)


def test_stream_scene_full_size_from_memory(cuda):
    """The flagship at 1280x720 over 3 frames from an in-memory loader
    (pageable arrays, pinned by the upload) equals denoise_sequence."""
    H, W, T = 720, 1280, 3
    cfg = scene_cfg(H, W)
    sc = synthetic_sequence(width=W, height=H, frames=T)
    keys = ("normals", "positions", "noisy", "albedo", "camera_matrices",
            "pixel_offsets")
    got = bt.stream_scene(cfg, loader=lambda fr: {k: sc[k][fr] for k in keys},
                          frame_count=T, chunk_frames=2, device=cuda)
    want = bt.denoise_sequence(cfg, *on_card(sc, cuda)).cpu().numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("variant", ["flagship", "default"])
def test_load_state_on_card_resumes_bit_equal(cuda, tmp_path, variant):
    H, W, T = 64, 96, 5
    cfg = scene_cfg(H, W) if variant == "flagship" else bt.BMFRConfig(
        image_width=W, image_height=H, position_limit_squared=0.03,
        normal_limit_squared=0.5)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    want = bt.denoise_sequence(cfg, inputs, cams, offs).cpu().numpy()
    step = bt.make_denoise_frame(cfg)
    state, got = bt.TemporalState.initial(cfg, cuda), []
    for t in range(T):
        if t == 3:
            bt.save_state(str(tmp_path / "s.npz"), state, t)
            state, t0 = bt.load_state(str(tmp_path / "s.npz"))
            assert t0 == 3 and state.spp.device.type == "cuda"
        state, res = step(state, bt.FrameInputs(*(x[t] for x in inputs)),
                          cams[max(t - 1, 0)], offs[t], t)
        got.append(res.cpu().numpy())
    np.testing.assert_array_equal(np.stack(got), want)


def test_stream_scenes_two_streams_equal_single_runs(cuda, tmp_path):
    """Two scenes at once on one card, each on its own stream pair (the
    second with its own discard limit), equal their single runs bit for
    bit: an upload read before its event, or a tensor reused while the
    other stream reads it, would show here."""
    H, W, T = 120, 200, 7
    sd_a, _ = exported(tmp_path, H, W, T)
    sd_b, _ = exported(tmp_path, H, W, T, limits=(1e-8, 0.5))
    cfg = scene_cfg(H, W)
    both = bt.stream_scenes(cfg, [sd_a, sd_b], chunk_frames=3,
                            devices=[cuda])
    single = [bt.stream_scene(cfg.replace(position_limit_squared=lim), sd,
                              chunk_frames=3, device=cuda)
              for lim, sd in ((0.03, sd_a), (1e-8, sd_b))]
    for got, want in zip(both, single):
        np.testing.assert_array_equal(got, want)
    assert np.abs(single[0] - single[1]).max() > 1e-3


# ---- the compiled step (pipeline/graph.py) ----

def path_cfg(path, H, W):
    return bt.BMFRConfig(image_width=W, image_height=H,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5,
                         **{"default": {}, "flagship": bt.FLAGSHIP,
                            "householder_flagship": dict(
                                bt.FLAGSHIP, solver="householder")}[path])


def eager_run(cfg, inputs, cams, offs, state):
    """Every frame through the eager denoise_frame: (results, state)."""
    out = []
    for t in range(inputs.noisy.shape[0]):
        state, o = bt.denoise_frame(cfg, state,
                                    bt.FrameInputs(*(x[t] for x in inputs)),
                                    cams[max(t - 1, 0)], offs[t], t)
        out.append(o["result"].clone())
    return torch.stack(out), state


@pytest.mark.parametrize("path,carry", [
    ("default", "temporal"), ("flagship", "packed"),
    ("flagship", "temporal"), ("householder_flagship", "packed"),
    ("householder_flagship", "temporal")])
def test_compiled_step_equals_eager_bit_for_bit(cuda, path, carry):
    """make_denoise_frame (frame 0 eager, then a captured graph replayed
    for 19 frames) against the eager denoise_frame, bit for bit, in the
    results and the final state."""
    H, W, T = 64, 96, 20
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    initial = (bt.PackedState if carry == "packed"
               else bt.TemporalState).initial
    want, want_state = eager_run(cfg, inputs, cams, offs, initial(cfg, cuda))
    step = bt.make_denoise_frame(cfg)
    state, got = initial(cfg, cuda), []
    for t in range(T):
        state, res = step(state, bt.FrameInputs(*(x[t] for x in inputs)),
                          cams[max(t - 1, 0)], offs[t], t)
        got.append(res)
    assert torch.equal(torch.stack(got), want)
    for a, b in zip(state, want_state):
        assert torch.equal(a, b)


@pytest.mark.parametrize("path", ["default", "flagship"])
def test_denoise_sequence_compiled_equals_eager(cuda, path):
    H, W, T = 48, 160, 6
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    want, _ = eager_run(cfg, inputs, cams, offs, bt.zero_state(cfg, cuda))
    for _ in range(2):    # the capture, then a replay of the cached step
        assert torch.equal(bt.denoise_sequence(cfg, inputs, cams, offs),
                           want)


@pytest.mark.parametrize("path", ["default", "flagship"])
def test_compiled_step_resumes_from_load_state(cuda, tmp_path, path):
    """A state from load_state is copied into the compiled step's carry
    and the run goes on bit-equal to the uninterrupted eager run."""
    H, W, T = 64, 96, 20
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    want, _ = eager_run(cfg, inputs, cams, offs,
                        bt.TemporalState.initial(cfg, cuda))
    step = bt.make_denoise_frame(cfg)
    state, got = bt.TemporalState.initial(cfg, cuda), []
    for t in range(T):
        if t == 11:
            bt.save_state(str(tmp_path / "s.npz"), state, t)
            state, t0 = bt.load_state(str(tmp_path / "s.npz"))
            assert t0 == 11
        state, res = step(state, bt.FrameInputs(*(x[t] for x in inputs)),
                          cams[max(t - 1, 0)], offs[t], t)
        got.append(res)
    assert torch.equal(torch.stack(got), want)


@pytest.mark.parametrize("carry", ["packed", "temporal"])
def test_compiled_step_without_donation_leaves_states_intact(cuda, carry):
    H, W, T = 64, 96, 5
    cfg = path_cfg("flagship", H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    initial = (bt.PackedState if carry == "packed"
               else bt.TemporalState).initial
    want, _ = eager_run(cfg, inputs, cams, offs, initial(cfg, cuda))
    step = bt.make_denoise_frame(cfg, donate=False)
    state, kept, got = initial(cfg, cuda), [], []
    for t in range(T):
        state, res = step(state, bt.FrameInputs(*(x[t] for x in inputs)),
                          cams[max(t - 1, 0)], offs[t], t)
        kept.append((state, [x.clone() for x in state]))
        got.append(res)
    assert torch.equal(torch.stack(got), want)
    for st, copy in kept:
        for a, b in zip(st, copy):
            assert torch.equal(a, b)
    # a state from the middle steps again to the same frame
    again, res = step(kept[2][0], bt.FrameInputs(*(x[3] for x in inputs)),
                      cams[2], offs[3], 3)
    assert torch.equal(res, want[3])


@pytest.mark.parametrize("path,counters", [
    ("flagship", {"warp_blend": warp_blend,
                  "fit_reconstruct_cholesky": fit_reconstruct_cholesky}),
    ("default", {"fit_blocks_pallas": fit_blocks_pallas,
                 "warp_rows": warp_rows,
                 "warp_blend_planes": warp_blend_planes,
                 "build_feature_blocks": build_feature_blocks,
                 "weighted_sum": weighted_sum}),
    ("householder_flagship", {
        "warp_blend": warp_blend,
        "fit_reconstruct_direct": fitter_direct.fit_reconstruct_direct})])
def test_replays_advance_the_launch_counters(cuda, path, counters):
    """Each replay adds the captured step's launches; the capture adds
    none: denoise_sequence counts as the eager loop does, at its first
    call (which captures) and at a later one (which replays only)."""
    from bmfr_tpu_torch.pipeline.graph import compiled_step

    H, W, T = 48, 160, 7
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    warped = 0 if path == "default" else T - 1
    expected = {"warp_blend": warped, "warp_rows": 0,
                "fit_reconstruct_cholesky": T, "fit_reconstruct_direct": T,
                "fit_blocks_pallas": T, "warp_blend_planes": T - 1,
                "build_feature_blocks": T, "weighted_sum": T}
    compiled_step.cache_clear()
    for _ in range(2):
        for fn in counters.values():
            fn.launches = 0
        bt.denoise_sequence(cfg, inputs, cams, offs)
        assert {k: fn.launches for k, fn in counters.items()} == {
            k: expected[k] for k in counters}


@pytest.mark.parametrize("path,carry", [("flagship", "packed"),
                                        ("default", "temporal")])
def test_compiled_step_spans_and_copies(cuda, path, carry):
    """Over 20 replayed frames the ``copies`` counter advances 2 a frame
    (the load's frame fill, the result's copy) and ``inputs_in_place`` 6
    (the frame's inputs, read where they lie), and each frame records
    ``entry.step`` around ``step.run`` (around ``step.load`` and
    ``step.replay``) and ``entry.clone`` once."""
    from bmfr_tpu_torch import profiling

    H, W, T = 48, 64, 22
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    initial = (bt.PackedState if carry == "packed"
               else bt.TemporalState).initial
    step = bt.make_denoise_frame(cfg)
    state = initial(cfg, cuda)

    def frame(t):
        return (bt.FrameInputs(*(x[t] for x in inputs)), cams[max(t - 1, 0)],
                offs[t], t)

    for t in range(2):      # frame 0 eagerly, frame 1 captures
        state, _ = step(state, *frame(t))
    before = profiling.counters()["copies"]
    read = profiling.counters()["inputs_in_place"]
    with profiling.recording() as rec:
        for t in range(2, T):
            state, _ = step(state, *frame(t))
    torch.cuda.synchronize()
    assert profiling.counters()["copies"] - before == 2 * (T - 2)
    assert profiling.counters()["inputs_in_place"] - read == 6 * (T - 2)
    assert rec.dropped == 0 and None not in rec.records
    assert sorted({r[4] for r in rec.records}) == list(range(2, T))
    for t in range(2, T):
        mine = {r[0]: (i, r[3]) for i, r in enumerate(rec.records)
                if r[4] == t}
        assert len(mine) == sum(r[4] == t for r in rec.records) == 5
        parent = {name: p for name, (_, p) in mine.items()}
        index = {name: i for name, (i, _) in mine.items()}
        assert parent == {"entry.step": None,
                          "step.run": index["entry.step"],
                          "entry.clone": index["entry.step"],
                          "step.load": index["step.run"],
                          "step.replay": index["step.run"]}


def test_compiled_step_takes_a_tensor_frame(cuda):
    H, W, T = 64, 96, 4
    cfg = path_cfg("default", H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    want, _ = eager_run(cfg, inputs, cams, offs, bt.zero_state(cfg, cuda))
    step = bt.make_denoise_frame(cfg)
    state, got = bt.zero_state(cfg, cuda), []
    for t in range(T):
        frame = torch.tensor(t, dtype=torch.int32, device=cuda)
        state, res = step(state, bt.FrameInputs(*(x[t] for x in inputs)),
                          cams[max(t - 1, 0)], offs[t], frame,
                          history="always" if t else "never")
        got.append(res)
    assert torch.equal(torch.stack(got), want)


@pytest.mark.parametrize("carry", ["packed", "temporal"])
def test_step_object_runs_frame_zero_eagerly(cuda, monkeypatch, carry):
    """Frame 0 handed to the step object on the card (a host int, and a
    tensor frame with ``history="never"``), before its capture and after
    it, equals the eager denoise_frame bit for bit and launches no
    replay; frame 1 replays."""
    from bmfr_tpu_torch.pipeline.graph import CompiledStep

    H, W = 64, 96
    cfg = path_cfg("flagship", H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=2)
    initial = (bt.PackedState if carry == "packed"
               else bt.TemporalState).initial
    args = [(bt.FrameInputs(*(x[t] for x in inputs)), cams[0], offs[t], t)
            for t in range(2)]
    want_state, want = bt.denoise_frame(cfg, initial(cfg, cuda), *args[0])
    replays = []
    replay = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda g: replays.append(g) or replay(g))
    step = CompiledStep(cfg)
    zero = torch.zeros((), dtype=torch.int32, device=cuda)
    for captured in (False, True):
        for frame, history in ((0, None), (zero, "never")):
            state, out = step.run(initial(cfg, cuda), *args[0][:3], frame,
                                  history)
            assert not step.replayed and replays == []
            assert torch.equal(out["result"], want["result"])
            for a, b in zip(state, want_state):
                assert torch.equal(a, b)
        assert bool(step.capture_seconds) is captured
        step.run(state, *args[1])       # frame 1: the capture, no replay
    assert step.replayed and len(replays) == 1


def test_capture_raises_on_a_host_read(cuda):
    """A step that reads the card on the host cannot be captured: the
    capture raises, and nothing runs eagerly in its place."""
    from bmfr_tpu_torch.pipeline.graph import capture

    x = torch.ones(8, device=cuda)
    with pytest.raises(RuntimeError):
        capture(lambda: x.sum().item(), cuda)
    torch.cuda.synchronize()
    assert float((x + 1).sum()) == 16.0


@pytest.mark.parametrize("shape", [(96, 128, 3), (3, 96, 128), (96, 128)],
                         ids=["hwc", "chw", "2d"])
def test_metrics_on_card_match_cpu(cuda, shape):
    from bmfr_tpu_torch.metrics import ssim

    r = np.random.RandomState(len(shape))
    a = torch.from_numpy(r.rand(*shape).astype(np.float32))
    b = (a + 0.05 * torch.from_numpy(r.randn(*shape).astype(np.float32))
         ).clamp(0, 1)
    assert ssim(a.to(cuda), b.to(cuda)) == pytest.approx(ssim(a, b),
                                                         abs=1e-9)
    assert psnr(a.to(cuda), b.to(cuda)) == pytest.approx(psnr(a, b),
                                                         abs=1e-9)


def test_run_sweep_on_card_matches_cpu(cuda):
    from bmfr_tpu_torch.fidelity import run_sweep, synthetic_scenes

    scenes = synthetic_scenes(128, 96, 2)
    base = bt.BMFRConfig(image_width=128, image_height=96,
                         position_limit_squared=0.03,
                         normal_limit_squared=0.5)
    got = run_sweep(scenes, base, device=cuda)
    want = run_sweep(scenes, base, device="cpu")
    assert len(got) == len(want) == 44
    for g, w in zip(got, want):
        assert (g["scene"], g["config"]) == (w["scene"], w["config"])
        assert g["noisy_psnr"] == w["noisy_psnr"]
        for key in ("psnr_mean", "psnr_first", "psnr_last"):
            assert g[key] == pytest.approx(w[key], abs=0.02), (w, key)
        assert g["ssim_mean"] == pytest.approx(w["ssim_mean"], abs=1e-3)


@pytest.mark.parametrize("path", ["default", "flagship"])
def test_paths_meet_the_oracle_on_card(cuda, path):
    from bmfr_tpu_torch import parity

    cfg = bt.BMFRConfig(image_width=72, image_height=48,
                        position_limit_squared=0.03,
                        normal_limit_squared=0.5)
    sc = synthetic_sequence(width=72, height=48, frames=4, scene="swing")
    oracle = parity.oracle_frames(cfg, sc)
    if path == "default":
        port = parity.port_frames(cfg, sc, cuda)
        for p, o in zip(port, oracle):
            rec = parity.compare(p, o)
            assert parity.default_faults(rec) == [], rec
        return
    port = parity.port_frames(cfg.replace(**bt.FLAGSHIP), sc, cuda)
    bf16 = parity.oracle_frames(cfg, sc, round_state=parity.bf16_round)
    assert parity.flagship_faults(
        [parity.compare(p, o) for p, o in zip(port, oracle)],
        [parity.compare(p, o) for p, o in zip(port, bf16)]) == []


#: bases of 4, 7, 10 (first order) and 16 columns for kernels B and C;
#: the 16-column one adds three cross terms registered for the test
CROSS = {"gpu_test_position_xy": lambda n, p: p[0] * p[1],
         "gpu_test_position_yz": lambda n, p: p[1] * p[2],
         "gpu_test_normal_xz": lambda n, p: n[0] * n[2]}
BASES = {
    "4-columns": dict(features_not_scaled=("const",), features_scaled=()),
    "7-columns": dict(features_not_scaled=("const", "normal_x", "normal_y",
                                           "normal_z"), features_scaled=()),
    "first_order": dict(features_scaled=(
        "world_position_x", "world_position_y", "world_position_z")),
    "16-columns": dict(features_scaled=(
        "world_position_x", "world_position_y", "world_position_z",
        "world_position_x2", "world_position_y2", "world_position_z2",
        *CROSS)),
}


@pytest.fixture
def cross_features():
    from bmfr_tpu_torch import features

    for name, fn in CROSS.items():
        features.register_feature(name, fn)
    yield
    for name in CROSS:
        features.FEATURE_REGISTRY.pop(name, None)


def stored_lstsq(cfg, planes, frame):
    """The f64 least-squares weights of the rescaled, rounded, noised
    system the fitters solve from ``planes`` at ``frame``."""
    from bmfr_tpu_torch.ops.blockify import build_feature_blocks
    from bmfr_tpu_torch.rng import feature_noise

    F = cfg.feature_count
    tmp = build_feature_blocks(cfg, *planes, frame)
    data, _ = fitter.scale_blocks(cfg, tmp.float())
    data = fitter.storage_roundtrip(cfg, data)
    noise = feature_noise(frame, F, cfg.block_pixels, cfg.buffer_count,
                          cfg.noise_amount, data.device)
    A = (data[:, :F] + noise[None]).transpose(1, 2).double()
    b = data[:, F:].transpose(1, 2).double()
    return torch.linalg.lstsq(A, b).solution


@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("basis", list(BASES))
@pytest.mark.parametrize("kernel", ["B", "C"])
def test_basis_kernels_match_plain(cuda, monkeypatch, cross_features, kernel,
                                   basis, dtype):
    """Kernels B and C on bases other than the default one (the basis
    front: the registry's planes staged through the mirrored, jittered
    addressing), at 120x200 (W not a multiple of 32), against their plain
    versions: the reconstruction to 5e-3 (B on f16/bf16 tmp held to the
    exact answer as test_fit_kernel_reduced_precision_matches_plain holds
    it), C's blocks entry: mins/maxs to 1e-6, weights to 2e-3 on f32
    tmp and no less exact than the plain version's on f16/bf16."""
    H, W, frame = 120, 200, 5
    cfg = scene_cfg(H, W).replace(tmp_data_dtype=dtype, **BASES[basis])
    inputs, _, _ = scene(H, W, cuda, frames=1)
    planes = (inputs.normals[0], inputs.positions[0], inputs.noisy[0])
    if kernel == "B":
        fit, plain = (fit_reconstruct_cholesky,
                      fit_reconstruct_cholesky_reference)
    else:
        cfg = cfg.replace(solver="householder")
        fit, plain = (fitter_direct.fit_reconstruct_direct,
                      fitter_direct.fit_reconstruct_direct_reference)
    n0 = fit.launches
    got, w = fit(cfg, *planes, frame)
    assert fit.launches == n0 + 1
    assert w.shape == (cfg.n_blocks, cfg.feature_count, 3)
    want, w_ref = plain(cfg, *planes, frame)
    torch.cuda.synchronize()
    assert torch.equal((w == 0).all(dim=(1, 2)), (w_ref == 0).all(dim=(1, 2)))
    if kernel == "B" and dtype != "float32":
        gram = fitter.gram
        monkeypatch.setattr(fitter, "gram",
                            lambda data, F: gram(data.double(), F).float())
        exact, _ = plain(cfg, *planes, frame)
        off = ((got - exact).abs() > 5e-3 + 5e-3 * exact.abs()).float()
        assert float(off.mean()) <= 1e-3, float(off.mean())
        got, want, exact = (x.cpu().numpy() for x in (got, want, exact))
        # both capped at the f32 rounding of values near 1 (140 dB): two
        # answers there are equally exact
        assert (min(psnr(got, exact), 140.0)
                >= min(psnr(want, exact), 140.0) - 3.0)
        return
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
    if kernel == "C":
        w, mm = fitter_direct.fit_blocks_direct(cfg, *planes, frame)
        w_ref, mm_ref = fitter_direct.fit_blocks_direct_reference(
            cfg, *planes, frame)
        torch.cuda.synchronize()
        assert mm.shape == (cfg.n_blocks, cfg.features_scaled_count, 2)
        torch.testing.assert_close(mm, mm_ref, rtol=1e-6, atol=1e-6)
        if dtype == "float32":
            torch.testing.assert_close(w, w_ref, rtol=2e-3, atol=2e-3)
            return
        # reduced precision: single weights of ill-conditioned blocks move
        # with the summation order alone, so the kernel's are held to be
        # no less exact than the plain version's (3 dB) against the f64
        # least-squares weights of the same stored system
        exact = stored_lstsq(cfg, planes, frame)
        d_got = float((w.double() - exact).norm() / exact.norm())
        d_ref = float((w_ref.double() - exact).norm() / exact.norm())
        assert d_got <= 2 ** 0.5 * d_ref, (d_got, d_ref)


@pytest.mark.parametrize("kernel", ["B", "C"])
def test_reregistered_default_feature_on_card(cuda, kernel):
    """``normal_x`` registered anew (as -n[0]) on the default basis: the
    name no longer holds its built-in function, so kernels B and C take
    the basis front (``basis_plan``) and stage the registry's plane, and
    equal their plain versions, which evaluate the registry, at the
    tolerances above. Before the plan chose by the names alone, the
    kernels computed the built-in +n[0] on the card. The registry is
    restored after."""
    from bmfr_tpu_torch import features

    H, W, frame = 120, 200, 5
    cfg = scene_cfg(H, W).replace(
        solver="cholesky" if kernel == "B" else "householder")
    inputs, _, _ = scene(H, W, cuda, frames=1)
    planes = (inputs.normals[0], inputs.positions[0], inputs.noisy[0])
    fit, plain = ((fit_reconstruct_cholesky,
                   fit_reconstruct_cholesky_reference) if kernel == "B" else
                  (fitter_direct.fit_reconstruct_direct,
                   fitter_direct.fit_reconstruct_direct_reference))
    builtin_img, _ = fit(cfg, *planes, frame)
    builtin = features.FEATURE_REGISTRY["normal_x"]
    features.register_feature("normal_x", lambda n, p: -n[0])
    try:
        plan = fitter_direct.basis_plan(cfg)
        assert not plan.default and plan.planes == ("normal_x",)
        n0 = fit.launches
        got, w = fit(cfg, *planes, frame)
        assert fit.launches == n0 + 1
        want, w_ref = plain(cfg, *planes, frame)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
        assert torch.equal((w == 0).all(dim=(1, 2)),
                           (w_ref == 0).all(dim=(1, 2)))
        # the override moves the image: the built-in basis is not the answer
        assert float((builtin_img - want).abs().max()) > 5e-3
        if kernel == "C":
            w, mm = fitter_direct.fit_blocks_direct(cfg, *planes, frame)
            w_ref, mm_ref = fitter_direct.fit_blocks_direct_reference(
                cfg, *planes, frame)
            torch.cuda.synchronize()
            torch.testing.assert_close(mm, mm_ref, rtol=1e-6, atol=1e-6)
            torch.testing.assert_close(w, w_ref, rtol=2e-3, atol=2e-3)
    finally:
        features.FEATURE_REGISTRY["normal_x"] = builtin
    assert fitter_direct.basis_plan(cfg).default


@pytest.mark.parametrize("places", [1, 2])
@pytest.mark.parametrize("path", ["default", "flagship"])
def test_scenes_on_card_equal_per_scene(cuda, path, places):
    """Four scenes through the scene-parallel entry, on one place of the
    card or two (the card named twice: two threads, two compiled steps),
    equal their per-scene denoise_sequence bit for bit; each replay of a
    card's graph counts every scene's launches."""
    H, W, T, S = 48, 160, 4, 4
    cfg = path_cfg(path, H, W)
    frames = [scene(H, W, cuda, frames=T)]
    sc = synthetic_sequence(width=W, height=H, frames=T, seed=3,
                            scene="corridor")
    frames.append((bt.frame_inputs_from_numpy(
        sc["normals"], sc["positions"], sc["noisy"], sc["albedo"], cuda),
        torch.from_numpy(sc["camera_matrices"]).to(cuda),
        torch.from_numpy(sc["pixel_offsets"]).to(cuda)))
    r = np.random.default_rng(7)
    inputs = bt.FrameInputs(*(torch.stack(
        [frames[0][0][k], frames[1][0][k],
         torch.from_numpy(r.random((T, 3, H, W), np.float32)).to(cuda),
         frames[0][0][k].flip(-1).contiguous()]) for k in range(4)))
    cams = torch.stack([frames[0][1], frames[1][1], frames[0][1],
                        frames[1][1]])
    offs = torch.stack([frames[0][2]] * 2 + [frames[1][2]] * 2)
    want = torch.stack([bt.denoise_sequence(
        cfg, bt.FrameInputs(*(x[s] for x in inputs)), cams[s], offs[s])
        for s in range(S)])
    counter = (fit_blocks_pallas if path == "default"
               else fit_reconstruct_cholesky)
    counter.launches = 0
    got = bt.denoise_scenes_sharded(cfg, bt.make_scene_mesh([cuda] * places),
                                    inputs, cams, offs)
    assert counter.launches == S * T
    assert got.device == want.device
    assert torch.equal(got, want)


def test_interleaved_scenes_on_card_keep_their_own_carry(cuda):
    """Two scenes of one card stepped in one graph, then again in the other
    order through the same runner: each equals its own denoise_sequence,
    so no carry serves two scenes."""
    H, W, T = 64, 96, 5
    cfg = scene_cfg(H, W)
    a, b = scene(H, W, cuda, frames=T), scene(W, H, cuda, frames=T)
    b = (bt.FrameInputs(*(x.transpose(-1, -2).contiguous() for x in b[0])),
         b[1], b[2])
    inputs = bt.FrameInputs(*(torch.stack([x, y]) for x, y in
                              zip(a[0], b[0])))
    cams, offs = torch.stack([a[1], b[1]]), torch.stack([a[2], b[2]])
    want = torch.stack([bt.denoise_sequence(
        cfg, bt.FrameInputs(*(x[s] for x in inputs)), cams[s], offs[s])
        for s in range(2)])
    assert not torch.equal(want[0], want[1])
    run = bt.denoise_scenes_jit(cfg, bt.make_scene_mesh([cuda]))
    assert torch.equal(run(inputs, cams, offs), want)
    swap = [1, 0]
    assert torch.equal(run(bt.FrameInputs(*(x[swap] for x in inputs)),
                           cams[swap], offs[swap]), want[swap])


def test_dryrun_multichip_on_card(cuda):
    from bmfr_tpu_torch import graft_entry

    assert graft_entry.dryrun_multichip(1) == [0.0, 0.0, 0.0]
    assert graft_entry.dryrun_multichip(4, devices=[cuda] * 4) == [0.0] * 3


def test_entry_runs_captured_on_card(cuda):
    """graft_entry.entry()'s step: its capture and a replay both equal the
    eager denoise_frame bit for bit."""
    from bmfr_tpu_torch import graft_entry

    fn, args = graft_entry.entry()
    eager = bt.denoise_frame(graft_entry.entry_config(), *args,
                             history="always")[1]["result"]
    for _ in range(2):
        state, result = fn(*args)
        assert torch.equal(result, eager)
    assert isinstance(state, bt.TemporalState)


#: the keys of ``bench.py``'s result line (``tests/test_torch_bench.py``
#: holds the port's bench to ``bench.py``'s source)
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "spread_ms",
              "reps_ms", "config", "device_span_ms_per_frame",
              "warp_kernel_served_pct", "warp_fallback_frames")


def test_bench_on_card(cuda):
    """The bench's path at 1280x720x8: every run's launches held to A 7
    and B 8, H, G and F 8 each, and its checksum to the first run's (inside ``run_bench``),
    the output finite and equal to ``denoise_sequence``'s, the record's
    keys, and the device numbers measured."""
    import io

    from bmfr_tpu_torch import bench

    cfg = scene_cfg(720, 1280)
    inputs, cams, offs = scene(720, 1280, cuda, frames=8)
    record, out, launches = bench.run_bench(cfg, inputs, cams, offs, reps=2,
                                            log=io.StringIO())
    assert launches == {**dict.fromkeys(bench.COUNTERS, 0),
                        "warp_blend": 7, "fit_reconstruct_cholesky": 8,
                        "reproject_coords": 8, "noisy_tail": 8,
                        "filtered_tail": 8}
    assert {k: fn.launches for k, fn in bench.COUNTERS.items()} == launches
    assert bool(torch.isfinite(out).all())
    assert torch.equal(out, bt.denoise_sequence(cfg, inputs, cams, offs))
    assert set(record) == set(BENCH_KEYS) | set(bench.ADDED_KEYS)
    assert record["metric"] == "denoise_ms_per_frame_1280x720"
    assert record["device"] != "cpu" and len(record["reps_ms"]) == 2
    for key in ("value", "device_span_ms_per_frame", "busy_ms_per_frame",
                "steady_ms_per_frame"):
        assert record[key] > 0, key
    assert record["busy_ms_per_frame"] <= record["device_span_ms_per_frame"]
    assert record["warp_kernel_served_pct"] == 100.0
    assert record["warp_fallback_frames"] == 0


def test_bench_profiled_run_holds_every_launch(cuda, monkeypatch):
    """The bench's profiled run (``bench.profiled_run`` of
    ``bench.sequence_run``) on a 1280x720x4 flagship sequence: the trace
    it returns busy and span from holds, inside the run's range, one
    device event of the port's kernels per launch of the run, kernel by
    kernel, and busy and span are those range's events'."""
    import io
    from collections import Counter

    from bmfr_tpu_torch import bench
    from bmfr_tpu_torch.ops import _lib
    from bmfr_tpu_torch.profiling import RUN_RANGE, device_events

    T = 4
    cfg = scene_cfg(720, 1280)
    inputs, cams, offs = scene(720, 1280, cuda, frames=T)
    bt.denoise_sequence(cfg, inputs, cams, offs)    # the capture, untraced
    traced = []

    def spy(*args, **kwargs):
        traced.append(checked_trace(*args, **kwargs))
        return traced[-1]

    checked_trace = bench.checked_trace
    monkeypatch.setattr(bench, "checked_trace", spy)
    expected = bench.expected_launches(cfg, T)
    log = io.StringIO()
    span, busy = bench.profiled_run(
        *bench.sequence_run(cfg, inputs, cams, offs), cuda, T, expected, log)
    (events,) = traced
    work = device_events(events, within=RUN_RANGE)
    ours = Counter(k for e in work for k in _lib.KERNELS if k in e.name)
    assert sum(ours.values()) == sum(expected.values())
    assert ours["warp_blend_kernel"] == T - 1
    for kernel in ("fit_chol_kernel", "reproject_kernel", "noisy_tail_kernel"):
        assert ours[kernel] == T, (kernel, ours)
    assert busy == pytest.approx(
        sum(e.time_range.elapsed_us() for e in work) / T / 1e3)
    assert span == pytest.approx(
        (max(e.time_range.end for e in work)
         - min(e.time_range.start for e in work)) / T / 1e3)
    assert 0 < busy <= span
    assert (f"device events of the port's kernels for "
            f"{sum(expected.values())} launches counted") in log.getvalue()


# ---- kernels F, G and H (the stages XLA fuses in the TPU step) ----

#: odd sizes, a row, a column and sizes under kernel F's 32x16 tile (its
#: ring filled by the threads' loads: W % 4 != 0), and TMA-fed shapes
#: whose last tiles are partial in both directions
TAIL_SHAPES = [(37, 53), (1, 77), (45, 1), (2, 3), (120, 200), (100, 332)]


def same_values(a, b):
    """Equal as values (``-0 == +0``), NaN where NaN: the plain version's
    NaNs and the kernel's are the card's canonical NaN, but a zero's sign
    may come from max's choice between equal operands."""
    return bool(((a == b) | (a.isnan() & b.isnan())).all())


def tail_planes(H, W, dev, seed):
    """13 blend planes as kernel A writes them: zero total weight on some
    pixels, accept bits 0..15, spp sums that saturate the u8 spp."""
    rng = np.random.default_rng(seed)
    tw = rng.random((H, W)).astype(np.float32)
    tw[rng.random((H, W)) < 0.2] = 0.0
    k5w = rng.random((H, W)).astype(np.float32)
    k5w[rng.random((H, W)) < 0.1] = 0.0
    spp = rng.integers(1, 300, (H, W)).astype(np.float32)
    planes = np.concatenate([
        tw * rng.random((3, H, W)), (tw * spp)[None], tw[None],
        rng.integers(0, 16, (1, H, W)), tw * rng.random((3, H, W)),
        k5w * rng.standard_normal((3, H, W)), k5w[None]], axis=0)
    return torch.from_numpy(planes.astype(np.float32)).to(dev)


def with_extremes(t, seed):
    """``t`` with NaN, +-inf and huge values sprinkled over ~3 % of it."""
    rng = np.random.default_rng(seed)
    flat = t.clone().reshape(-1)
    idx = rng.choice(flat.numel(), max(1, flat.numel() // 30), replace=False)
    vals = np.array([np.nan, np.inf, -np.inf, 1e30, -1e30, 2.0**31],
                    np.float32)
    flat[torch.from_numpy(idx).to(t.device)] = torch.from_numpy(
        vals[rng.integers(0, len(vals), idx.size)]).to(t.device)
    return flat.reshape(t.shape)


@pytest.mark.parametrize("H,W", TAIL_SHAPES)
@pytest.mark.parametrize("history", ["always", "never"])
def test_reproject_kernel_is_bit_equal(cuda, H, W, history):
    """Kernel H against its plain version on the card: bit for bit (kernel
    A's accept bits compare pfx/pfy against limits), also where a
    position is NaN or infinite."""
    from bmfr_tpu_torch.ops.reproject import reproject_coords_reference

    cfg = scene_cfg(H, W)
    rng = np.random.default_rng(H * W)
    pos = with_extremes(torch.from_numpy(
        rng.standard_normal((3, H, W)).astype(np.float32)).to(cuda), 1)
    cam = torch.from_numpy(rng.standard_normal((4, 4)).astype(
        np.float32)).to(cuda)
    off = torch.tensor([0.3, 0.7], device=cuda)
    n0 = reproject_coords.launches
    got = reproject_coords(cfg, pos, cam, off, history)
    assert reproject_coords.launches == n0 + 1
    want = reproject_coords_reference(cfg, pos, cam, off, history)
    torch.cuda.synchronize()
    assert got.shape == (2, H, W)
    assert same_values(got, want)


@pytest.mark.parametrize("H,W", TAIL_SHAPES)
@pytest.mark.parametrize("frame", [0, 3])
@pytest.mark.parametrize("carry", ["packed", "temporal"])
def test_noisy_tail_kernel_is_bit_equal(cuda, H, W, frame, carry):
    """Kernel G against its plain version: accum, spp (saturating at
    255) and accept bit for bit, and with a packed carry words 0:5 equal
    and words 5:8 untouched; NaN and infinities in the noisy colour."""
    from bmfr_tpu_torch.ops.reproject import noisy_tail_reference

    cfg = scene_cfg(H, W)
    rng = np.random.default_rng(H + W + frame)
    planes = tail_planes(H, W, cuda, frame)
    cur = torch.from_numpy(rng.standard_normal((9, H, W)).astype(
        np.float32)).to(cuda)
    noisy = with_extremes(cur[6:9].abs(), 2)
    pp = torch.zeros((2, H, W), device=cuda)
    packs = [None, None]
    if carry == "packed":
        base = torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, (8, H, W), dtype=np.int64).astype(
                np.int32)).to(cuda)
        packs = [base.clone(), base.clone()]
    n0 = noisy_tail.launches
    got = noisy_tail(cfg, noisy, pp, planes, cur[0:3], cur[3:6], frame,
                        pack=packs[0])
    assert noisy_tail.launches == n0 + 1
    want = noisy_tail_reference(cfg, noisy, pp, planes, cur[0:3], cur[3:6],
                                frame, pack=packs[1])
    torch.cuda.synchronize()
    assert same_values(got["accum"], want["accum"])
    assert torch.equal(got["spp"], want["spp"])
    assert torch.equal(got["accept"], want["accept"])
    if frame and H * W > 100:
        assert bool((got["spp"] == 255).any())
    if carry == "packed":
        assert torch.equal(packs[0], packs[1])
        assert torch.equal(packs[0][5:8], base[5:8])


def filtered_tail_case(H, W, dev, residual, case, carry):
    """Kernel F's arguments ``(cfg, filtered, planes, albedo, spp, pp,
    frame)`` and, with a packed carry, the words it starts from: NaN and
    infinities in the filtered colour and in prev_pixels, a field that
    leaves the screen on every side."""
    skips = {"skip_taa": dict(skip_taa=True),
             "skip_second_accum": dict(skip_second_accum=True)}.get(case, {})
    cfg = scene_cfg(H, W).replace(residual_dtype=residual, **skips)
    frame = 0 if case == "frame 0" else 3
    rng = np.random.default_rng(H * W + frame)
    planes = tail_planes(H, W, dev, frame + 1)
    filtered = with_extremes(torch.from_numpy(
        rng.random((3, H, W)).astype(np.float32) * 2).to(dev), 3)
    albedo = torch.from_numpy(rng.random((3, H, W)).astype(
        np.float32)).to(dev)
    spp = torch.from_numpy(rng.integers(1, 256, (H, W)).astype(
        np.uint8)).to(dev)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    pp = with_extremes(torch.stack([
        (xx * 1.1 - 2.5 + 0.1 * yy).expand(H, W),
        (yy * 1.2 - 2.5 - 0.05 * xx).expand(H, W)]).contiguous(), 4)
    base = None
    if carry == "packed":
        base = torch.from_numpy(rng.integers(
            -2**31, 2**31 - 1, (8, H, W), dtype=np.int64).astype(
                np.int32)).to(dev)
    return (cfg, filtered, planes, albedo, spp, pp, frame), base


def check_filtered_tail(args, base):
    """Kernel F on ``args`` (and a copy of the words ``base``) against
    its plain version: out, tone and result equal as values (NaN where
    NaN), words 5:8 bit for bit, words 0:5 untouched, one launch."""
    from bmfr_tpu_torch.ops.tail import filtered_tail_reference

    packs = [None, None] if base is None else [base.clone(), base.clone()]
    n0 = filtered_tail.launches
    got = filtered_tail(*args, pack=packs[0])
    assert filtered_tail.launches == n0 + 1
    want = filtered_tail_reference(*args, pack=packs[1])
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "tone", "result"), got, want):
        assert same_values(g, w), name
    if base is not None:
        assert torch.equal(packs[0], packs[1])
        assert torch.equal(packs[0][0:5], base[0:5])


@pytest.mark.parametrize("H,W", TAIL_SHAPES)
@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["frame 0", "frame 3", "skip_taa",
                                  "skip_second_accum"])
@pytest.mark.parametrize("carry", ["packed", "temporal"])
def test_filtered_tail_kernel_is_bit_equal(cuda, H, W, residual, case,
                                           carry):
    """Kernel F against its plain version: out, tone and result equal as
    values (NaN where NaN), words 5:8 bit for bit and words 0:5
    untouched; NaN and infinities in the filtered colour and in
    prev_pixels (XLA's floor: NaN -> 0, saturating) and at the borders
    of every shape, down to a single row or column."""
    check_filtered_tail(*filtered_tail_case(H, W, cuda, residual, case,
                                            carry))


def test_filtered_tail_kernel_wraps_its_ring(cuda):
    """The packed flagship case at 1280x720: 1800 tiles, several times
    the persistent CTAs, so every CTA wraps its TMA ring."""
    check_filtered_tail(*filtered_tail_case(720, 1280, cuda, "bfloat16",
                                            "frame 3", "packed"))


def f_kernel_names(args, pack):
    """The device kernels one call of kernel F launches (torch.profiler,
    the call once before the traced range: a trace loses its run's first
    kernel otherwise)."""
    from torch.profiler import ProfilerActivity

    from bmfr_tpu_torch.profiling import RUN_RANGE, device_events, traced_run

    def run():
        filtered_tail(*args, pack=pack)

    torch.cuda.synchronize()
    with traced_run([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    warm=run) as prof:
        run()
        torch.cuda.synchronize()
    return [e.name for e in device_events(prof.events(), within=RUN_RANGE)]


@pytest.mark.parametrize("residual", ["float32", "bfloat16"])
def test_filtered_tail_loaders(cuda, residual):
    """The loader pick: TMA at 1280x720, the threads' loads at W = 53 and
    at 1280x720 on a filtered colour 4 B off 16; each variant's kernel
    is the one that ran and equals the plain version."""
    from bmfr_tpu_torch.ops.tail import filtered_tail_loader

    for (H, W), shift, loader in (((720, 1280), 0, "tma"),
                                  ((37, 53), 0, "threads"),
                                  ((720, 1280), 1, "threads")):
        args, base = filtered_tail_case(H, W, cuda, residual, "frame 3",
                                        "packed")
        if shift:
            buf = torch.empty(args[1].numel() + shift, device=cuda)
            moved = buf[shift:].view(args[1].shape)
            moved.copy_(args[1])
            args = (args[0], moved, *args[2:])
        pick = filtered_tail_loader(
            W, [t.data_ptr() for t in (args[1], args[2], args[3], args[5])])
        assert pick == loader, (H, W, shift)
        tag = {"tma": "TmaLoads", "threads": "ThreadLoads"}[loader]
        names = f_kernel_names(args, base.clone())
        assert len(names) == 1 and tag in names[0], names
        check_filtered_tail(args, base)


def test_filtered_tail_maps_under_threads(cuda):
    """Kernel F's tensor maps are encoded and cached in the library under
    a lock: eight fresh host threads, whose first CUDA work is F, each
    launch it on shapes of their own (40 inputs, more than the cache
    holds, so entries are replaced while others are read) and every call
    equals the plain version."""
    import threading

    from bmfr_tpu_torch.ops import _lib

    _lib.library()      # built before the threads' time limit starts
    cases = [filtered_tail_case(24 + 8 * (k % 5), 64 + 4 * k, cuda,
                                "bfloat16", "frame 3", "temporal")[0]
             for k in range(40)]
    got, errors = {}, []

    def worker(w):
        try:
            for k in range(w, len(cases), 8):
                for _ in range(3):
                    got[k] = filtered_tail(*cases[k])
            torch.cuda.synchronize()
        except Exception as e:      # reported below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
        assert not th.is_alive()
    assert not errors, errors
    from bmfr_tpu_torch.ops.tail import filtered_tail_reference
    for k, args in enumerate(cases):
        want = filtered_tail_reference(*args)
        assert all(same_values(g, w) for g, w in zip(got[k], want)), k


@pytest.mark.parametrize("path", ["default", "flagship",
                                  "householder_flagship", "first_order"])
def test_tail_kernels_launch_once_a_frame(cuda, path):
    """denoise_sequence launches H, G and F once a frame on every path,
    frame 0 included, and plain=True launches none of them; the two
    carries of the fused warp give the same frames."""
    H, W, T = 37, 53, 4
    cfg = (path_cfg("flagship", H, W).replace(features_scaled=(
        "world_position_x", "world_position_y", "world_position_z"))
        if path == "first_order" else path_cfg(path, H, W))
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    tails = (reproject_coords, noisy_tail, filtered_tail)
    for fn in tails:
        fn.launches = 0
    out = bt.denoise_sequence(cfg, inputs, cams, offs)
    assert [fn.launches for fn in tails] == [T, T, T]
    plain = bt.denoise_sequence(cfg, inputs, cams, offs, plain=True)
    assert [fn.launches for fn in tails] == [T, T, T]
    assert bool(torch.isfinite(out).all())
    for t in range(T):
        assert psnr(out[t].cpu().numpy(), plain[t].cpu().numpy()) >= 70.0
    if cfg.warp_mode == "pallas":
        temporal, _ = eager_run(cfg, inputs, cams, offs,
                                bt.TemporalState.initial(cfg, cuda))
        assert torch.equal(temporal, out)


def test_two_threads_replay_on_one_default_stream(cuda):
    """Two host threads replay their own captured steps on one card's
    default stream, round after round: each thread's frames must equal a
    single thread's (the fault once seen in a run of these tests; the
    scene-parallel runner keeps one thread per card regardless)."""
    import threading

    H, W, T, ROUNDS = 64, 96, 5, 8
    cfg = path_cfg("flagship", H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    want, _ = eager_run(cfg, inputs, cams, offs, bt.zero_state(cfg, cuda))
    results, errors = {}, []

    def worker(k):
        try:
            step = bt.make_denoise_frame(cfg)
            for r in range(ROUNDS):
                state, got = bt.zero_state(cfg, cuda), []
                for t in range(T):
                    state, res = step(state,
                                      bt.FrameInputs(*(x[t] for x in inputs)),
                                      cams[max(t - 1, 0)], offs[t], t)
                    got.append(res.clone())
                results[k, r] = torch.stack(got)
            torch.cuda.synchronize()
        except Exception as e:      # reported below, on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(k,)) for k in range(2)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert not errors, errors
    bad = [key for key, got in results.items() if not torch.equal(got, want)]
    assert not bad, f"rounds that differ from one thread's: {bad}"


# ---- kernels I, J and K (the default path's stages XLA fuses in the TPU
# step) ----

#: kernel K against its plain version (a batched product in another
#: summation order): |kernel - plain| <= K_TOL * sum_f |basis_f w_f|, the
#: rounding an f32 10-term dot product allows either way
K_TOL = 2e-6
I_SHAPES = [(100, 332), (720, 1280), (45, 1), (2, 3)]


def raw_state(H, W, dev, seed):
    """A TemporalState of random planes with NaN and infinities sprinkled
    over them, and an spp of 0..255."""
    rng = np.random.default_rng(seed)
    p = with_extremes(torch.from_numpy(rng.standard_normal(
        (15, H, W)).astype(np.float32)).to(dev), seed)
    spp = torch.from_numpy(rng.integers(0, 256, (H, W)).astype(
        np.uint8)).to(dev)
    return bt.TemporalState(positions=p[0:3], normals=p[3:6],
                            noisy=p[6:9], spp=spp, out=p[9:12],
                            result=p[12:15])


def tap_field(H, W, dev):
    """Reprojected coordinates through every edge of the screen, fully
    off it, and NaN, +-inf and +-2**31 among them."""
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None]
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :]
    pfx = xx * (1.0 + 3.0 / W) - 1.6 + yy * (1.5 / H)
    pfy = yy * 1.01 + 2.3 - xx * (2.0 / W)
    return (with_extremes(pfx.contiguous(), 3),
            with_extremes(pfy.contiguous(), 4))


@pytest.mark.parametrize("H,W", I_SHAPES)
@pytest.mark.parametrize("mode", ["float32", "packed_bf16", "packed_x_bf16"])
def test_warp_taps_kernel_is_bit_equal(cuda, H, W, mode):
    """Kernel I against its plain version: the 13 planes equal as values,
    NaN where NaN, on a field with off-screen, NaN, infinite and saturated
    coordinates and a state with NaN and infinite values."""
    from bmfr_tpu_torch.ops.warp_blend import warp_blend_planes_reference

    cfg = scene_cfg(H, W).replace(warp_mode=mode, fitter_impl="auto",
                                  solver="householder")
    state = raw_state(H, W, cuda, H + W)
    cur = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (6, H, W)).astype(np.float32)).to(cuda)
    pfx, pfy = tap_field(H, W, cuda)
    args = (cfg, state, cur[0:3], cur[3:6], pfx, pfy, mode)
    n0 = warp_blend_planes.launches
    got = warp_blend_planes(*args)
    assert warp_blend_planes.launches == n0 + 1
    want = warp_blend_planes_reference(*args)
    torch.cuda.synchronize()
    assert got.shape == (13, H, W)
    assert same_values(got, want)
    if H * W > 100:
        assert bool(got.isnan().any())


def feature_planes_on_card(H, W, dev, seed):
    """normals, positions and accumulated colour with NaN, infinities and
    values beyond f16's range."""
    p = torch.from_numpy(np.random.default_rng(seed).standard_normal(
        (9, H, W)).astype(np.float32) * 300.0).to(dev)
    return with_extremes(p, seed).split(3)


@pytest.mark.parametrize("block_edge", [8, 24, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_feature_blocks_kernel_is_bit_equal(cuda, dtype, block_edge):
    """Kernel J against its plain version bit for bit at every one of the
    16 jitter frames, each tmp dtype, block edges up to 64, the frame read
    from a host int and from a tensor on the card."""
    from bmfr_tpu_torch.ops.blockify import build_feature_blocks_reference

    H, W = 100, 332
    cfg = scene_cfg(H, W).replace(tmp_data_dtype=dtype,
                                  block_edge=block_edge, warp_mode="float32",
                                  fitter_impl="auto", solver="householder")
    planes = feature_planes_on_card(H, W, cuda, block_edge)
    n0 = build_feature_blocks.launches
    for frame in range(16):
        f = (torch.tensor(frame, dtype=torch.int32, device=cuda)
             if frame % 2 else frame)
        got = build_feature_blocks(cfg, *planes, f)
        want = build_feature_blocks_reference(cfg, *planes, frame)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16 if dtype != "float32"
                                    else torch.int32),
                           want.view(torch.int16 if dtype != "float32"
                                     else torch.int32)), frame
    assert build_feature_blocks.launches == n0 + 16


def test_feature_blocks_kernel_registered_feature(cuda, cross_features):
    """Kernel J on a basis with registered features (extra planes) and
    the built-in ones, each tmp dtype, bit for bit."""
    from bmfr_tpu_torch.ops.blockify import build_feature_blocks_reference

    H, W = 100, 332
    planes = feature_planes_on_card(H, W, cuda, 5)
    for dtype in ("float32", "float16", "bfloat16"):
        cfg = scene_cfg(H, W).replace(tmp_data_dtype=dtype,
                                      warp_mode="float32",
                                      fitter_impl="auto",
                                      **BASES["16-columns"])
        got = build_feature_blocks(cfg, *planes, 3)
        want = build_feature_blocks_reference(cfg, *planes, 3)
        torch.cuda.synchronize()
        assert got.shape[1] == 16
        assert torch.equal(got.float(), want.float()), dtype


def reconstruction_bound(cfg, weights, mins_maxs, planes, frame, tmp):
    """K_TOL times the sum of the products' magnitudes, per pixel."""
    from bmfr_tpu_torch.ops.blockify import unblockify_planes
    from bmfr_tpu_torch.ops.weighted_sum import block_basis

    basis = block_basis(cfg, mins_maxs, planes[0], planes[1], frame, tmp)
    with fitter.highest_precision():
        mag = torch.einsum("bfe,bfc->bce", basis.abs(), weights.abs())
    return K_TOL * unblockify_planes(cfg, mag, frame)


def check_reconstruction(cfg, planes, frame, w, mm, blocks):
    """One call of kernel K against its plain version: NaN where NaN,
    elsewhere within K_TOL of the products' magnitudes; one launch."""
    from bmfr_tpu_torch.ops.weighted_sum import weighted_sum_reference

    n, pos, acc = planes
    args = (cfg, w, mm, n, pos, acc, frame)
    n0 = weighted_sum.launches
    got = weighted_sum(*args, feature_blocks=blocks)
    assert weighted_sum.launches == n0 + 1
    want = weighted_sum_reference(*args, feature_blocks=blocks)
    bound = reconstruction_bound(cfg, w, mm, (n, pos), frame, blocks)
    torch.cuda.synchronize()
    nan = want.isnan()
    assert torch.equal(got.isnan(), nan), frame
    assert bool(((got - want).abs() <= bound)[~nan].all()), frame
    return nan


@pytest.mark.parametrize("H,W", [(100, 332), (96, 320)])
@pytest.mark.parametrize("block_edge", [8, 16, 32, 64])
@pytest.mark.parametrize("dtype", ["float32", "float16", "bfloat16"])
def test_block_reconstruct_kernel_within_tolerance(cuda, dtype, block_edge,
                                                   H, W):
    """Kernel K against its plain version within K_TOL of the products'
    magnitudes, NaN where NaN, at every one of the 16 jitter frames (the
    frame from a host int and from a tensor on the card), block edges 8
    to 64, W not a multiple of 32 and H a multiple of 32: NaN positions
    turn into 0 where the plain version reads the f32 blocks and stay NaN
    on f16/bf16 tmp (and without the blocks)."""
    cfg = scene_cfg(H, W).replace(tmp_data_dtype=dtype,
                                  block_edge=block_edge, warp_mode="float32",
                                  fitter_impl="auto", solver="householder")
    rng = np.random.default_rng(block_edge)
    planes = tuple(t.contiguous() for t in torch.from_numpy(
        rng.standard_normal((9, H, W)).astype(np.float32)).to(cuda).split(3))
    planes[1][0, 40, 100:130] = float("nan")
    w, mm = fit_blocks_pallas(cfg, build_feature_blocks(cfg, *planes, 11),
                              11)
    for frame in range(16):
        f = (torch.tensor(frame, dtype=torch.int32, device=cuda)
             if frame % 2 else frame)
        tmp = build_feature_blocks(cfg, *planes, frame)
        for blocks in (tmp, None):
            nan = check_reconstruction(cfg, planes, f, w, mm, blocks)
            assert bool(nan.any()) == (blocks is None
                                       or dtype != "float32")
    cfg_skip = cfg.replace(skip_fitting=True)
    n0 = weighted_sum.launches
    assert weighted_sum(cfg_skip, w, mm, *planes, 11) is planes[2]
    assert weighted_sum.launches == n0


@pytest.mark.parametrize("basis", ["16-columns", "first_order",
                                   "reregistered"])
def test_block_reconstruct_kernel_on_other_bases(cuda, cross_features,
                                                 basis):
    """Kernel K's table instance (any basis but the default one): the
    16-column basis (three registered features read from extra planes),
    first order, and the default names with ``normal_x`` registered
    anew, each within K_TOL of its plain version at four jitter frames on
    f32 and f16 tmp, NaN where NaN."""
    from bmfr_tpu_torch import features
    from bmfr_tpu_torch.ops.weighted_sum import reconstruct_geometry

    H, W = 100, 332
    kw = BASES.get(basis, {})
    planes = tuple(t.contiguous() for t in torch.from_numpy(
        np.random.default_rng(3).standard_normal((9, H, W)).astype(
            np.float32)).to(cuda).split(3))
    planes[1][2, 7:30, 50] = float("nan")
    saved = features.FEATURE_REGISTRY["normal_x"]
    if basis == "reregistered":
        features.register_feature("normal_x", lambda n, p: n[0] * 1.5)
    try:
        for dtype in ("float32", "float16"):
            cfg = scene_cfg(H, W).replace(tmp_data_dtype=dtype,
                                          warp_mode="float32",
                                          fitter_impl="auto",
                                          solver="householder", **kw)
            assert not reconstruct_geometry(cfg).default_basis
            w, mm = fit_blocks_pallas(
                cfg, build_feature_blocks(cfg, *planes, 2), 2)
            for frame in (0, 5, 10, 15):
                tmp = build_feature_blocks(cfg, *planes, frame)
                check_reconstruction(cfg, planes, frame, w, mm, tmp)
    finally:
        features.FEATURE_REGISTRY["normal_x"] = saved


@pytest.mark.parametrize("variant", [
    dict(), dict(warp_mode="packed_bf16"),
    dict(warp_mode="packed_x_bf16", tmp_data_dtype="float16"),
    dict(fitter_impl="xla", tmp_data_dtype="bfloat16"),
    dict(solver="cholesky", block_edge=16)],
    ids=["default", "packed_bf16", "packed_x_f16", "xla_bf16",
         "cholesky_be16"])
def test_default_kernels_on_the_paths(cuda, variant):
    """The block paths through denoise_sequence: launches as
    bench.expected_launches says (I on every frame with history, J and K
    on every frame), the compiled frames equal the eager step bit for bit,
    every frame >= 60 dB against plain=True, and plain=True launches none
    of I, J and K."""
    from bmfr_tpu_torch import bench

    H, W, T = 48, 160, 5
    cfg = path_cfg("default", H, W).replace(**variant)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    for fn in bench.COUNTERS.values():
        fn.launches = 0
    out = bt.denoise_sequence(cfg, inputs, cams, offs)
    got = {k: fn.launches for k, fn in bench.COUNTERS.items()}
    assert got == bench.expected_launches(cfg, T)
    eager, _ = eager_run(cfg, inputs, cams, offs, bt.zero_state(cfg, cuda))
    assert torch.equal(out, eager)
    for fn in bench.COUNTERS.values():
        fn.launches = 0
    plain = bt.denoise_sequence(cfg, inputs, cams, offs, plain=True)
    for k in ("warp_blend_planes", "build_feature_blocks", "weighted_sum"):
        assert bench.COUNTERS[k].launches == 0
    for t in range(T):
        assert psnr(out[t].cpu().numpy(), plain[t].cpu().numpy()) >= 60.0


@pytest.mark.parametrize("H,W", [(100, 332)])
def test_warp_blend_kernel_wraps_at_int_max(cuda, H, W):
    """Kernel A on tap_blend.cuh's taps: bit for bit as its plain version
    (NaN where NaN) on a field with NaN, infinite and saturated
    coordinates over a packed state with NaN and infinite values, where
    iy + 1 and ix + 1 wrap at INT_MAX to row and column 0."""
    cfg = scene_cfg(H, W)
    state = raw_state(H, W, cuda, 7)
    src8 = pack_pairs_bf16([*state.positions, *state.normals, *state.noisy,
                            state.spp.float(), *state.out, *state.result])
    cur = torch.from_numpy(np.random.default_rng(2).standard_normal(
        (6, H, W)).astype(np.float32)).to(cuda)
    pfx, pfy = tap_field(H, W, cuda)
    pfx[0, :3] = pfy[1, :3] = torch.tensor([float("inf"), 2.0**31, 3e9],
                                           device=cuda)
    args = (cfg, src8, cur[0:3], cur[3:6], pfx, pfy)
    got = warp_blend(*args)
    want = warp_blend_reference(*args)
    torch.cuda.synchronize()
    assert bool(got.isnan().any())
    assert same_values(got, want)


# ---- the TemporalState carry written in place (kernel I on the flagship's
# raw carry, kernels G and F storing the next state into it) ----

def packed_of(state):
    """The channel-pair pack of a TemporalState's 16 channels."""
    return pack_pairs_bf16([*state.positions, *state.normals, *state.noisy,
                            state.spp.float(), *state.out, *state.result])


@pytest.mark.parametrize("field", ["orbit frame 1", "extremes"])
def test_temporal_warp_kernel_is_kernel_a_on_the_pack(cuda, field):
    """At 1280x720, kernel I in packed_bf16 on a raw TemporalState equals
    kernel A on the state's pack, NaN where NaN: on orbit frame 1 after
    the flagship's frame 0, and on a random state with NaN and infinite
    values at coordinates off screen, NaN, infinite and saturated."""
    H, W = 720, 1280
    cfg = scene_cfg(H, W)
    if field == "orbit frame 1":
        inputs, cams, offs = scene(H, W, cuda, frames=2)
        state, _ = bt.denoise_frame(cfg, bt.TemporalState.initial(cfg, cuda),
                                    bt.FrameInputs(*(x[0] for x in inputs)),
                                    cams[0], offs[0], 0)
        pos, nrm = inputs.positions[1], inputs.normals[1]
        pfx, pfy = reproject_coords(cfg, pos, cams[0], offs[1])
    else:
        state = raw_state(H, W, cuda, 11)
        cur = torch.from_numpy(np.random.default_rng(2).standard_normal(
            (6, H, W)).astype(np.float32)).to(cuda)
        pos, nrm = cur[0:3], cur[3:6]
        pfx, pfy = tap_field(H, W, cuda)
    n0 = (warp_blend_planes.launches, warp_blend.launches)
    got = warp_blend_planes(cfg, state, pos, nrm, pfx, pfy, "packed_bf16")
    want = warp_blend(cfg, packed_of(state), pos, nrm, pfx, pfy)
    assert (warp_blend_planes.launches, warp_blend.launches) == (
        n0[0] + 1, n0[1] + 1)
    torch.cuda.synchronize()
    assert same_values(got, want)
    if field == "extremes":
        assert bool(got.isnan().any())
    else:
        assert bool(torch.isfinite(got).all())


def distinct_carry(H, W, dev):
    """Six distinct tensors of a TemporalState, filled with a sentinel."""
    return bt.TemporalState(
        *(torch.full((3, H, W), 7.0, device=dev) for _ in range(3)),
        torch.full((H, W), 99, dtype=torch.uint8, device=dev),
        *(torch.full((3, H, W), 7.0, device=dev) for _ in range(2)))


@pytest.mark.parametrize("H,W", [(37, 53), (720, 1280)])
@pytest.mark.parametrize("case", ["frame 0", "frame 3", "skip_taa"])
def test_tail_kernels_into_the_carry_equal_them_without(cuda, H, W, case):
    """Kernels G and F with the destination ``into`` (a TemporalState)
    store the values they give without it, NaN where NaN, into the
    carry's six tensors; the pass-through result is a copy of the tone,
    never the tone; F's threads loader at 37x53 and TMA at 1280x720."""
    from bmfr_tpu_torch.ops.reproject import noisy_tail_reference

    (cfg, filtered, planes, albedo, _, pp, frame), _ = filtered_tail_case(
        H, W, cuda, "bfloat16", case, "temporal")
    rng = np.random.default_rng(H + W)
    cur = torch.from_numpy(rng.standard_normal((9, H, W)).astype(
        np.float32)).to(cuda)
    noisy = with_extremes(cur[6:9].abs(), 2)
    into = distinct_carry(H, W, cuda)
    n0 = (noisy_tail.launches, filtered_tail.launches)
    k1 = noisy_tail(cfg, noisy, pp, planes, cur[0:3], cur[3:6], frame)
    k1i = noisy_tail(cfg, noisy, pp, planes, cur[0:3], cur[3:6], frame,
                     into=into)
    want1 = noisy_tail_reference(cfg, noisy, pp, planes, cur[0:3],
                                 cur[3:6], frame)
    got = filtered_tail(cfg, filtered, planes, albedo, k1["spp"], pp, frame)
    goti = filtered_tail(cfg, filtered, planes, albedo, k1i["spp"], pp,
                         frame, into=into)
    assert (noisy_tail.launches, filtered_tail.launches) == (
        n0[0] + 2, n0[1] + 2)
    torch.cuda.synchronize()
    assert k1i["accum"] is into.noisy and k1i["spp"] is into.spp
    for k in ("accum", "spp", "accept"):
        assert same_values(k1i[k], k1[k]) and same_values(k1[k], want1[k])
    assert torch.equal(into.positions, cur[0:3])
    assert torch.equal(into.normals, cur[3:6])
    assert goti[0] is into.out and goti[2] is into.result
    assert goti[2].data_ptr() != goti[1].data_ptr()
    for name, g, w in zip(("out", "tone", "result"), goti, got):
        assert same_values(g, w), name


@pytest.mark.parametrize("path", ["flagship", "householder_flagship"])
def test_flagship_temporal_carry_launches_kernel_i(cuda, path):
    """denoise_sequence from a TemporalState on the fused warp launches
    kernel I (packed_bf16) on every frame with history and kernel A on
    none, and equals the PackedState carry's frames bit for bit."""
    H, W, T = 64, 96, 6
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    packed = bt.denoise_sequence(cfg, inputs, cams, offs)
    warp_blend.launches = warp_blend_planes.launches = 0
    got = bt.denoise_sequence(cfg, inputs, cams, offs,
                              initial_state=bt.TemporalState.initial(cfg,
                                                                     cuda))
    assert (warp_blend_planes.launches, warp_blend.launches) == (T - 1, 0)
    assert torch.equal(got, packed)


@pytest.mark.parametrize("path,carry", [
    ("flagship", "temporal"), ("flagship", "packed"),
    ("householder_flagship", "temporal"), ("default", "temporal")])
def test_compiled_step_copies_only_its_inputs(cuda, path, carry):
    """A replay of the compiled step copies nothing: it reads the frame's
    four planes, the camera and the offset where they lie, and kernels G
    and F write the next state into the carry in place, on either carry.
    Counted as device copies in a trace of four replays (the frame's
    fill is a kernel, not a copy)."""
    from torch.profiler import ProfilerActivity

    from bmfr_tpu_torch.ops import _lib
    from bmfr_tpu_torch.pipeline.graph import CompiledStep
    from bmfr_tpu_torch.profiling import RUN_RANGE, device_events, traced_run

    H, W, T = 64, 96, 6
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    initial = (bt.PackedState if carry == "packed"
               else bt.TemporalState).initial
    state, _ = bt.denoise_frame(cfg, initial(cfg, cuda),
                                bt.FrameInputs(*(x[0] for x in inputs)),
                                cams[0], offs[0], 0)
    step = CompiledStep(cfg)
    # the capture, and the one copy of a state from elsewhere
    held = [step.run(state, bt.FrameInputs(*(x[1] for x in inputs)),
                     cams[0], offs[1], 1)[0]]

    def replays():
        for t in range(2, T):
            held[0] = step.run(held[0],
                               bt.FrameInputs(*(x[t] for x in inputs)),
                               cams[t - 1], offs[t], t)[0]
        torch.cuda.synchronize()

    torch.cuda.synchronize()
    with traced_run([ProfilerActivity.CPU, ProfilerActivity.CUDA],
                    warm=replays) as prof:
        replays()
    work = device_events(prof.events(), within=RUN_RANGE)
    copies = [e.name for e in work if "Memcpy" in e.name]
    assert copies == [], copies
    ours = sum(1 for e in work for k in _lib.KERNELS if k in e.name)
    kernels = {"default": 7, "flagship": 5, "householder_flagship": 5}[path]
    assert ours == kernels * (T - 2)
    assert len(work) == (kernels + 1) * (T - 2)     # and the frame's fill
    assert isinstance(held[0], initial.__self__)


def offset_by_a_float(t):
    """A contiguous copy of ``t`` one float past a 512 B boundary: on 4
    bytes, off 16."""
    flat = torch.empty(t.numel() + 1, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 4
    return out


@pytest.mark.parametrize("path,carry,case", [
    ("flagship", "packed", "in place"), ("flagship", "temporal", "in place"),
    ("default", "temporal", "in place"),
    ("householder_flagship", "temporal", "in place"),
    ("flagship", "packed", "misaligned"), ("default", "temporal",
                                           "two scenes")])
def test_compiled_step_reads_inputs_in_place(cuda, path, carry, case):
    """The compiled step over 20 frames of distinct inputs, its
    placeholders filled with NaN right after the capture, so a node left
    reading one would show: every frame's result and carry equal the
    eager step's bit for bit, six inputs a frame read in place, and the
    caller's tensors unchanged. ``misaligned``: the four planes one float
    off 16 B, so F's TMA instance has albedo copied and the rest read in
    place at 4 B; ``two scenes``: S = 2 in one graph, each slot bound to
    its own scene."""
    from bmfr_tpu_torch import profiling
    from bmfr_tpu_torch.pipeline.graph import CompiledStep

    H, W, T = 64, 96, 20
    cfg = path_cfg(path, H, W)
    inputs, cams, offs = scene(H, W, cuda, frames=T)
    scenes = [inputs]
    if case == "two scenes":
        scenes.append(bt.FrameInputs(*(x.flip(-1).contiguous()
                                       for x in inputs)))
    initial = (bt.PackedState if carry == "packed"
               else bt.TemporalState).initial

    def frame_of(x, t):
        planes = [p[t] for p in x]
        if case == "misaligned":
            planes = [offset_by_a_float(p) for p in planes]
        return bt.FrameInputs(*planes)

    frames = [[frame_of(x, t) for t in range(T)] for x in scenes]
    kept = [[p.clone() for f in fs for p in f] for fs in frames]
    # the eager step, each frame's result and state kept
    want = []
    for fs in frames:
        state, got = initial(cfg, cuda), []
        for t in range(T):
            state, o = bt.denoise_frame(cfg, state, fs[t],
                                        cams[max(t - 1, 0)], offs[t], t)
            got.append((o["result"].clone(), [x.clone() for x in state]))
        want.append(got)
    step = CompiledStep(cfg)
    states = []
    for fs in frames:
        st, _ = bt.denoise_frame(cfg, initial(cfg, cuda), fs[0], cams[0],
                                 offs[0], 0)
        states.append(st)

    def run(t):
        calls = [(st, fs[t], cams[t - 1], offs[t], t)
                 for st, fs in zip(states, frames)]
        return step.run_scenes(calls)

    outs = run(1)                                  # the capture
    (graph,) = step._graphs.values()
    for slot in graph.slots:
        for p in slot.placeholders:
            p.fill_(float("nan"))
    copies = profiling.counters()["copies"]
    read = profiling.counters()["inputs_in_place"]
    for t in range(1, T):
        if t > 1:
            outs = run(t)
        for k, (st, o) in enumerate(outs):
            states[k] = st
            res, carried = want[k][t]
            assert torch.equal(o["result"], res), (k, t)
            for a, b in zip(st, carried):
                assert torch.equal(a, b), (k, t)
    S, replays = len(scenes), T - 2
    in_place = 5 if case == "misaligned" else 6
    assert profiling.counters()["inputs_in_place"] - read == (
        S * in_place * replays)
    assert profiling.counters()["copies"] - copies == (
        S * (1 + 6 - in_place) * replays)
    for fs, before in zip(frames, kept):
        assert all(torch.equal(p, q) for p, q in
                   zip((p for f in fs for p in f), before))
