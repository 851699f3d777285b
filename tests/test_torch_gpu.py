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
from bmfr_tpu_torch.ops.blockify import STORAGE_DTYPES, jitter_offset
from bmfr_tpu_torch.ops.fitter_direct import (
    fit_reconstruct_cholesky, fit_reconstruct_cholesky_reference)
from bmfr_tpu_torch.ops.fitter_pallas import (fit_blocks_pallas,
                                              fit_blocks_pallas_reference)
from bmfr_tpu_torch.ops.gather import floor_int, gather_planes
from bmfr_tpu_torch.ops.reproject import reproject_coords
from bmfr_tpu_torch.ops.warp import (add_wrap, pack_pairs_bf16,
                                     pack_x_pairs_bf16, warp_rows)
from bmfr_tpu_torch.ops.warp_blend import warp_blend, warp_blend_reference

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


@pytest.mark.parametrize("block_edge", [16, 64])
@pytest.mark.parametrize("basis", [
    dict(features_not_scaled=("const",), features_scaled=()),
    dict(features_scaled=("world_position_x",)),
    dict(features_not_scaled=("const", "normal_x", "normal_x", "normal_y",
                              "normal_y", "normal_z", "normal_z")),
], ids=["4-columns", "8-columns", "16-columns"])
def test_block_fitter_kernel_custom_basis(cuda, basis, block_edge):
    """Kernel D on custom bases of 4, 8 and 16 columns (16, the most it
    takes, keeps two colour columns in registers at block_edge 64). The
    16-column basis repeats features, so noise_amount 0.5 conditions it."""
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


@pytest.mark.parametrize("H,W", SHAPES[:2])
@pytest.mark.parametrize("frame", [0, 5, 13])
@pytest.mark.parametrize("dtype", ["float32", "float16"])
def test_direct_householder_kernel_matches_plain(cuda, H, W, frame, dtype):
    """Kernel C through both entries: the reconstruction to kernel B's
    pin (5e-3), the mins/maxs to 1e-6."""
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
    _, mm_ref = fitter_direct.fit_blocks_direct_reference(cfg, *planes,
                                                          frame)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=5e-3, atol=5e-3)
    torch.testing.assert_close(mm, mm_ref, rtol=1e-6, atol=1e-6)
    assert bool(torch.isfinite(w).all())


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
    counters = {"flagship": (warp_blend, fit_reconstruct_cholesky),
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
    assert launches == ([T - 1, T] if variant == "flagship" else [T])
    want = bt.denoise_sequence(cfg, *on_card(sc, cuda)).cpu().numpy()
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
                 "warp_rows": warp_rows}),
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
                "fit_blocks_pallas": T}
    compiled_step.cache_clear()
    for _ in range(2):
        for fn in counters.values():
            fn.launches = 0
        bt.denoise_sequence(cfg, inputs, cams, offs)
        assert {k: fn.launches for k, fn in counters.items()} == {
            k: expected[k] for k in counters}


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
