"""The port's scene staging (``bmfr_tpu_torch/io/staging.py``) against the
JAX package's on the CPU, and the disk contract of ``tests/
test_disk_contract.py`` on the port: a scene staged with the EXR codec
cycled per file (ZIP, ZIPS, PIZ, PXR24, B44), found, probed and batch
loaded bit for bit, then denoised by the port's command line into PNGs
that both PNG readers read back as the in-memory run quantised. Staging
by both packages gives byte-identical directories, and no reader of the
port falls back to a Python codec when the native library cannot be
built."""

import os
import shutil

import numpy as np
import pytest
import torch

from bmfr_tpu.io import staging as jax_staging
import bmfr_tpu_torch as bt
from bmfr_tpu_torch.cli import main
from bmfr_tpu_torch.io import exr_py, native, png, staging
from bmfr_tpu_torch.io.camera import parse_camera_matrices_header
from bmfr_tpu_torch.io.dataset import discover_scenes, probe_scene
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.metrics import psnr

W, H, T = 64, 48, 3
SERIES = dict(color="noisy", shading_normal="normals",
              world_position="positions", albedo="albedo")


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """The orbit scene staged by each package into its own directory."""
    root = tmp_path_factory.mktemp("staged")
    sc = synthetic_sequence(width=W, height=H, frames=T, seed=11)
    port_dir, jax_dir = root / "port" / "orbit", root / "jax" / "orbit"
    expected = staging.stage_scene(str(port_dir), sc, threads=4)
    jax_expected = jax_staging.stage_scene(str(jax_dir), sc)
    return sc, port_dir, jax_dir, expected, jax_expected


def test_stage_scene_writes_jax_bytes(staged):
    _, port_dir, jax_dir, expected, jax_expected = staged
    names = sorted(os.listdir(port_dir))
    assert names == sorted(os.listdir(jax_dir))
    assert len(names) == 4 * T + T + 1  # the series, references, header
    for name in names:
        assert (port_dir / name).read_bytes() == (jax_dir / name).read_bytes(
        ), name
    assert sorted(expected) == sorted(jax_expected)
    for buf, arr in expected.items():
        assert arr.dtype == np.float32 and arr.shape == (T, H, W, 3)
        np.testing.assert_array_equal(arr.view(np.uint32),
                                      jax_expected[buf].view(np.uint32))


def test_every_codec_staged_and_lossy_ones_round(staged):
    """File k of the series takes codec k mod 5; PXR24 and B44 round."""
    sc, port_dir, _, expected, _ = staged
    codec_ids = {"zip": 3, "zips": 2, "piz": 4, "pxr24": 5, "b44": 6}
    seen = set()
    for i, buf in enumerate(staging.BUFFER_NAMES):
        for t in range(T):
            codec = staging.STAGE_CODECS[(i * T + t) % 5]
            head = (port_dir / f"{buf}{t}.exr").read_bytes()
            at = head.index(b"compression\0compression\0") + 28
            assert head[at] == codec_ids[codec], (buf, t)
            seen.add(codec)
            src = sc[SERIES[buf]][t]
            moved = not np.array_equal(expected[buf][t], src)
            assert moved == (codec in ("pxr24", "b44")), (buf, t, codec)
    assert seen == set(staging.STAGE_CODECS)


@pytest.mark.parametrize("codecs,frames", [(("b44", "pxr24"), 2),
                                           (("piz",), 1)])
def test_stage_scene_codec_subsets_equal_jax(tmp_path, codecs, frames):
    sc = synthetic_sequence(width=24, height=20, frames=3, seed=2)
    del sc["clean"]
    got = staging.stage_scene(str(tmp_path / "p"), sc, codecs=codecs,
                              frames=frames)
    want = jax_staging.stage_scene(str(tmp_path / "j"), sc, codecs=codecs,
                                   frames=frames)
    names = sorted(os.listdir(tmp_path / "p"))
    assert names == sorted(os.listdir(tmp_path / "j"))
    assert len(names) == 4 * frames + 1
    for name in names:
        assert (tmp_path / "p" / name).read_bytes() == (
            tmp_path / "j" / name).read_bytes(), name
    for buf in got:
        np.testing.assert_array_equal(got[buf], want[buf])


def test_stage_scene_rejects_unknown_codec(tmp_path):
    sc = synthetic_sequence(width=8, height=8, frames=1)
    with pytest.raises(ValueError, match="unknown staging codec"):
        staging.stage_scene(str(tmp_path / "x"), sc, codecs=("zip", "rle"))


def test_camera_header_roundtrip_and_bytes(tmp_path):
    rng = np.random.default_rng(3)
    cams = rng.standard_normal((T, 4, 4)).astype(np.float32) * 10
    offs = rng.random((T, 2)).astype(np.float32)
    p, j = tmp_path / "p.h", tmp_path / "j.h"
    staging.write_camera_matrices_header(str(p), cams, offs, 0.011, 0.37)
    jax_staging.write_camera_matrices_header(str(j), cams, offs, 0.011, 0.37)
    assert p.read_bytes() == j.read_bytes()
    got = parse_camera_matrices_header(str(p))
    np.testing.assert_array_equal(got["camera_matrices"], cams)
    np.testing.assert_array_equal(got["pixel_offsets"], offs)
    assert got["position_limit_squared"] == np.float32(0.011)
    assert got["normal_limit_squared"] == np.float32(0.37)
    with pytest.raises(ValueError, match="camera_matrices"):
        staging.write_camera_matrices_header(str(p), cams[:, :3], offs, 0, 0)


def test_discover_and_probe(staged):
    _, port_dir, _, _, _ = staged
    scenes = discover_scenes(str(port_dir.parent))
    assert [s.path for s in scenes] == [str(port_dir)]
    sd = probe_scene(str(port_dir))
    assert (sd.width, sd.height, sd.frame_count) == (W, H, T)


def test_batch_loader_bit_exact_across_codecs(staged):
    """The native batch loader returns the codec-rounded arrays for every
    buffer and frame, and the Python reader agrees file by file."""
    sc, port_dir, _, expected, _ = staged
    data = probe_scene(str(port_dir)).load_frames()
    for buf, key in SERIES.items():
        np.testing.assert_array_equal(data[key].view(np.uint32),
                                      expected[buf].view(np.uint32),
                                      err_msg=buf)
        for t in range(T):
            np.testing.assert_array_equal(
                exr_py.read_exr_py(str(port_dir / f"{buf}{t}.exr")).view(
                    np.uint32), expected[buf][t].view(np.uint32))
    np.testing.assert_array_equal(data["camera_matrices"],
                                  sc["camera_matrices"])
    np.testing.assert_array_equal(data["pixel_offsets"], sc["pixel_offsets"])
    assert data["position_limit_squared"] == np.float32(0.03)
    assert data["normal_limit_squared"] == np.float32(0.5)


def test_cli_on_staged_scene_to_pngs(staged, tmp_path):
    """The user journey: staged scene in, PNGs out (opencl/bmfr.cpp:
    519-553). Both PNG readers read each PNG as the in-memory run on the
    expected arrays, quantised as ``io/exr.py::write_png`` does, and the
    output is closer to the clean render than the noisy input."""
    sc, port_dir, _, expected, _ = staged
    out = tmp_path / "out"
    assert main(["--scene", str(port_dir), "--output", str(out), "--device",
                 "cpu", "--fitter-impl", "xla"]) == 0
    assert sorted(os.listdir(out)) == [f"output{t}.png" for t in range(T)]
    cam = probe_scene(str(port_dir)).load_camera()
    cfg = bt.BMFRConfig(
        image_width=W, image_height=H, fitter_impl="xla",
        position_limit_squared=cam["position_limit_squared"],
        normal_limit_squared=cam["normal_limit_squared"])
    inputs = bt.frame_inputs_from_numpy(
        expected["shading_normal"], expected["world_position"],
        expected["color"], expected["albedo"], "cpu")
    res = bt.denoise_sequence(cfg, inputs,
                              torch.from_numpy(sc["camera_matrices"]),
                              torch.from_numpy(sc["pixel_offsets"])).numpy()
    want = (np.clip(np.moveaxis(res, 1, -1), 0.0, 1.0) * 255.0
            + 0.5).astype(np.uint8) / np.float32(255.0)
    clean = np.clip(np.power(np.maximum(0.0, sc["clean"]), 0.454545), 0, 1)
    noisy = np.clip(np.power(np.maximum(0.0, sc["albedo"] * sc["noisy"]),
                             0.454545), 0, 1)
    gains = []
    for t in range(T):
        path = str(out / f"output{t}.png")
        native_rgb, py_rgb = png.read_png_rgb01(path), png.read_png_rgb01_py(
            path)
        np.testing.assert_array_equal(native_rgb.view(np.uint32),
                                      py_rgb.view(np.uint32))
        np.testing.assert_array_equal(native_rgb, want[t])
        gains.append(psnr(native_rgb, clean[t]) - psnr(noisy[t], clean[t]))
    assert np.mean(gains) > 3.0, gains


def test_no_python_fallback_when_the_build_fails(tmp_path, monkeypatch,
                                                 staged):
    """Without the native library (a failed build) the PNG reader and
    the ZIP staging raise, naming the build; nothing falls back to a
    Python codec."""
    _, port_dir, _, _, _ = staged
    exr = str(port_dir / "color0.exr")
    shutil.copy(exr, tmp_path / "c.exr")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "library_path",
                        lambda: tmp_path / "build" / "libmissing.so")
    monkeypatch.setenv("CXX", "no-such-compiler-xyz")
    with pytest.raises(RuntimeError, match="native IO library"):
        png.read_png_rgb01(str(tmp_path / "x.png"))
    sc = synthetic_sequence(width=8, height=8, frames=1)
    with pytest.raises(RuntimeError, match="native IO library"):
        staging.stage_scene(str(tmp_path / "s"), sc, codecs=("zip",))
    with pytest.raises(RuntimeError, match="native IO library"):
        probe_scene(str(port_dir))
