"""The port's IO layer against the JAX package's on the CPU: the camera
header parser, the dataset loader over a scene staged with all five EXR
codecs, scene discovery, the exporter, the PNG writer, and the native
library's build (into ``bmfr_tpu_torch/_build/``, never over the tracked
``native/libbmfr_io.so``)."""

import hashlib
from pathlib import Path

import numpy as np
import pytest

from bmfr_tpu.io import dataset as jax_dataset
from bmfr_tpu.io.camera import parse_camera_matrices_header as jax_parse
from bmfr_tpu.io.fixtures import synthetic_sequence
from bmfr_tpu.io.staging import STAGE_CODECS, stage_scene
from bmfr_tpu_torch.io import dataset, exr, native
from bmfr_tpu_torch.io.camera import parse_camera_matrices_header
from bmfr_tpu_torch.io.export import export_scene

REPO = Path(__file__).resolve().parents[1]
W, H, T = 64, 48, 3
HEADER = """
// generated header
const float camera_matrices[2][4][4] = {
    { {1.0f, 0.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f, 0.0f},
      {0.0f, 0.0f, 1.0f, 0.0f}, {0.0f, 0.0f, 0.0f, 1.0f} },
    { {2e-1f, -0.5f, .25f, 1e3f}, {0,0,0,0}, {0,0,0,0}, {0,0,0,1} },
};
const float pixel_offsets[2][2] = { {0.5f, 0.5f}, {0.25f, 0.75f} };
const float position_limit_squared = 0.001f;
const float normal_limit_squared = 1.0f;
"""


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    """A 64x48x3 scene staged by the JAX package, the EXR codec cycled
    per file over ZIP, ZIPS, PIZ, PXR24 and B44, beside a second scene
    exported by the port."""
    root = tmp_path_factory.mktemp("scenes")
    sc = synthetic_sequence(width=W, height=H, frames=T, seed=11)
    expected = stage_scene(str(root / "a-staged"), sc, codecs=STAGE_CODECS)
    sc2 = synthetic_sequence(width=W, height=H, frames=T, seed=12)
    export_scene(sc2, str(root / "b-exported"), position_limit_squared=1e-8)
    return root, sc, expected, sc2


def test_camera_parser_matches_jax(staged):
    root = staged[0]
    for src in (HEADER, str(root / "a-staged" / "camera_matrices.h"),
                str(root / "b-exported" / "camera_matrices.h")):
        got, want = parse_camera_matrices_header(src), jax_parse(src)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert parse_camera_matrices_header(HEADER)["camera_matrices"][
        1, 0, 3] == pytest.approx(1000.0)


def test_loader_bit_equal_to_jax_on_every_codec(staged):
    root, sc, expected, _ = staged
    path = str(root / "a-staged")
    got = dataset.probe_scene(path).load_frames()
    want = jax_dataset.probe_scene(path).load_frames()
    series = dict(color="noisy", shading_normal="normals",
                  world_position="positions", albedo="albedo")
    for buf, key in series.items():
        assert got[key].dtype == np.float32 and got[key].shape == (T, H, W,
                                                                   3)
        np.testing.assert_array_equal(got[key].view(np.uint32),
                                      want[key].view(np.uint32), err_msg=key)
        np.testing.assert_array_equal(got[key].view(np.uint32),
                                      expected[buf].view(np.uint32))
    for k in ("camera_matrices", "pixel_offsets", "position_limit_squared",
              "normal_limit_squared"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # a frame subset, decoded into a caller's buffer
    out = np.full((4, 2, H, W, 3), np.nan, np.float32)
    sub = dataset.SceneDescriptor(path, T, W, H).load_frames([2, 0], out=out)
    assert np.shares_memory(sub["noisy"], out)
    np.testing.assert_array_equal(sub["albedo"], want["albedo"][[2, 0]])
    with pytest.raises(ValueError, match="C-contiguous"):
        dataset.SceneDescriptor(path, T, W, H).load_frames(
            [0], out=np.empty((4, 2, H, W, 3), np.float32))


def test_probe_and_discover_match_jax(staged):
    root = str(staged[0])
    got, want = dataset.discover_scenes(root), jax_dataset.discover_scenes(
        root)
    assert len(got) == 2
    assert [(s.path, s.frame_count, s.width, s.height) for s in got] == [
        (s.path, s.frame_count, s.width, s.height) for s in want]
    assert dataset.probe_scene(got[1].path) == got[1]


def test_export_round_trips_through_jax_loader(staged):
    root, _, _, sc2 = staged
    data = jax_dataset.probe_scene(str(root / "b-exported")).load_frames()
    for k in ("noisy", "normals", "positions", "albedo", "camera_matrices",
              "pixel_offsets"):
        np.testing.assert_array_equal(data[k], sc2[k], err_msg=k)
    assert data["position_limit_squared"] == np.float32(1e-8)
    assert data["normal_limit_squared"] == np.float32(0.5)


def test_read_image_file_validates(staged):
    root = staged[0]
    res, img = exr.read_image_file(str(root / "a-staged" / "albedo"), 1,
                                   (H, W))
    assert res and img.shape == (H, W, 3)
    res, img = exr.read_image_file(str(root / "a-staged" / "albedo"), 1,
                                   (H + 1, W))
    assert not res and img is None and "wrong type" in res.error_message
    res, img = exr.read_image_file(str(root / "a-staged" / "missing"), 0)
    assert not res and img is None


def test_write_png_reads_back(tmp_path):
    img = np.random.default_rng(5).uniform(-0.2, 1.2, (H, W, 3)).astype(
        np.float32)
    path = str(tmp_path / "out.png")
    exr.write_png(path, img)
    want = (np.clip(img, 0, 1) * 255 + 0.5).astype(np.uint8) / np.float32(
        255)
    np.testing.assert_allclose(native.read_png_rgb01(path), want, rtol=0,
                               atol=1e-6)


def test_reference_constants_match_jax():
    for name in ("TUNI_SCENES", "BUFFER_NAMES", "REFERENCE_EXR_CANDIDATES",
                 "OPENCL_PNG_CANDIDATES"):
        assert getattr(dataset, name) == getattr(jax_dataset, name), name


def test_load_references_finds_exr_and_png(tmp_path):
    r = np.random.RandomState(0)
    clean = r.rand(2, 16, 24, 3).astype(np.float32)
    png = (r.rand(2, 16, 24, 3) * 255).astype(np.uint8)
    (tmp_path / "outputs").mkdir()
    for t in range(2):
        native.write_exr(str(tmp_path / f"reference{t}.exr"), clean[t])
        native.write_png(str(tmp_path / "outputs" / f"output{t}.png"),
                         png[t])
    sd = dataset.SceneDescriptor(path=str(tmp_path), frame_count=2,
                                 width=24, height=16)
    assert (sd.find_reference_exr(), sd.find_opencl_png()) == (
        "reference", "outputs/output")
    refs = sd.load_references(frames=[1, 0])
    np.testing.assert_array_equal(refs["clean"], clean[::-1])
    np.testing.assert_allclose(refs["opencl"], png[::-1] / 255.0, atol=1e-6)
    want = jax_dataset.SceneDescriptor(path=str(tmp_path), frame_count=2,
                                       width=24, height=16).load_references()
    got = sd.load_references()
    assert sorted(got) == sorted(want) == ["clean", "opencl"]
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_references_empty_when_absent(tmp_path):
    sd = dataset.SceneDescriptor(path=str(tmp_path), frame_count=1)
    assert sd.find_reference_exr() is None and sd.find_opencl_png() is None
    assert sd.load_references() == {}


def test_build_leaves_the_tracked_library_alone():
    tracked = REPO / "native" / "libbmfr_io.so"
    before = hashlib.sha256(tracked.read_bytes()).hexdigest()
    built = native.build()
    assert built.parent == REPO / "bmfr_tpu_torch" / "_build"
    assert built == native.library_path() and built.exists()
    assert hashlib.sha256(tracked.read_bytes()).hexdigest() == before
