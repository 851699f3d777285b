"""The port's command line on the CPU (``--device cpu``): the synthetic
scene in its three modes writes the same PNGs byte for byte, a scene
directory staged in the TUNI layout streams from disk to one PNG per
frame, a directory of scenes to one PNG per scene and frame, and bad
arguments are refused."""

import os

import pytest

from bmfr_tpu_torch.cli import main
from bmfr_tpu_torch.io.fixtures import synthetic_sequence
from bmfr_tpu_torch.io.staging import stage_scene

W, H, T = 64, 48, 3
FAST = ["--device", "cpu", "--fitter-impl", "xla", "--chunk-frames", "2"]


def pngs(path):
    names = sorted(os.listdir(path))
    return names, [open(os.path.join(path, n), "rb").read() for n in names]


@pytest.fixture(scope="module")
def synthetic_runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("cli")
    out = {}
    for mode in ("frame", "scan", "stream"):
        d = str(root / mode)
        assert main(["--synthetic", "--width", str(W), "--height", str(H),
                     "--frames", str(T), "--mode", mode, "--output", d,
                     *FAST]) == 0
        out[mode] = pngs(d)
    return out


@pytest.mark.parametrize("mode", ["scan", "stream"])
def test_modes_write_equal_pngs(synthetic_runs, mode):
    names, data = synthetic_runs[mode]
    assert names == [f"output{t}.png" for t in range(T)]
    assert data == synthetic_runs["frame"][1]


@pytest.fixture(scope="module")
def staged(tmp_path_factory):
    root = tmp_path_factory.mktemp("tuni")
    stage_scene(str(root / "orbit"), synthetic_sequence(width=W, height=H,
                                                       frames=T, seed=4))
    return root


@pytest.mark.parametrize("mode", ["stream", "frame"])
def test_scene_directory_to_pngs(staged, tmp_path, mode, capsys):
    out = str(tmp_path / "out")
    assert main(["--scene", str(staged / "orbit"), "--mode", mode,
                 "--output", out, *FAST]) == 0
    names, data = pngs(out)
    assert names == [f"output{t}.png" for t in range(T)]
    assert all(d.startswith(b"\x89PNG") for d in data)
    assert "Full frame (all 5 stages)" in capsys.readouterr().out


def test_scenes_root_to_pngs(staged, tmp_path):
    out = str(tmp_path / "out")
    assert main(["--scenes-root", str(staged), "--output", out, *FAST]) == 0
    assert pngs(out)[0] == [f"orbit_output{t}.png" for t in range(T)]


@pytest.mark.parametrize("argv", [
    ["--mode", "bogus"],
    ["--device", "gpu"],
    ["--device", "-1"],
    ["--chunk-frames", "0"],
    ["--frames", "0"],
    ["--warp-mode", "texture"],
], ids=lambda a: " ".join(a))
def test_bad_arguments_are_refused(argv):
    with pytest.raises(SystemExit) as exc:
        main(argv)
    assert exc.value.code == 2


def test_corridor_scene_is_not_ported(tmp_path, capsys):
    """``--synthetic-scene corridor`` runs on the CPU: one PNG per frame
    and the PSNR against the corridor's clean render."""
    out = str(tmp_path / "out")
    assert main(["--synthetic", "--synthetic-scene", "corridor", "--width",
                 str(W), "--height", str(H), "--frames", str(T), "--output",
                 out, *FAST]) == 0
    assert pngs(out)[0] == [f"output{t}.png" for t in range(T)]
    assert "PSNR" in capsys.readouterr().out


def test_missing_card_index_is_an_error(capsys):
    import torch

    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert main(["--device", str(n), "--no-output", "--frames", "1"]) == 1
    assert "out of range" in capsys.readouterr().out
