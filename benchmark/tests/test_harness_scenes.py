"""The benchmark's clip generator (:mod:`benchmark.scenes`) against a
frozen NumPy copy of the program's fixture renderer, at 64x48."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from benchmark import cells, scenes  # noqa: E402
from benchmark.tests import frozen_fixtures as ff  # noqa: E402

W, H, T = 64, 48, 6
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def traffic():
    return dict(cells.traffic("orbit_pipelined"), width=W, height=H,
                frames=T)


@pytest.fixture(scope="module")
def clip(traffic):
    return scenes.render_clip(traffic, 1234, CPU)


def frozen_camera(traffic, t):
    """The source's orbit camera with the traffic's two changes: the
    angular step 2 pi / frames and the eye height held."""
    ang = traffic["start_angle"] + 2 * np.pi / traffic["frames"] * t
    eye = np.array([3.2 * np.cos(ang), 1.2, 3.2 * np.sin(ang)])
    view = ff._look_at(eye, np.array([0.0, -0.2, 0.0]),
                       np.array([0.0, 1.0, 0.0]))
    proj = ff._perspective(np.deg2rad(50.0), W / H, 0.1, 100.0)
    return eye, proj @ view


@pytest.mark.parametrize("t", range(T))
def test_gbuffer_equals_the_frozen_renderer(traffic, clip, t):
    planes, cams, offs = clip
    eye, vp = frozen_camera(traffic, t)
    ox, oy = ff._halton(t + 1, 2), ff._halton(t + 1, 3)
    assert offs[t].tolist() == pytest.approx(
        [np.float32(ox), np.float32(oy)], abs=0)
    g = ff._render_gbuffer(vp, eye, W, H, np.float32(ox), np.float32(oy))
    np.testing.assert_allclose(cams[t].numpy(), vp.T.astype(np.float32),
                               rtol=1e-6, atol=1e-7)
    for k in ("positions", "normals", "albedo"):
        want = np.moveaxis(g[k], -1, 0).astype(np.float32)
        np.testing.assert_allclose(planes[k][t].numpy(), want, rtol=1e-6,
                                   atol=1e-6, err_msg=k)


def test_clip_loops_without_a_cut(traffic):
    """Frame T of the loop is frame 0: the camera of the frame after the
    last is the first one's."""
    _, vp_next = scenes.camera(traffic, traffic["frames"], CPU)
    _, vp_first = scenes.camera(traffic, 0, CPU)
    np.testing.assert_allclose(vp_next.numpy(), vp_first.numpy(),
                               atol=1e-12)


def test_noise_is_seeded(traffic, clip):
    again = scenes.render_clip(traffic, 1234, CPU)[0]["noisy"]
    other = scenes.render_clip(traffic, 1235, CPU)[0]["noisy"]
    assert torch.equal(clip[0]["noisy"], again)
    assert not torch.equal(clip[0]["noisy"], other)


def test_noise_is_the_sources_gamma():
    """Gamma(1/0.35^2, 0.35^2): mean 1, standard deviation 0.35."""
    gen = torch.Generator().manual_seed(5)
    x = scenes.gamma_noise((200000,), 1 / 0.35 ** 2, 0.35 ** 2, gen, CPU)
    assert float(x.mean()) == pytest.approx(1.0, abs=0.005)
    assert float(x.std()) == pytest.approx(0.35, abs=0.005)
    assert float(x.min()) > 0


def test_large_seed():
    gen = torch.Generator()
    gen.manual_seed((2**31 + 12345) % 2**63)
    assert math.isfinite(float(scenes.gamma_noise((10,), 8.0, 0.1, gen,
                                                  CPU).sum()))


def _render_clip_before_scenes(traffic, seed, device):
    """:func:`benchmark.scenes.render_clip` as it was before traffic could
    name ``scenes``, ``scene_spacing`` and ``angular_step``: the camera
    turns 2 pi / frames a frame, the noise drawn from the run's seed."""
    T, W, H = traffic["frames"], traffic["width"], traffic["height"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**63)
    ns = traffic["noise_scale"]
    planes = {k: torch.empty((T, 3, H, W), dtype=torch.float32,
                             device=device)
              for k in ("normals", "positions", "noisy", "albedo")}
    cams = torch.empty((T, 4, 4), dtype=torch.float32, device=device)
    offs = torch.tensor([[scenes.halton(t + 1, 2), scenes.halton(t + 1, 3)]
                         for t in range(T)], dtype=torch.float32)
    for t in range(T):
        ang = traffic["start_angle"] + 2 * math.pi * t / traffic["frames"]
        r = traffic["radius"]
        eye = torch.tensor([r * math.cos(ang), traffic["eye_height"],
                            r * math.sin(ang)], dtype=torch.float64)
        center = torch.tensor(traffic["center"], dtype=torch.float64)
        up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64)
        proj = scenes.perspective(math.radians(traffic["fov_y_deg"]), W / H,
                                  traffic["near"], traffic["far"], device)
        vp = proj @ scenes.look_at(eye, center, up)
        cams[t] = vp.T.float()
        ox, oy = (float(v) for v in offs[t])
        g = scenes.gbuffer(vp, eye, W, H, ox, oy)
        noise = scenes.gamma_noise((H, W, 3), 1.0 / ns ** 2, ns ** 2, gen,
                                   device)
        for k in ("normals", "positions", "albedo"):
            planes[k][t] = g[k].permute(2, 0, 1).float()
        planes["noisy"][t] = (g["irr"] * noise).permute(2, 0, 1).float()
    return planes, cams, offs


@pytest.mark.parametrize("mix", ["orbit_pipelined", "orbit_interactive"])
def test_the_single_scene_traffic_renders_as_before(mix):
    """The traffic files without ``scenes`` render bit for bit as before
    the scene runner's cell, at 64x48 over the first 5 frames of their
    315-frame loop (the angle keeps its 2 pi / 315 step)."""
    traffic = cells.traffic(mix)
    assert not {"scenes", "scene_spacing", "angular_step"} & set(traffic)
    small = dict(traffic, width=W, height=H)
    want = _render_clip_before_scenes(dict(small, frames=5), 2**31 + 77, CPU)
    got = scenes.render_clip(dict(small, frames=5), 2**31 + 77, CPU)
    for k in want[0]:
        assert torch.equal(got[0][k], want[0][k]), k
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for t in (0, 1, 157, 314):
        assert scenes.angle(traffic, t) == (
            traffic["start_angle"] + 2 * math.pi * t / traffic["frames"])
