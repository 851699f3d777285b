"""The traffic's clip, rendered on the card from the seed.

The orbit scene of the program's synthetic fixtures (a sphere on a
checkered ground plane, an orbiting camera, 1 spp gamma noise, Halton
pixel offsets; ``bmfr_tpu_torch/io/fixtures.py``) rewritten in PyTorch
so that a run renders its clip on the card in seconds. The geometry is
computed in float64, as the fixtures compute it, and stored as float32.
Two changes to the source make the clip loop without a cut, each read
from the traffic file: the camera turns by ``2 pi / frames`` a frame
(the source: 0.02 rad), unless the traffic gives ``angular_step`` (rad
a frame), and the eye stays at its frame-0 height (the source climbs
0.05 a frame). The noise is this module's own: each frame's gamma
variates come from a ``torch.Generator`` seeded with the run's seed, by
Marsaglia and Tsang's method.

A traffic of ``scenes`` S renders S views of the scene
(:func:`render_scenes`): scene ``s`` starts at ``start_angle + s *
scene_spacing`` and draws its noise from a generator of its own, seeded
from ``(seed, s)`` (:func:`scene_seed`); scene 0 is what
:func:`render_clip` renders.

Returns channels-first float32 ``[T, 3, H, W]`` planes, the cameras
``[T, 4, 4]`` (stored so that their columns project,
opencl/bmfr.cl:342-347) and the offsets ``[T, 2]``; :func:`render_scenes`
the same with a leading scene axis.
"""

from __future__ import annotations

import math

import torch

_LIGHT = (0.408, 0.816, 0.408)


def halton(i, b):
    f, r = 1.0, 0.0
    while i > 0:
        f /= b
        r += f * (i % b)
        i //= b
    return r


def look_at(eye, center, up):
    """The view matrix, float64 ``[4, 4]``."""
    f = center - eye
    f = f / torch.linalg.norm(f)
    s = torch.linalg.cross(f, up)
    s = s / torch.linalg.norm(s)
    u = torch.linalg.cross(s, f)
    m = torch.eye(4, dtype=torch.float64, device=eye.device)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def perspective(fov_y, aspect, near, far, device):
    t = 1.0 / math.tan(fov_y / 2)
    m = torch.zeros((4, 4), dtype=torch.float64, device=device)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def angle(traffic, t, scene=0):
    """The camera's angle (rad) at clip frame ``t`` of scene ``scene``."""
    start = traffic["start_angle"] + scene * traffic.get("scene_spacing",
                                                         0.0)
    if "angular_step" in traffic:
        return start + traffic["angular_step"] * t
    return start + 2 * math.pi * t / traffic["frames"]


def camera(traffic, t, device, scene=0):
    """``(eye, view-projection)`` of clip frame ``t`` of scene ``scene``,
    float64."""
    ang = angle(traffic, t, scene)
    r = traffic["radius"]
    eye = torch.tensor([r * math.cos(ang), traffic["eye_height"],
                        r * math.sin(ang)], dtype=torch.float64,
                       device=device)
    center = torch.tensor(traffic["center"], dtype=torch.float64,
                          device=device)
    up = torch.tensor([0.0, 1.0, 0.0], dtype=torch.float64, device=device)
    W, H = traffic["width"], traffic["height"]
    proj = perspective(math.radians(traffic["fov_y_deg"]), W / H,
                       traffic["near"], traffic["far"], device)
    return eye, proj @ look_at(eye, center, up)


def gbuffer(vp, eye, width, height, ox, oy):
    """The orbit scene's analytic G-buffer at one sub-pixel offset:
    float64 ``[H, W, 3]`` positions, normals, albedo, irradiance."""
    dev = vp.device
    f64 = dict(dtype=torch.float64, device=dev)
    xs = torch.arange(width, **f64)[None, :] + ox
    ys = torch.arange(height, **f64)[:, None] + (1.0 - oy)
    ndc_x = (2.0 * xs / width - 1.0).expand(height, width)
    ndc_y = (2.0 * ys / height - 1.0).expand(height, width)
    inv = torch.linalg.inv(vp)

    def unproject(z):
        clip = torch.stack([ndc_x, ndc_y, torch.full_like(ndc_x, z),
                            torch.ones_like(ndc_x)], dim=-1)
        wp = clip @ inv.T
        return wp[..., :3] / wp[..., 3:4]

    p0 = unproject(-1.0)
    d = unproject(0.9) - p0
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    o = eye.expand(d.shape)

    # the sphere (centre 0, radius 1) and the one-sided floor y = -1
    b = (o * d).sum(-1)
    c = (o * o).sum(-1) - 1.0
    disc = b * b - c
    t_s = torch.where(disc >= 0, -b - torch.sqrt(disc.clamp_min(0.0)),
                      math.inf)
    t_s = torch.where(t_s > 1e-3, t_s, math.inf)
    denom = d[..., 1]
    safe = torch.where(denom.abs() > 1e-9, denom, 1.0)
    t_p = torch.where(denom.abs() > 1e-9, (-1.0 - o[..., 1]) / safe,
                      math.inf)
    t_p = torch.where((t_p > 1e-3) & (denom < 0), t_p, math.inf)
    hit_sphere = t_s < math.inf
    hit_plane = (t_p < t_s) & (t_p < math.inf)
    hit_sphere = hit_sphere & ~hit_plane
    t_hit = torch.minimum(t_s, t_p)
    miss = ~(hit_sphere | hit_plane)

    pos = o + torch.where(miss, 50.0, t_hit)[..., None] * d
    n_s = pos / torch.linalg.norm(pos, dim=-1, keepdim=True).clamp_min(1e-9)
    n_p = torch.tensor([0.0, 1.0, 0.0], **f64).expand(pos.shape)
    normal = torch.where(hit_sphere[..., None], n_s,
                         torch.where(hit_plane[..., None], n_p, 0.0))
    checker = torch.remainder(torch.floor(pos[..., 0])
                              + torch.floor(pos[..., 2]), 2.0)
    alb_pl = torch.stack([0.8 - 0.5 * checker, 0.7 - 0.3 * checker,
                          0.6 - 0.2 * checker], dim=-1)
    alb_s = torch.tensor([0.85, 0.45, 0.25], **f64).expand(pos.shape)
    albedo = torch.where(hit_sphere[..., None], alb_s,
                         torch.where(hit_plane[..., None], alb_pl, 0.05))
    light = torch.tensor(_LIGHT, **f64)
    ndl = (normal * light).sum(-1).clamp_min(0.0)
    irr = (0.25 + 0.75 * ndl)[..., None].expand(pos.shape)
    irr = torch.where(miss[..., None], 0.3, irr)
    return dict(positions=torch.where(miss[..., None], 0.0, pos),
                normals=normal, albedo=albedo, irr=irr)


def gamma_noise(shape, k, theta, generator, device):
    """Gamma(``k``, ``theta``) variates (``k >= 1``) by Marsaglia and
    Tsang's method, drawn from ``generator``: the same generator state
    gives the same variates."""
    d = k - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    n = math.prod(shape)
    out = torch.empty(n, dtype=torch.float64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        x = torch.randn(todo.numel(), generator=generator, device=device,
                        dtype=torch.float64)
        u = torch.rand(todo.numel(), generator=generator, device=device,
                       dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        out[todo[ok]] = d * v[ok] * theta
        todo = todo[~ok]
    return out.reshape(shape)


def scene_seed(seed, scene):
    """The noise generator's seed of scene ``scene`` of a run: the run's
    seed for scene 0, a seed of its own for each other scene."""
    return (int(seed) + scene * 0x9E3779B97F4A7C15) % 2**63


def _render_into(traffic, seed, scene, planes, cams, offs):
    """Render scene ``scene``'s clip into ``planes`` (``[T, 3, H, W]``
    each) and ``cams`` (``[T, 4, 4]``) at the offsets ``offs``."""
    T, W, H = traffic["frames"], traffic["width"], traffic["height"]
    device = cams.device
    gen = torch.Generator(device=device)
    gen.manual_seed(scene_seed(seed, scene))
    ns = traffic["noise_scale"]
    for t in range(T):
        eye, vp = camera(traffic, t, device, scene)
        cams[t] = vp.T.float()
        ox, oy = (float(v) for v in offs[t])
        g = gbuffer(vp, eye, W, H, ox, oy)
        noise = gamma_noise((H, W, 3), 1.0 / ns ** 2, ns ** 2, gen, device)
        for k in ("normals", "positions", "albedo"):
            planes[k][t] = g[k].permute(2, 0, 1).float()
        planes["noisy"][t] = (g["irr"] * noise).permute(2, 0, 1).float()


def _offsets(T):
    return torch.tensor([[halton(t + 1, 2), halton(t + 1, 3)]
                         for t in range(T)], dtype=torch.float32)


def render_clip(traffic, seed, device):
    """The traffic's clip on ``device``: ``(planes, cams, offsets)``, with
    ``planes`` a dict of float32 ``[T, 3, H, W]`` normals, positions,
    noisy and albedo. The seed sets the noise only: every seed renders
    the same geometry, cameras and offsets."""
    T, W, H = traffic["frames"], traffic["width"], traffic["height"]
    planes = {k: torch.empty((T, 3, H, W), dtype=torch.float32,
                             device=device)
              for k in ("normals", "positions", "noisy", "albedo")}
    cams = torch.empty((T, 4, 4), dtype=torch.float32, device=device)
    offs = _offsets(T)
    _render_into(traffic, seed, 0, planes, cams, offs)
    return planes, cams, offs.to(device)


def render_scenes(traffic, seed, device):
    """The traffic's ``scenes`` clips on ``device``, stacked:
    ``(planes, cams, offsets)`` with float32 ``[S, T, 3, H, W]`` planes,
    ``[S, T, 4, 4]`` cameras and ``[S, T, 2]`` offsets. Scene ``s`` is
    the view ``s * scene_spacing`` further round the orbit, with noise
    of its own; every scene has the same pixel offsets."""
    S = traffic["scenes"]
    T, W, H = traffic["frames"], traffic["width"], traffic["height"]
    planes = {k: torch.empty((S, T, 3, H, W), dtype=torch.float32,
                             device=device)
              for k in ("normals", "positions", "noisy", "albedo")}
    cams = torch.empty((S, T, 4, 4), dtype=torch.float32, device=device)
    offs = _offsets(T)
    for s in range(S):
        _render_into(traffic, seed, s, {k: v[s] for k, v in planes.items()},
                     cams[s], offs)
    return planes, cams, offs.to(device).expand(S, T, 2).contiguous()
