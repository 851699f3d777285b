"""Synthetic test scene: the analytic G-buffer renderer's orbit scene.

A copy of the orbit scene of :mod:`bmfr_tpu.io.fixtures` (pure numpy,
byte-identical output for the same arguments): a sphere on a ground
plane under a directional light, viewed by an orbiting jittered camera.
It emits the reference's input contract (opencl/bmfr.cpp:49-52 and the
camera_matrices.h symbols at :440-444). All arrays are channels-last
numpy; convert at the device boundary.
"""

from __future__ import annotations

import numpy as np


def _look_at(eye, center, up):
    f = center - eye
    f = f / np.linalg.norm(f)
    s = np.cross(f, up)
    s = s / np.linalg.norm(s)
    u = np.cross(s, f)
    m = np.eye(4, dtype=np.float64)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[:3, 3] = -m[:3, :3] @ eye
    return m


def _perspective(fov_y, aspect, near, far):
    t = 1.0 / np.tan(fov_y / 2)
    m = np.zeros((4, 4), dtype=np.float64)
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def _halton(i, b):
    f, r = 1.0, 0.0
    while i > 0:
        f /= b
        r += f * (i % b)
        i //= b
    return r


_LIGHT = np.array([0.408, 0.816, 0.408])

#: scene geometry: spheres as (center, radius, albedo), axis-aligned
#: planes as (axis, offset, normal_sign) with a checker albedo
_ORBIT_SPHERES = [(np.array([0.0, 0.0, 0.0]), 1.0,
                   np.array([0.85, 0.45, 0.25]))]
_ORBIT_PLANES = [(1, -1.0, 1.0)]


def _render_gbuffer(vp, eye, width, height, ox, oy,
                    spheres=_ORBIT_SPHERES, planes=_ORBIT_PLANES):
    """Analytic G-buffer for one camera at one sub-pixel offset.

    Returns dict of HWC arrays: positions, normals, albedo, irr (clean
    irradiance), miss mask.
    """
    xs = np.arange(width)[None, :] + ox
    ys = np.arange(height)[:, None] + (1.0 - oy)
    ndc_x = np.broadcast_to(2.0 * xs / width - 1.0, (height, width))
    ndc_y = np.broadcast_to(2.0 * ys / height - 1.0, (height, width))

    inv = np.linalg.inv(vp)

    def unproject(z):
        clip = np.stack(
            [ndc_x, ndc_y, np.full_like(ndc_x, z), np.ones_like(ndc_x)],
            axis=-1)
        wp = clip @ inv.T
        return wp[..., :3] / wp[..., 3:4]

    p0 = unproject(-1.0)
    p1 = unproject(0.9)
    d = p1 - p0
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    o = np.broadcast_to(eye, d.shape)

    t_hit = np.full(d.shape[:2], np.inf)
    hit_id = np.full(d.shape[:2], -1, np.int32)
    for i, (sc, sr, _alb) in enumerate(spheres):
        oc = o - sc
        b = np.sum(oc * d, axis=-1)
        c = np.sum(oc * oc, axis=-1) - sr * sr
        disc = b * b - c
        t = np.where(disc >= 0, -b - np.sqrt(np.maximum(disc, 0.0)),
                     np.inf)
        t = np.where(t > 1e-3, t, np.inf)
        hit_id = np.where(t < t_hit, i, hit_id)
        t_hit = np.minimum(t_hit, t)
    for j, (ax, off, sign) in enumerate(planes):
        denom = d[..., ax]
        t = np.where(np.abs(denom) > 1e-9,
                     (off - o[..., ax]) / np.where(
                         np.abs(denom) > 1e-9, denom, 1.0), np.inf)
        # one-sided: only the face whose normal opposes the ray
        t = np.where((t > 1e-3) & (denom * sign < 0), t, np.inf)
        hit_id = np.where(t < t_hit, len(spheres) + j, hit_id)
        t_hit = np.minimum(t_hit, t)

    t_safe = np.where(np.isfinite(t_hit), t_hit, 50.0)
    pos = o + t_safe[..., None] * d

    normal = np.zeros_like(pos)
    albedo = np.full_like(pos, 0.05)
    for i, (sc, _sr, alb) in enumerate(spheres):
        n = pos - sc
        n = n / np.maximum(np.linalg.norm(n, axis=-1, keepdims=True),
                           1e-9)
        m = (hit_id == i)[..., None]
        normal = np.where(m, n, normal)
        albedo = np.where(m, alb, albedo)
    for j, (ax, _off, sign) in enumerate(planes):
        # checker over the plane's two in-plane axes
        a0, a1 = [a for a in (0, 1, 2) if a != ax]
        checker = ((np.floor(pos[..., a0]) + np.floor(pos[..., a1])) % 2)
        alb_pl = np.stack([0.8 - 0.5 * checker, 0.7 - 0.3 * checker,
                           0.6 - 0.2 * checker], axis=-1)
        n = np.zeros(3)
        n[ax] = sign
        m = (hit_id == len(spheres) + j)[..., None]
        normal = np.where(m, n, normal)
        albedo = np.where(m, alb_pl, albedo)

    miss = hit_id < 0
    albedo = np.where(miss[..., None], 0.05, albedo)

    ndl = np.maximum(np.sum(normal * _LIGHT, axis=-1), 0.0)
    irr = (0.25 + 0.75 * ndl)[..., None] * np.ones(3)
    irr = np.where(miss[..., None], 0.3, irr)
    return dict(positions=np.where(miss[..., None], 0.0, pos),
                normals=np.where(miss[..., None], 0.0, normal),
                albedo=albedo, irr=irr, miss=miss)


def synthetic_sequence(width=64, height=48, frames=4, seed=0,
                       noise_scale=0.35, orbit_step=0.02, aa_samples=1,
                       scene="orbit"):
    """Render a deterministic synthetic orbit sequence (sphere on a
    ground plane, orbiting camera — lateral optical flow).

    Returns a dict of numpy arrays:
      normals/positions/albedo/noisy/clean: ``f32[T, H, W, 3]``
      clean_aa: supersampled clean render (only if ``aa_samples > 1``)
      camera_matrices: ``f32[T, 4, 4]`` (column-projecting storage)
      pixel_offsets: ``f32[T, 2]``
    """
    if scene != "orbit":
        raise ValueError(
            f"scene {scene!r}: the port carries only the orbit scene")
    rng = np.random.RandomState(seed)
    T = frames
    keys = ["normals", "positions", "albedo", "noisy", "clean"]
    if aa_samples > 1:
        keys.append("clean_aa")
    out = {k: np.zeros((T, height, width, 3), np.float32) for k in keys}
    cams = np.zeros((T, 4, 4), np.float32)
    offsets = np.array(
        [[_halton(t + 1, 2), _halton(t + 1, 3)] for t in range(T)],
        np.float32)

    def camera(t):
        ang = 0.7 + orbit_step * t
        eye = np.array([3.2 * np.cos(ang), 1.2 + 0.05 * t,
                        3.2 * np.sin(ang)])
        return eye, np.array([0.0, -0.2, 0.0])

    for t in range(T):
        eye, center = camera(t)
        view = _look_at(eye, center, np.array([0.0, 1.0, 0.0]))
        proj = _perspective(np.deg2rad(50.0), width / height, 0.1, 100.0)
        vp = proj @ view
        # Stored transposed so that *columns* project (opencl/bmfr.cl:342-347)
        cams[t] = vp.T.astype(np.float32)

        ox, oy = offsets[t]
        g = _render_gbuffer(vp, eye, width, height, ox, oy)

        noise = rng.gamma(shape=1.0 / max(noise_scale, 1e-6) ** 2,
                          scale=noise_scale**2, size=g["irr"].shape)
        out["positions"][t] = g["positions"]
        out["normals"][t] = g["normals"]
        out["albedo"][t] = g["albedo"]
        out["clean"][t] = (g["albedo"] * g["irr"]).astype(np.float32)
        out["noisy"][t] = (g["irr"] * noise).astype(np.float32)

        if aa_samples > 1:
            acc = np.zeros((height, width, 3), np.float64)
            for s in range(aa_samples):
                sx = _halton(s + 1, 2)
                sy = _halton(s + 1, 3)
                gs = _render_gbuffer(vp, eye, width, height, sx, sy)
                acc += gs["albedo"] * gs["irr"]
            out["clean_aa"][t] = (acc / aa_samples).astype(np.float32)

    out["camera_matrices"] = cams
    out["pixel_offsets"] = offsets
    return out
