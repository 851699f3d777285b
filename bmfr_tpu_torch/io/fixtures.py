"""Synthetic test scenes: an analytic G-buffer renderer.

A copy of :mod:`bmfr_tpu.io.fixtures` (pure numpy; byte-identical output
for the same arguments), kept here because the port imports nothing of
the JAX package. Three scenes: ``orbit`` (a sphere on a ground plane,
orbiting jittered camera), ``corridor`` (four spheres in a walled
corridor, forward dolly) and ``swing`` (an enclosed room, a yaw pan and
a jump of the eye at mid-sequence). The generator emits the reference's
input contract (opencl/bmfr.cpp:49-52 and the camera_matrices.h symbols
at :440-444):

* ``normals``, ``world_position``, ``albedo`` — analytic G-buffer
* ``noisy`` — 1-spp-like Monte-Carlo-noised diffuse shading
* ``clean`` — the converged shading (stand-in for the 4096-spp references)
* ``camera_matrices[T,4,4]`` — stored so that its *columns* project, i.e.
  ``uv = wp4 @ M`` (matching opencl/bmfr.cl:342-347)
* ``pixel_offsets[T,2]`` — sub-pixel jitter in [0,1)

All arrays are channels-last numpy (host layout); convert at the device
boundary.
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
_CORRIDOR_SPHERES = [
    (np.array([-1.1, -0.55, -1.0]), 0.45, np.array([0.85, 0.45, 0.25])),
    (np.array([1.2, -0.35, -3.0]), 0.65, np.array([0.30, 0.55, 0.85])),
    (np.array([-0.8, 0.35, -5.2]), 0.5, np.array([0.55, 0.80, 0.35])),
    (np.array([0.6, -0.6, -7.0]), 0.4, np.array([0.85, 0.80, 0.30])),
]
_CORRIDOR_PLANES = [(1, -1.0, 1.0),   # floor
                    (0, -2.2, 1.0),   # left wall
                    (0, 2.2, -1.0),   # right wall
                    (2, -9.5, 1.0)]   # back wall

# The swing room: a fully enclosed box (no miss pixels — background
# misses store position 0, and a panning camera projects them all to one
# screen point, a fixture-artifact mega-fold that would mask the real
# motion structure) around the orbit sphere plus two satellites.
_SWING_SPHERES = [
    (np.array([0.0, 0.0, 0.0]), 1.0, np.array([0.85, 0.45, 0.25])),
    (np.array([-1.8, -0.4, 1.6]), 0.55, np.array([0.30, 0.55, 0.85])),
    (np.array([1.5, 0.6, -1.9]), 0.7, np.array([0.55, 0.80, 0.35])),
]
_SWING_PLANES = [(1, -1.0, 1.0),    # floor
                 (1, 3.2, -1.0),    # ceiling
                 (0, -4.5, 1.0), (0, 4.5, -1.0),   # x walls
                 (2, -4.5, 1.0), (2, 4.5, -1.0)]   # z walls


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
        # checker over the plane's two in-plane axes (the floor's is
        # floor(x)+floor(z), exactly the original orbit fixture)
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
    """Render a deterministic synthetic sequence.

    ``scene``: "orbit" (sphere on a ground plane, orbiting camera —
    lateral optical flow), "corridor" (four spheres in a walled
    corridor, forward dolly — center-out disocclusion flow), or "swing"
    (fixed-eye yaw pan — large near-uniform flow — with a camera
    TELEPORT at ``frames // 2`` that breaks every reprojection test and
    must engage the whole-frame fallback tier mid-sequence).

    Returns a dict of numpy arrays:
      normals/positions/albedo/noisy/clean: ``f32[T, H, W, 3]``
      clean_aa: supersampled clean render (only if ``aa_samples > 1``) —
        the fair reference for the anti-aliasing TAA output
      camera_matrices: ``f32[T, 4, 4]`` (column-projecting storage)
      pixel_offsets: ``f32[T, 2]``
    """
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

    if scene == "orbit":
        spheres, planes = _ORBIT_SPHERES, _ORBIT_PLANES

        def camera(t):
            ang = 0.7 + orbit_step * t
            eye = np.array([3.2 * np.cos(ang), 1.2 + 0.05 * t,
                            3.2 * np.sin(ang)])
            return eye, np.array([0.0, -0.2, 0.0])
    elif scene == "corridor":
        # forward dolly with a slight sway: the motion structure TAA
        # and the warp see is disocclusion-from-center, unlike the
        # orbit's lateral flow
        spheres, planes = _CORRIDOR_SPHERES, _CORRIDOR_PLANES

        def camera(t):
            eye = np.array([0.6 * np.sin(0.3 + 2.5 * orbit_step * t),
                            0.15, 3.8 - 7.5 * orbit_step * t])
            return eye, np.array([0.0, -0.1, eye[2] - 4.0])
    elif scene == "swing":
        # pure rotation about a (near-)fixed eye: reprojection flow is
        # large and almost uniform per tile (stresses the plan's window
        # placement, not its spread), then the eye teleports across the
        # scene at mid-sequence — every bilinear tap fails the position
        # test and the frame must be served by the fallback tier
        spheres, planes = _SWING_SPHERES, _SWING_PLANES
        half_t = max(frames // 2, 1)

        def camera(t):
            pan = 2.0 * orbit_step * t
            if t < half_t:
                eye = np.array([3.0, 1.1, 0.6])
                yaw = 3.3 + pan     # scene center stays in frame
            else:
                eye = np.array([-2.6, 1.6, -1.2])  # the teleport
                yaw = 0.35 + pan
            look = np.array([np.cos(yaw), -0.30, np.sin(yaw)])
            return eye, eye + look
    else:
        raise ValueError(f"unknown scene type: {scene!r}")

    for t in range(T):
        eye, center = camera(t)
        view = _look_at(eye, center, np.array([0.0, 1.0, 0.0]))
        proj = _perspective(np.deg2rad(50.0), width / height, 0.1, 100.0)
        vp = proj @ view
        # Stored transposed so that *columns* project (opencl/bmfr.cl:342-347)
        cams[t] = vp.T.astype(np.float32)

        ox, oy = offsets[t]
        g = _render_gbuffer(vp, eye, width, height, ox, oy,
                            spheres, planes)

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
                gs = _render_gbuffer(vp, eye, width, height, sx, sy,
                                     spheres, planes)
                acc += gs["albedo"] * gs["irr"]
            out["clean_aa"][t] = (acc / aa_samples).astype(np.float32)

    out["camera_matrices"] = cams
    out["pixel_offsets"] = offsets
    return out
