"""Vectorized NumPy oracle: the literal oracle's semantics at image
rate, for production-resolution parity runs.

A frozen copy of ``bmfr_tpu_torch/oracle/reference_vec.py``: the
benchmark's tests pin its PyTorch reference (:mod:`.bmfr`) to it at a
tiny size, and a later change to the program's copy cannot move it.
:mod:`.oracle_reference` restates ``opencl/bmfr.cl``
with per-pixel Python loops — trustworthy but only usable on tiny
fixtures. This module restates the same kernels (accumulate_noisy_data
opencl/bmfr.cl:290-485, weighted_sum :703-758, accumulate_filtered_data
:761-857, taa :860-974) as dense NumPy array programs; the fitter
(:490-700) is the literal oracle's, verbatim (per-block Python loops).
It shares no code with the port's pipeline.

All math is float32, per-pixel independent, and ordered exactly as the
per-pixel restatement orders it.
"""

from __future__ import annotations

import numpy as np

from .oracle_reference import _BLOCK_OFFSETS, OracleState, fitter

f32 = np.float32


def _mirror_idx(idx, size):
    """Vector mirror (opencl/bmfr.cl:209-216): valid <=1 size out."""
    idx = np.where(idx < 0, np.abs(idx) - 1, idx)
    return np.where(idx >= size, 2 * size - idx - 1, idx)


def _eval_features_vec(name, normal, wp):
    """Default feature expressions (opencl/bmfr.cpp:65-77) on [H, W, 3]."""
    table = {
        "const": lambda: np.ones(wp.shape[:2], f32),
        "normal_x": lambda: normal[..., 0], "normal_y": lambda: normal[..., 1],
        "normal_z": lambda: normal[..., 2],
        "world_position_x": lambda: wp[..., 0],
        "world_position_y": lambda: wp[..., 1],
        "world_position_z": lambda: wp[..., 2],
        "world_position_x2": lambda: wp[..., 0] * wp[..., 0],
        "world_position_y2": lambda: wp[..., 1] * wp[..., 1],
        "world_position_z2": lambda: wp[..., 2] * wp[..., 2],
    }
    return table[name]().astype(f32)


def accumulate_noisy_data_vec(cfg, state, normals, positions, noisy,
                              prev_cam, pixel_offset, frame):
    """K1 over the margins grid, dense (opencl/bmfr.cl:290-485)."""
    H, W = cfg.image_height, cfg.image_width
    mw, mh = cfg.workset_with_margins_width, cfg.workset_with_margins_height
    be = cfg.block_edge
    half = be // 2
    ox, oy = _BLOCK_OFFSETS[frame % 16]

    gy, gx = np.meshgrid(np.arange(mh), np.arange(mw), indexing="ij")
    pwm_x = gx - half + ox
    pwm_y = gy - half + oy
    px = _mirror_idx(pwm_x, W)
    py = _mirror_idx(pwm_y, H)

    wp = positions[py, px].astype(f32)          # [mh, mw, 3]
    normal = normals[py, px].astype(f32)
    cur_color = noisy[py, px].astype(f32)

    prev_color = np.zeros((mh, mw, 3), f32)
    sample_spp = np.zeros((mh, mw), f32)
    total_weight = np.zeros((mh, mw), f32)
    accept = np.zeros((mh, mw), np.uint8)
    blend_alpha = np.ones((mh, mw), f32)
    prev_pixel_f = np.stack([px, py], axis=-1).astype(f32)

    if frame > 0:
        m = prev_cam.astype(f32)
        u = wp[..., 0] * m[0, 0] + wp[..., 1] * m[1, 0] \
            + wp[..., 2] * m[2, 0] + m[3, 0]
        v = wp[..., 0] * m[0, 1] + wp[..., 1] * m[1, 1] \
            + wp[..., 2] * m[2, 1] + m[3, 1]
        w = wp[..., 0] * m[0, 3] + wp[..., 1] * m[1, 3] \
            + wp[..., 2] * m[2, 3] + m[3, 3]
        uvx = ((u / w + f32(1.0)) / f32(2.0) * f32(W)
               - f32(pixel_offset[0])).astype(f32)
        uvy = ((v / w + f32(1.0)) / f32(2.0) * f32(H)
               - (f32(1.0) - f32(pixel_offset[1]))).astype(f32)
        prev_pixel_f = np.stack([uvx, uvy], axis=-1)
        ix = np.floor(uvx).astype(np.int64)
        iy = np.floor(uvy).astype(np.int64)
        fx = (uvx - ix.astype(f32)).astype(f32)
        fy = (uvy - iy.astype(f32)).astype(f32)
        weights = [(1 - fx) * (1 - fy), fx * (1 - fy),
                   (1 - fx) * fy, fx * fy]
        for i, (dx, dy) in enumerate([(0, 0), (1, 0), (0, 1), (1, 1)]):
            sx, sy = ix + dx, iy + dy
            inb = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
            sxc = np.clip(sx, 0, W - 1)
            syc = np.clip(sy, 0, H - 1)
            pos_diff = state.prev_positions[syc, sxc] - wp
            ok = inb & (np.sum(pos_diff * pos_diff, axis=-1, dtype=f32)
                        < f32(cfg.position_limit_squared))
            nrm_diff = state.prev_normals[syc, sxc] - normal
            ok &= (np.sum(nrm_diff * nrm_diff, axis=-1, dtype=f32)
                   < f32(cfg.normal_limit_squared))
            wgt = np.where(ok, weights[i].astype(f32), f32(0.0))
            sample_spp += wgt * state.prev_spp[syc, sxc].astype(f32)
            prev_color += wgt[..., None] * state.prev_noisy[syc, sxc]
            total_weight += wgt
            accept |= np.where(ok, np.uint8(1 << i), np.uint8(0))
        has = total_weight > 0
        tw = np.where(has, total_weight, f32(1.0))
        prev_color = prev_color / tw[..., None]
        sample_spp = sample_spp / tw
        blend_alpha = np.where(
            has,
            np.maximum(f32(1.0) / (sample_spp + f32(1.0)),
                       f32(cfg.blend_alpha)),
            f32(1.0)).astype(f32)

    # spp (opencl/bmfr.cl:432-442): convert_uchar_sat_rte + saturate
    rte = np.rint(sample_spp).astype(np.int64) + 1
    new_spp = np.where(
        blend_alpha < 1.0,
        np.where(sample_spp > 254.0, 255, rte), 1).astype(np.uint8)

    new_color = (blend_alpha[..., None] * cur_color
                 + (f32(1.0) - blend_alpha)[..., None] * prev_color)

    # feature vector + block-interleaved store (opencl/bmfr.cl:447-476)
    feats = [_eval_features_vec(n, normal, wp) for n in cfg.all_features]
    feats += [new_color[..., 0], new_color[..., 1], new_color[..., 2]]
    planes = np.stack(feats, axis=0).astype(f32)    # [B, mh, mw]
    planes = np.where(np.isnan(planes), f32(0.0), planes)
    if cfg.tmp_data_dtype == "float16":
        planes = np.clip(planes, -65504.0, 65504.0)
        planes = np.float16(planes).astype(f32)
    B = planes.shape[0]
    tmp = (planes.reshape(B, cfg.blocks_y, be, cfg.blocks_x, be)
           .transpose(1, 3, 0, 2, 4)
           .reshape(cfg.n_blocks, B, cfg.block_pixels).copy())

    # outputs from the unique in-image writer (opencl/bmfr.cl:478-484)
    inim = (pwm_x >= 0) & (pwm_x < W) & (pwm_y >= 0) & (pwm_y < H)
    accum = noisy.astype(f32).copy()
    spp_out = np.zeros((H, W), np.uint8)
    pp_out = np.zeros((H, W, 2), f32)
    acc_out = np.zeros((H, W), np.uint8)
    accum[py[inim], px[inim]] = new_color[inim]
    spp_out[py[inim], px[inim]] = new_spp[inim]
    pp_out[py[inim], px[inim]] = prev_pixel_f[inim]
    acc_out[py[inim], px[inim]] = accept[inim]
    return dict(accum=accum, spp=spp_out, prev_pixels=pp_out,
                accept=acc_out, tmp=tmp)


def weighted_sum_vec(cfg, weights, mins_maxs, normals, positions, noisy,
                     frame):
    """K3 dense (opencl/bmfr.cl:703-758)."""
    H, W = cfg.image_height, cfg.image_width
    be = cfg.block_edge
    half = be // 2
    ox, oy = _BLOCK_OFFSETS[frame % 16]
    py, px = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    group = ((px + half - ox) // be) + ((py + half - oy) // be) * cfg.blocks_x

    wp = positions.astype(f32)
    normal = normals.astype(f32)
    nns = cfg.features_not_scaled_count
    color = np.zeros((H, W, 3), f32)
    for fidx, name in enumerate(cfg.all_features):
        feat = _eval_features_vec(name, normal, wp)
        if fidx >= nns:
            bmin = mins_maxs[group, fidx - nns, 0]
            bmax = mins_maxs[group, fidx - nns, 1]
            span = bmax - bmin
            feat = np.where(np.abs(span) > 1.0,
                            (feat - bmin) / span, feat - bmin).astype(f32)
        color += weights[group, fidx] * feat[..., None]
    color = np.where(color < 0.0, f32(0.0), color)
    if cfg.skip_fitting:
        color = noisy.astype(f32)
    return color


def accumulate_filtered_data_vec(cfg, state, filtered, prev_pixels,
                                 accept, albedo, spp, frame):
    """K4 dense (opencl/bmfr.cl:761-857)."""
    H, W = cfg.image_height, cfg.image_width
    fcol = filtered.astype(f32)
    prev_color = np.zeros((H, W, 3), f32)
    total_weight = np.zeros((H, W), f32)
    blend_alpha = np.ones((H, W), f32)

    if frame > 0 and not cfg.skip_second_accum:
        pfx = prev_pixels[..., 0].astype(f32)
        pfy = prev_pixels[..., 1].astype(f32)
        ix = np.floor(pfx).astype(np.int64)
        iy = np.floor(pfy).astype(np.int64)
        fx = (pfx - ix.astype(f32)).astype(f32)
        fy = (pfy - iy.astype(f32)).astype(f32)
        taps = [(0x01, (1 - fx) * (1 - fy), 0, 0),
                (0x02, fx * (1 - fy), 1, 0),
                (0x04, (1 - fx) * fy, 0, 1),
                (0x08, fx * fy, 1, 1)]
        for bit, wgt, dx, dy in taps:
            on = (accept & bit) > 0
            sxc = np.clip(ix + dx, 0, W - 1)
            syc = np.clip(iy + dy, 0, H - 1)
            w = np.where(on, wgt.astype(f32), f32(0.0))
            total_weight += w
            prev_color += w[..., None] * state.prev_out[syc, sxc]
        has = total_weight > 0
        tw = np.where(has, total_weight, f32(1.0))
        prev_color = prev_color / tw[..., None]
        blend_alpha = np.where(
            has,
            np.maximum(f32(1.0) / spp.astype(f32),
                       f32(cfg.second_blend_alpha)),
            f32(1.0)).astype(f32)

    out = (blend_alpha[..., None] * fcol
           + (f32(1.0) - blend_alpha)[..., None] * prev_color)
    tone = np.clip(np.power(np.maximum(0.0, albedo.astype(f32) * out),
                            f32(0.454545)), 0.0, 1.0).astype(f32)
    return out, tone


def _ycocg(c):
    """[..., 3] RGB -> YCoCg (opencl/bmfr.cl:184-190)."""
    r, g, b = c[..., 0], c[..., 1], c[..., 2]
    return np.stack([r + 2 * g + b, 2 * r - 2 * b, -r + 2 * g - b],
                    axis=-1).astype(f32)


def _rgb(c):
    """[..., 3] YCoCg -> RGB (opencl/bmfr.cl:192-198)."""
    y, co, cg = c[..., 0], c[..., 1], c[..., 2]
    return np.stack([0.25 * y + 0.25 * co - 0.25 * cg,
                     0.25 * y + 0.25 * cg,
                     0.25 * y - 0.25 * co - 0.25 * cg],
                    axis=-1).astype(f32)


def taa_vec(cfg, state, prev_pixels, new_frame, frame):
    """K5 dense (opencl/bmfr.cl:860-974)."""
    H, W = cfg.image_height, cfg.image_width
    new_color = new_frame.astype(f32)
    if frame == 0 or cfg.skip_taa:
        return new_color.copy()

    pfx = prev_pixels[..., 0].astype(f32)
    pfy = prev_pixels[..., 1].astype(f32)
    ix = np.floor(pfx).astype(np.int64)
    iy = np.floor(pfy).astype(np.int64)
    off_screen = (ix < -1) | (iy < -1) | (ix >= W) | (iy >= H)

    yc = _ycocg(new_color)
    mn_box = np.full((H, W, 3), np.inf, f32)
    mx_box = np.full((H, W, 3), -np.inf, f32)
    mn_cross = np.full((H, W, 3), np.inf, f32)
    mx_cross = np.full((H, W, 3), -np.inf, f32)
    padp = np.pad(yc, ((1, 1), (1, 1), (0, 0)), constant_values=np.inf)
    padm = np.pad(yc, ((1, 1), (1, 1), (0, 0)), constant_values=-np.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            sp = padp[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            sm = padm[1 + dy:1 + dy + H, 1 + dx:1 + dx + W]
            mn_box = np.minimum(mn_box, sp)
            mx_box = np.maximum(mx_box, sm)
            if dx == 0 or dy == 0:
                mn_cross = np.minimum(mn_cross, sp)
                mx_cross = np.maximum(mx_cross, sm)

    fx = (pfx - ix.astype(f32)).astype(f32)
    fy = (pfy - iy.astype(f32)).astype(f32)
    prev_color = np.zeros((H, W, 3), f32)
    total_weight = np.zeros((H, W), f32)
    taps = [((1 - fx) * (1 - fy), 0, 0, (iy >= 0) & (ix >= 0)),
            (fx * (1 - fy), 1, 0, (iy >= 0) & (ix < W - 1)),
            ((1 - fx) * fy, 0, 1, (iy < H - 1) & (ix >= 0)),
            (fx * fy, 1, 1, (iy < H - 1) & (ix < W - 1))]
    for wgt, dx, dy, on in taps:
        sxc = np.clip(ix + dx, 0, W - 1)
        syc = np.clip(iy + dy, 0, H - 1)
        w = np.where(on, wgt.astype(f32), f32(0.0))
        prev_color += w[..., None] * state.prev_result[syc, sxc]
        total_weight += w

    tw = np.where(total_weight > 0, total_weight, f32(1.0))
    prev_color = prev_color / tw[..., None]
    prev_yc = _ycocg(prev_color)
    mn = ((mn_box + mn_cross) / 2.0).astype(f32)
    mx = ((mx_box + mx_cross) / 2.0).astype(f32)
    prev_rgb = _rgb(np.clip(prev_yc, mn, mx))
    result = (f32(cfg.taa_blend_alpha) * new_color
              + (f32(1.0) - f32(cfg.taa_blend_alpha)) * prev_rgb)
    return np.where(off_screen[..., None], new_color, result).astype(f32)


def oracle_denoise_frame_vec(cfg, state, normals, positions, noisy,
                             albedo, prev_cam, pixel_offset, frame):
    """One frame of the 5-kernel chain (opencl/bmfr.cpp:417-485), dense;
    the fitter runs the literal per-block oracle."""
    k1 = accumulate_noisy_data_vec(cfg, state, normals, positions, noisy,
                                   prev_cam, pixel_offset, frame)
    tmp_prefit = k1["tmp"].copy()
    weights, mins_maxs = fitter(cfg, k1["tmp"], frame)
    filtered = weighted_sum_vec(cfg, weights, mins_maxs, normals,
                                positions, k1["accum"], frame)
    out, tone = accumulate_filtered_data_vec(
        cfg, state, filtered, k1["prev_pixels"], k1["accept"], albedo,
        k1["spp"], frame)
    result = taa_vec(cfg, state, k1["prev_pixels"], tone, frame)

    new_state = OracleState(
        prev_normals=normals.astype(f32),
        prev_positions=positions.astype(f32),
        prev_noisy=k1["accum"], prev_spp=k1["spp"],
        prev_out=out, prev_result=result)
    outputs = dict(
        accum=k1["accum"], spp=k1["spp"], prev_pixels=k1["prev_pixels"],
        accept=k1["accept"], tmp=tmp_prefit, weights=weights,
        mins_maxs=mins_maxs, filtered=filtered, out=out, tone=tone,
        result=result)
    return new_state, outputs


def oracle_denoise_sequence_vec(cfg, frames, camera_matrices,
                                pixel_offsets):
    """Frame sequence with the one-frame matrix lag
    (opencl/bmfr.cpp:440-444)."""
    H, W = cfg.image_height, cfg.image_width
    state = OracleState.initial(H, W)
    results = []
    for t, fr in enumerate(frames):
        prev_cam = camera_matrices[t - 1 if t > 0 else 0]
        state, outs = oracle_denoise_frame_vec(
            cfg, state, fr["normals"], fr["positions"], fr["noisy"],
            fr["albedo"], prev_cam, pixel_offsets[t], t)
        results.append(outs)
    return results
