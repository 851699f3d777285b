"""NumPy oracle: a literal re-statement of the reference kernel semantics.

A copy of :mod:`bmfr_tpu.oracle.reference`, kept here because the
card's host cannot import the JAX package; ``tests/test_torch_oracle.py``
pins it to the original. It is the ground truth the port is held to,
not code under test: nothing on the port's denoise path imports it.

It follows ``opencl/bmfr.cl`` statement by statement — per-pixel
Python loops over the margins grid for the accumulation stages,
per-block loops with the exact masked reductions for the fitter — and
is therefore only usable on tiny fixtures (e.g. 64x48). It shares **no
code** with the implementations under test (independent hash RNG copy
included) so that agreement between the two is meaningful.

Kernel mapping (reference -> here):
  accumulate_noisy_data  opencl/bmfr.cl:290-485 -> accumulate_noisy_data()
  fitter                 opencl/bmfr.cl:490-700 -> fitter()
  weighted_sum           opencl/bmfr.cl:703-758 -> weighted_sum()
  accumulate_filtered    opencl/bmfr.cl:761-857 -> accumulate_filtered_data()
  taa                    opencl/bmfr.cl:860-974 -> taa()

Images here are channels-last ``[H, W, 3]`` float32 numpy arrays (matching
the reference's interleaved buffers); the port is channels-first.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

# ----------------------------------------------------------------------
# Constants (opencl/bmfr.cl:267-285)
# ----------------------------------------------------------------------
_BLOCK_OFFSETS = [
    (-14, -14), (4, -6), (-8, 14), (8, 0),
    (-10, -8), (2, 12), (12, -12), (-10, 0),
    (12, 14), (-8, -16), (6, 6), (-2, -2),
    (6, -14), (-16, 12), (14, -4), (-6, 4),
]


def _mirror(index: int, size: int) -> int:
    """opencl/bmfr.cl:209-216."""
    if index < 0:
        return abs(index) - 1
    if index >= size:
        return 2 * size - index - 1
    return index


def _hash_random(a: int) -> np.float32:
    """uint32 hash -> f32 uniform [0,1]; opencl/bmfr.cl:162-171 (numpy twin)."""
    a = np.uint32(a)
    with np.errstate(over="ignore"):
        a = np.uint32(a + np.uint32(0x7ED55D16)) + np.uint32(a << np.uint32(12))
        a = np.uint32(a ^ np.uint32(0xC761C23C)) ^ np.uint32(a >> np.uint32(19))
        a = np.uint32(a + np.uint32(0x165667B1)) + np.uint32(a << np.uint32(5))
        a = np.uint32(a + np.uint32(0xD3A2646C)) ^ np.uint32(a << np.uint32(9))
        a = np.uint32(a + np.uint32(0xFD7046C5)) + np.uint32(a << np.uint32(3))
        a = np.uint32(a ^ np.uint32(0xB55A4F09)) ^ np.uint32(a >> np.uint32(16))
    return np.float32(a) / np.float32(np.uint32(0xFFFFFFFF))


def _add_random(value, index, feature, frame, cfg):
    """opencl/bmfr.cl:173-182 with element index = id + sub_vector*256."""
    seed = index + feature * cfg.block_pixels + frame * cfg.buffer_count * cfg.block_pixels
    return np.float32(value) + np.float32(cfg.noise_amount) * np.float32(2.0) * (
        _hash_random(seed) - np.float32(0.5)
    )


def _noise_vector(feature, frame, cfg):
    """Vectorized noise for one feature column (seeds as in _add_random)."""
    base = feature * cfg.block_pixels + frame * cfg.buffer_count * cfg.block_pixels
    return np.array(
        [
            np.float32(cfg.noise_amount) * np.float32(2.0)
            * (_hash_random(base + e) - np.float32(0.5))
            for e in range(cfg.block_pixels)
        ],
        dtype=np.float32,
    )


def _scale(value, vmin, vmax):
    """opencl/bmfr.cl:200-205."""
    if abs(vmax - vmin) > 1.0:
        return (value - vmin) / (vmax - vmin)
    return value - vmin


def _rgb_to_ycocg(c):
    """opencl/bmfr.cl:184-190."""
    return np.array(
        [c[0] + 2 * c[1] + c[2], 2 * c[0] - 2 * c[2], -c[0] + 2 * c[1] - c[2]],
        dtype=np.float32,
    )


def _ycocg_to_rgb(c):
    """opencl/bmfr.cl:192-198."""
    return np.array(
        [
            0.25 * c[0] + 0.25 * c[1] - 0.25 * c[2],
            0.25 * c[0] + 0.25 * c[2],
            0.25 * c[0] - 0.25 * c[1] - 0.25 * c[2],
        ],
        dtype=np.float32,
    )


def _eval_features(name, normal, wp):
    """Default feature expressions (opencl/bmfr.cpp:65-77)."""
    table = {
        "const": 1.0,
        "normal_x": normal[0], "normal_y": normal[1], "normal_z": normal[2],
        "world_position_x": wp[0], "world_position_y": wp[1],
        "world_position_z": wp[2],
        "world_position_x2": wp[0] * wp[0],
        "world_position_y2": wp[1] * wp[1],
        "world_position_z2": wp[2] * wp[2],
    }
    return np.float32(table[name])


def _store_tmp(value, cfg):
    """fp16 round-trip when tmp_data is half (opencl/bmfr.cl:255-265)."""
    if cfg.tmp_data_dtype == "float16":
        return np.float32(np.float16(value))
    return np.float32(value)


@dataclasses.dataclass
class OracleState:
    """The six double-buffered recurrent buffers (opencl/bmfr.cpp:345-347)."""

    prev_normals: np.ndarray    # [H, W, 3]
    prev_positions: np.ndarray  # [H, W, 3]
    prev_noisy: np.ndarray      # [H, W, 3] accumulated noisy color
    prev_spp: np.ndarray        # [H, W] uint8
    prev_out: np.ndarray        # [H, W, 3] accumulated filtered color
    prev_result: np.ndarray     # [H, W, 3] TAA output

    @classmethod
    def initial(cls, H, W):
        z = lambda c=3: np.zeros((H, W, c), np.float32)
        return cls(z(), z(), z(), np.zeros((H, W), np.uint8), z(), z())


# ----------------------------------------------------------------------
# K1: accumulate_noisy_data (opencl/bmfr.cl:290-485)
# ----------------------------------------------------------------------
def accumulate_noisy_data(cfg, state, normals, positions, noisy,
                          prev_cam, pixel_offset, frame):
    H, W = cfg.image_height, cfg.image_width
    mw, mh = cfg.workset_with_margins_width, cfg.workset_with_margins_height
    be = cfg.block_edge
    half = be // 2
    ox, oy = _BLOCK_OFFSETS[frame % 16]

    accum = noisy.astype(np.float32).copy()
    spp = np.zeros((H, W), np.uint8)
    prev_pixels = np.zeros((H, W, 2), np.float32)
    accept = np.zeros((H, W), np.uint8)
    tmp = np.zeros((cfg.n_blocks, cfg.buffer_count, cfg.block_pixels), np.float32)

    feat_names = list(cfg.all_features)

    for gy in range(mh):
        for gx in range(mw):
            pwm_x = gx - half + ox
            pwm_y = gy - half + oy
            px = _mirror(pwm_x, W)
            py = _mirror(pwm_y, H)

            wp = positions[py, px].astype(np.float32)
            normal = normals[py, px].astype(np.float32)
            cur_color = noisy[py, px].astype(np.float32)

            prev_pixel_f = np.array([px, py], np.float32)
            store_accept = 0
            blend_alpha = np.float32(1.0)
            prev_color = np.zeros(3, np.float32)
            sample_spp = np.float32(0.0)

            if frame > 0:
                wp4 = np.array([wp[0], wp[1], wp[2], 1.0], np.float32)
                # s048c/s159d/s37bf = columns of the stored [4][4] matrix
                # (opencl/bmfr.cl:342-347). All math in f32 like the device.
                u = np.float32(prev_cam[:, 0] @ wp4)
                v = np.float32(prev_cam[:, 1] @ wp4)
                w = np.float32(prev_cam[:, 3] @ wp4)
                uvx = (u / w + np.float32(1.0)) / np.float32(2.0) * np.float32(W)
                uvy = (v / w + np.float32(1.0)) / np.float32(2.0) * np.float32(H)
                uvx = np.float32(uvx - np.float32(pixel_offset[0]))
                uvy = np.float32(uvy - (np.float32(1.0) - np.float32(pixel_offset[1])))
                prev_pixel_f = np.array([uvx, uvy], np.float32)
                ix = math.floor(uvx)
                iy = math.floor(uvy)
                fx = np.float32(uvx - np.float32(ix))
                fy = np.float32(uvy - np.float32(iy))
                weights = [
                    (1 - fx) * (1 - fy), fx * (1 - fy),
                    (1 - fx) * fy, fx * fy,
                ]
                offsets = [(0, 0), (1, 0), (0, 1), (1, 1)]
                total_weight = np.float32(0.0)
                for i, (dx, dy) in enumerate(offsets):
                    sx, sy = ix + dx, iy + dy
                    if 0 <= sx < W and 0 <= sy < H:
                        pos_diff = state.prev_positions[sy, sx] - wp
                        if float(pos_diff @ pos_diff) < cfg.position_limit_squared:
                            nrm_diff = state.prev_normals[sy, sx] - normal
                            if float(nrm_diff @ nrm_diff) < cfg.normal_limit_squared:
                                store_accept |= 1 << i
                                wgt = np.float32(weights[i])
                                sample_spp += wgt * np.float32(state.prev_spp[sy, sx])
                                prev_color += wgt * state.prev_noisy[sy, sx]
                                total_weight += wgt
                if total_weight > 0:
                    prev_color /= total_weight
                    sample_spp /= total_weight
                    blend_alpha = max(
                        np.float32(1.0) / (sample_spp + np.float32(1.0)),
                        np.float32(cfg.blend_alpha),
                    )

            # Store new spp (opencl/bmfr.cl:432-442)
            new_spp = 1
            if blend_alpha < 1.0:
                if sample_spp > 254.0:
                    new_spp = 255
                else:
                    # convert_uchar_sat_rte: round half-to-even + saturate
                    new_spp = int(np.rint(sample_spp)) + 1

            new_color = blend_alpha * cur_color + (1.0 - blend_alpha) * prev_color

            # Feature vector (opencl/bmfr.cl:447-453)
            feats = [_eval_features(n, normal, wp) for n in feat_names]
            feats += [new_color[0], new_color[1], new_color[2]]

            # Block-interleaved store (opencl/bmfr.cl:455-476)
            x_in, y_in = gx % be, gy % be
            x_blk, y_blk = gx // be, gy // be
            block = y_blk * cfg.blocks_x + x_blk
            elem = x_in + y_in * be
            for f, value in enumerate(feats):
                v = np.float32(value)
                if np.isnan(v):
                    v = np.float32(0.0)
                if cfg.tmp_data_dtype == "float16":
                    v = np.clip(v, -65504.0, 65504.0)
                tmp[block, f, elem] = _store_tmp(v, cfg)

            # Outputs only for the unique in-image writer (opencl/bmfr.cl:478-484)
            if 0 <= pwm_x < W and 0 <= pwm_y < H:
                accum[py, px] = new_color
                prev_pixels[py, px] = prev_pixel_f
                spp[py, px] = new_spp
                accept[py, px] = store_accept

    return dict(accum=accum, spp=spp, prev_pixels=prev_pixels,
                accept=accept, tmp=tmp)


# ----------------------------------------------------------------------
# K2: fitter (opencl/bmfr.cl:490-700)
# ----------------------------------------------------------------------
def fitter(cfg, tmp, frame):
    """In-place block fit. Returns (weights [n_blocks, F, 3], mins_maxs)."""
    buffers = cfg.buffer_count
    F = cfg.feature_count            # buffers - 3
    r_edge = buffers - 2
    bp = cfg.block_pixels
    n_sc = cfg.features_scaled_count

    weights_out = np.zeros((cfg.n_blocks, F, 3), np.float32)
    mins_maxs = np.zeros((cfg.n_blocks, n_sc, 2), np.float32)

    for g in range(cfg.n_blocks):
        data = tmp[g]  # [buffers, bp], modified in place

        # --- per-block min/max scaling (opencl/bmfr.cl:511-542) ---
        for f in range(cfg.features_not_scaled_count, buffers - 3):
            bmin = np.float32(data[f].min())
            bmax = np.float32(data[f].max())
            mins_maxs[g, f - cfg.features_not_scaled_count] = (bmin, bmax)
            if abs(bmax - bmin) > 1.0:
                scaled = (data[f] - bmin) / (bmax - bmin)
            else:
                scaled = data[f] - bmin
            if cfg.tmp_data_dtype == "float16":
                scaled = np.float32(np.float16(scaled))
            data[f] = scaled.astype(np.float32)

        # --- Householder QR (opencl/bmfr.cl:546-656) ---
        # R[x][y][channel]; float3 entries broadcast across channels.
        R = np.zeros((r_edge, r_edge, 3), np.float32)
        limit = buffers - 1 if buffers == bp else buffers
        noised = np.zeros(buffers, bool)  # noise applied once per column

        for col in range(limit):
            col_limited = min(col, buffers - 3)
            u_vec = data[col].astype(np.float32).copy()
            idx = np.arange(bp)
            vec_length = np.float32(np.sum(
                (u_vec * u_vec)[idx >= col_limited + 1], dtype=np.float32))
            u_length_squared = vec_length
            vec_length = np.float32(
                math.sqrt(vec_length + u_vec[col_limited] * u_vec[col_limited]))
            u_vec_head = np.float32(u_vec[col_limited] - vec_length)
            u_length_squared = np.float32(
                u_length_squared + u_vec_head * u_vec_head)

            # r_value stores (opencl/bmfr.cl:574-600):
            #   id < col: copy of u_vec[id]; id == col: vec_length; else 0
            for wid in range(r_edge + 2):  # ids beyond r_edge write junk slots
                if wid < col:
                    r_value = u_vec[wid]
                elif wid == col:
                    r_value = vec_length
                else:
                    r_value = np.float32(0.0)
                id_limited = min(wid, buffers - 3)
                if col < buffers - 3:
                    R[col_limited, id_limited] = r_value
                else:
                    R[col_limited, id_limited, col - (buffers - 3)] = r_value

            # Householder u with masked head (reference keeps u_vec[i<col]
            # in local memory but excludes them via index guards)
            u = u_vec.copy()
            u[col_limited] = u_vec_head
            u[idx < col_limited] = 0.0

            # Transform further columns (opencl/bmfr.cl:606-655).
            # Element loops vectorized; the masks and the noise-once
            # (CACHE_TMP_DATA=1) semantics follow the reference literally.
            mask = idx >= col_limited
            for f in range(col_limited + 1, buffers):
                vals = data[f].astype(np.float32).copy()
                if col == 0 and f < buffers - 3 and not noised[f]:
                    vals = vals + _noise_vector(f, frame, cfg)
                    noised[f] = True
                dot = np.float32(np.sum((vals * u)[mask], dtype=np.float32))
                newvals = vals - np.float32(2.0) * u * dot / u_length_squared
                data[f] = np.where(
                    mask,
                    np.array([_store_tmp(v, cfg) for v in newvals], np.float32)
                    if cfg.tmp_data_dtype == "float16" else newvals,
                    data[f])

        # --- back substitution (opencl/bmfr.cl:658-692), literal in-place ---
        for i in range(r_edge - 2, -1, -1):
            divider = R[i, i].copy()
            for wid in range(r_edge):
                if wid >= i:  # COMPRESSED_R guard (opencl/bmfr.cl:665)
                    R[wid, i] = R[wid, i] / divider
            for j in range(i + 1, r_edge - 1):
                R[r_edge - 1, i] = R[r_edge - 1, i] - R[j, i]
            for wid in range(r_edge):
                if i >= wid:  # COMPRESSED_R guard (opencl/bmfr.cl:683)
                    R[i, wid] = R[i, wid] * R[r_edge - 1, i]

        for wid in range(buffers - 3):
            weights_out[g, wid] = R[r_edge - 1, wid]

    return weights_out, mins_maxs


# ----------------------------------------------------------------------
# K3: weighted_sum (opencl/bmfr.cl:703-758)
# ----------------------------------------------------------------------
def weighted_sum(cfg, weights, mins_maxs, normals, positions, noisy, frame):
    H, W = cfg.image_height, cfg.image_width
    be = cfg.block_edge
    half = be // 2
    ox, oy = _BLOCK_OFFSETS[frame % 16]
    out = np.zeros((H, W, 3), np.float32)
    names = list(cfg.all_features)
    nns = cfg.features_not_scaled_count

    for py in range(H):
        for px in range(W):
            opx, opy = px + half - ox, py + half - oy
            group = (opx // be) + (opy // be) * cfg.blocks_x
            wp = positions[py, px].astype(np.float32)
            normal = normals[py, px].astype(np.float32)
            color = np.zeros(3, np.float32)
            for f, name in enumerate(names):
                feat = _eval_features(name, normal, wp)
                if f >= nns:
                    bmin, bmax = mins_maxs[group, f - nns]
                    feat = _scale(feat, bmin, bmax)
                color += weights[group, f] * np.float32(feat)
            color = np.where(color < 0.0, 0.0, color)
            if cfg.skip_fitting:  # debug bypass (opencl/bmfr.cl:752-754)
                color = noisy[py, px]
            out[py, px] = color
    return out


# ----------------------------------------------------------------------
# K4: accumulate_filtered_data (opencl/bmfr.cl:761-857)
# ----------------------------------------------------------------------
def accumulate_filtered_data(cfg, state, filtered, prev_pixels, accept,
                             albedo, spp, frame):
    H, W = cfg.image_height, cfg.image_width
    out = np.zeros((H, W, 3), np.float32)
    tone = np.zeros((H, W, 3), np.float32)

    for py in range(H):
        for px in range(W):
            fcol = filtered[py, px].astype(np.float32)
            prev_color = np.zeros(3, np.float32)
            blend_alpha = np.float32(1.0)
            if frame > 0 and not cfg.skip_second_accum:
                acc = int(accept[py, px])
                if acc > 0:
                    pfx, pfy = prev_pixels[py, px]
                    ix, iy = math.floor(pfx), math.floor(pfy)
                    fx, fy = pfx - ix, pfy - iy
                    taps = [
                        (0x01, (1 - fx) * (1 - fy), ix, iy),
                        (0x02, fx * (1 - fy), ix + 1, iy),
                        (0x04, (1 - fx) * fy, ix, iy + 1),
                        (0x08, fx * fy, ix + 1, iy + 1),
                    ]
                    total_weight = np.float32(0.0)
                    for bit, wgt, sx, sy in taps:
                        if acc & bit:
                            total_weight += np.float32(wgt)
                            prev_color += np.float32(wgt) * state.prev_out[sy, sx]
                    if total_weight > 0:
                        blend_alpha = max(
                            np.float32(1.0) / np.float32(spp[py, px]),
                            np.float32(cfg.second_blend_alpha),
                        )
                        prev_color /= total_weight
            accum = blend_alpha * fcol + (1.0 - blend_alpha) * prev_color
            out[py, px] = accum
            alb = albedo[py, px].astype(np.float32)
            tone[py, px] = np.clip(
                np.power(np.maximum(0.0, alb * accum), 0.454545), 0.0, 1.0)
    return out, tone


# ----------------------------------------------------------------------
# K5: taa (opencl/bmfr.cl:860-974)
# ----------------------------------------------------------------------
def taa(cfg, state, prev_pixels, new_frame, frame):
    H, W = cfg.image_height, cfg.image_width
    result = np.zeros((H, W, 3), np.float32)

    for py in range(H):
        for px in range(W):
            new_color = new_frame[py, px].astype(np.float32)
            pfx, pfy = prev_pixels[py, px]
            ix, iy = math.floor(pfx), math.floor(pfy)
            if (frame == 0 or cfg.skip_taa or ix < -1 or iy < -1
                    or ix >= W or iy >= H):
                result[py, px] = new_color
                continue

            mn_box = np.full(3, np.inf, np.float32)
            mn_cross = np.full(3, np.inf, np.float32)
            mx_box = np.full(3, -np.inf, np.float32)
            mx_cross = np.full(3, -np.inf, np.float32)
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    sx, sy = px + dx, py + dy
                    if 0 <= sx < W and 0 <= sy < H:
                        c = (new_color if dx == 0 and dy == 0
                             else new_frame[sy, sx].astype(np.float32))
                        c = _rgb_to_ycocg(c)
                        if dx == 0 or dy == 0:
                            mn_cross = np.minimum(mn_cross, c)
                            mx_cross = np.maximum(mx_cross, c)
                        mn_box = np.minimum(mn_box, c)
                        mx_box = np.maximum(mx_box, c)

            fx, fy = pfx - ix, pfy - iy
            prev_color = np.zeros(3, np.float32)
            total_weight = np.float32(0.0)
            if iy >= 0:
                if ix >= 0:
                    w = (1 - fx) * (1 - fy)
                    prev_color += w * state.prev_result[iy, ix]
                    total_weight += np.float32(w)
                if ix < W - 1:
                    w = fx * (1 - fy)
                    prev_color += w * state.prev_result[iy, ix + 1]
                    total_weight += np.float32(w)
            if iy < H - 1:
                if ix >= 0:
                    w = (1 - fx) * fy
                    prev_color += w * state.prev_result[iy + 1, ix]
                    total_weight += np.float32(w)
                if ix < W - 1:
                    w = fx * fy
                    prev_color += w * state.prev_result[iy + 1, ix + 1]
                    total_weight += np.float32(w)

            prev_color /= total_weight
            prev_ycocg = _rgb_to_ycocg(prev_color)
            mn = (mn_box + mn_cross) / 2.0
            mx = (mx_box + mx_cross) / 2.0
            prev_rgb = _ycocg_to_rgb(np.clip(prev_ycocg, mn, mx))
            result[py, px] = (cfg.taa_blend_alpha * new_color
                              + (1.0 - cfg.taa_blend_alpha) * prev_rgb)
    return result


# ----------------------------------------------------------------------
# Full frame (the per-frame chain of opencl/bmfr.cpp:417-485)
# ----------------------------------------------------------------------
def oracle_denoise_frame(cfg, state, normals, positions, noisy, albedo,
                         prev_cam, pixel_offset, frame):
    """Run the 5-kernel chain for one frame. Returns (new_state, outputs)."""
    k1 = accumulate_noisy_data(cfg, state, normals, positions, noisy,
                               prev_cam, pixel_offset, frame)
    tmp_prefit = k1["tmp"].copy()
    weights, mins_maxs = fitter(cfg, k1["tmp"], frame)
    filtered = weighted_sum(cfg, weights, mins_maxs, normals, positions,
                            k1["accum"], frame)
    out, tone = accumulate_filtered_data(
        cfg, state, filtered, k1["prev_pixels"], k1["accept"], albedo,
        k1["spp"], frame)
    result = taa(cfg, state, k1["prev_pixels"], tone, frame)

    new_state = OracleState(
        prev_normals=normals.astype(np.float32),
        prev_positions=positions.astype(np.float32),
        prev_noisy=k1["accum"],
        prev_spp=k1["spp"],
        prev_out=out,
        prev_result=result,
    )
    outputs = dict(
        accum=k1["accum"], spp=k1["spp"], prev_pixels=k1["prev_pixels"],
        accept=k1["accept"], tmp=tmp_prefit, weights=weights,
        mins_maxs=mins_maxs, filtered=filtered, out=out, tone=tone,
        result=result,
    )
    return new_state, outputs


def oracle_denoise_sequence(cfg, frames, camera_matrices, pixel_offsets):
    """Run a frame sequence; frame N is reprojected with matrix N-1
    (opencl/bmfr.cpp:440-444)."""
    H, W = cfg.image_height, cfg.image_width
    state = OracleState.initial(H, W)
    results = []
    for t, fr in enumerate(frames):
        prev_cam = camera_matrices[t - 1 if t > 0 else 0]
        state, outs = oracle_denoise_frame(
            cfg, state, fr["normals"], fr["positions"], fr["noisy"],
            fr["albedo"], prev_cam, pixel_offsets[t], t)
        results.append(outs)
    return results
