"""The benchmark's plain reference: one BMFR frame in plain PyTorch.

A restatement of the reference's five kernels (``opencl/bmfr.cl``:
accumulate_noisy_data :290-485, fitter :490-700, weighted_sum :703-758,
accumulate_filtered_data :761-857, taa :860-974) in the order and the
float32 arithmetic that the NumPy oracle (:mod:`.oracle_reference`,
:mod:`.oracle_reference_vec`) gives them, as dense tensor programs that
run at 1280x720 on the card. It imports nothing of the program under
test: the program's outputs are only what it is compared with.

What a configuration states beyond the oracle, the reference states too
(:class:`Settings`): a state stored in bfloat16 (the bf16 channel-pair
pack, which rounds every stored channel to bf16, nearest-even) and a
TAA neighbourhood scanned on bf16 values (``residual_dtype``). The fit
is the oracle's Householder QR whatever the program's solver: the least-
squares solution is the contract.

Every inner product of the fit and of the reconstruction is a batched
matrix product (:func:`_mm`) in one of two precisions: ``"highest"``,
float32 with TF32 off (the reference), or ``"tf32"``, each operand
rounded to TF32 (10 mantissa bits, to nearest) as the tensor cores take
it and the sums in float32: the control, the step below the float32 that
the configurations state. The operands are rounded here, not left to
cuBLAS, whose kernel for a product this thin may not use the tensor
cores at all.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

#: the jitter of the block grid, by frame mod 16 (opencl/bmfr.cl:267-285)
BLOCK_OFFSETS = (
    (-14, -14), (4, -6), (-8, 14), (8, 0),
    (-10, -8), (2, 12), (12, -12), (-10, 0),
    (12, 14), (-8, -16), (6, 6), (-2, -2),
    (6, -14), (-16, 12), (14, -4), (-6, 4),
)
#: the default feature basis (opencl/bmfr.cpp:65-77), unscaled then scaled
FEATURES_NOT_SCALED = ("const", "normal_x", "normal_y", "normal_z")
FEATURES_SCALED = ("world_position_x", "world_position_y",
                   "world_position_z", "world_position_x2",
                   "world_position_y2", "world_position_z2")
#: the stored state's channels, in order
STATE_FIELDS = ("positions", "normals", "noisy", "spp", "out", "result")

_M32 = 0xFFFFFFFF


@dataclasses.dataclass(frozen=True)
class Settings:
    """What one frame computes: the oracle's configuration keys and what
    a configuration states beyond them."""

    image_width: int
    image_height: int
    block_edge: int = 32
    noise_amount: float = 1e-2
    blend_alpha: float = 0.2
    second_blend_alpha: float = 0.1
    taa_blend_alpha: float = 0.2
    position_limit_squared: float = 0.01
    normal_limit_squared: float = 1.0
    tmp_data_dtype: str = "float32"
    #: the dtype the carried state is stored in ("float32" or "bfloat16")
    state_dtype: str = "float32"
    #: the dtype of the TAA neighbourhood scan ("float32" or "bfloat16")
    residual_dtype: str = "float32"
    features_not_scaled: tuple = FEATURES_NOT_SCALED
    features_scaled: tuple = FEATURES_SCALED
    skip_fitting: bool = False
    skip_second_accum: bool = False
    skip_taa: bool = False

    @property
    def block_pixels(self):
        return self.block_edge * self.block_edge

    @property
    def workset_with_margins_width(self):
        b = self.block_edge
        return b * ((self.image_width + b - 1) // b) + b

    @property
    def workset_with_margins_height(self):
        b = self.block_edge
        return b * ((self.image_height + b - 1) // b) + b

    @property
    def blocks_x(self):
        return self.workset_with_margins_width // self.block_edge

    @property
    def blocks_y(self):
        return self.workset_with_margins_height // self.block_edge

    @property
    def n_blocks(self):
        return self.blocks_x * self.blocks_y

    @property
    def features_not_scaled_count(self):
        return len(self.features_not_scaled)

    @property
    def features_scaled_count(self):
        return len(self.features_scaled)

    @property
    def feature_count(self):
        return len(self.features_not_scaled) + len(self.features_scaled)

    @property
    def buffer_count(self):
        return self.feature_count + 3

    @property
    def all_features(self):
        return tuple(self.features_not_scaled) + tuple(self.features_scaled)


def settings_from_config(config):
    """:class:`Settings` of a benchmark configuration file's dict: its
    ``bmfr`` keys that the oracle reads, ``state_dtype`` and
    ``residual_dtype``."""
    names = {f.name for f in dataclasses.fields(Settings)}
    kw = {k: v for k, v in config["bmfr"].items() if k in names}
    for k in ("features_not_scaled", "features_scaled"):
        if k in kw:
            kw[k] = tuple(kw[k])
    kw["state_dtype"] = config["state_dtype"]
    return Settings(**kw)


PRECISIONS = ("highest", "tf32")


@contextlib.contextmanager
def tf32_off():
    """float32 matrix products without TF32 for the duration of the
    block."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev[0]
        torch.backends.cudnn.allow_tf32 = prev[1]
        torch.set_float32_matmul_precision(prev[2])


def to_tf32(x):
    """float32 ``x`` rounded to TF32: 10 mantissa bits, to nearest, ties
    to even."""
    i = x.contiguous().view(torch.int32)
    r = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return torch.where(torch.isfinite(x), r.view(torch.float32), x)


def _mm(a, b, precision):
    """``torch.bmm(a, b)`` in ``precision`` (:data:`PRECISIONS`); call it
    inside :func:`tf32_off`."""
    if precision not in PRECISIONS:
        raise ValueError(f"bad precision {precision!r}")
    if precision == "tf32":
        a, b = to_tf32(a), to_tf32(b)
    return torch.bmm(a, b)


def _f32(x):
    """A Python float rounded to float32, as the kernels' constants are."""
    return float(torch.tensor(x, dtype=torch.float32))


def store(s, x):
    """``x`` as the state stores it: f32, or rounded to bf16."""
    if s.state_dtype == "bfloat16":
        return x.to(torch.bfloat16).float()
    if s.state_dtype != "float32":
        raise ValueError(f"bad state dtype {s.state_dtype!r}")
    return x


def zero_state(s, device):
    """The all-zero state (a frame without history never reads it):
    ``{field: f32 tensor}``, spp as f32 ``[H, W]``."""
    H, W = s.image_height, s.image_width
    z = {k: torch.zeros((3, H, W), dtype=torch.float32, device=device)
         for k in STATE_FIELDS}
    z["spp"] = torch.zeros((H, W), dtype=torch.float32, device=device)
    return z


def _floor_int(x):
    """floor as int64, NaN to 0 and clamped to the int32 range, so that
    an index built from it never overflows."""
    f = torch.floor(x)
    f = torch.where(torch.isnan(f), 0.0, f).clamp(-(2.0**31), 2.0**31 - 128)
    return f.to(torch.int64)


def _gather(planes, yi, xi):
    """``planes[..., clip(yi), clip(xi)]`` of ``[C, H, W]`` planes at
    int64 ``[H, W]`` indices."""
    H, W = planes.shape[-2:]
    idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    flat = planes.reshape(planes.shape[0], H * W)
    return flat[:, idx.reshape(-1)].reshape(planes.shape[0], H, W)


def _taps(pfx, pfy):
    """floor and fractions of the reprojected coordinates, and the four
    bilinear taps ``(weight, dx, dy)`` in the reference's order
    (opencl/bmfr.cl:356-370)."""
    ix, iy = _floor_int(pfx), _floor_int(pfy)
    fx = pfx - ix.float()
    fy = pfy - iy.float()
    taps = (((1 - fx) * (1 - fy), 0, 0), (fx * (1 - fy), 1, 0),
            ((1 - fx) * fy, 0, 1), (fx * fy, 1, 1))
    return ix, iy, taps


def reproject(s, positions, prev_cam, pixel_offset, history):
    """The previous frame's pixel coordinates ``(pfx, pfy)`` of every
    pixel (opencl/bmfr.cl:338-356); a frame without history records
    each pixel's own (:324-325)."""
    H, W = s.image_height, s.image_width
    dev = positions.device
    if not history:
        ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                                torch.arange(W, device=dev), indexing="ij")
        return xs.float(), ys.float()
    m = prev_cam
    wp = positions

    def col(c):
        return wp[0] * m[0, c] + wp[1] * m[1, c] + wp[2] * m[2, c] + m[3, c]

    u, v, w = col(0), col(1), col(3)
    pfx = (u / w + 1.0) / 2.0 * W - pixel_offset[0]
    pfy = (v / w + 1.0) / 2.0 * H - (1.0 - pixel_offset[1])
    return pfx, pfy


def accumulate_noisy(s, state, positions, normals, noisy, pfx, pfy,
                     history):
    """K1 at every image pixel (opencl/bmfr.cl:290-485): the accumulated
    colour, the new spp (f32 of the u8), the accept bits."""
    H, W = s.image_height, s.image_width
    dev = noisy.device
    prev_color = torch.zeros((3, H, W), dtype=torch.float32, device=dev)
    sample_spp = torch.zeros((H, W), dtype=torch.float32, device=dev)
    total = torch.zeros((H, W), dtype=torch.float32, device=dev)
    accept = torch.zeros((H, W), dtype=torch.int32, device=dev)
    if history:
        ix, iy, taps = _taps(pfx, pfy)
        plim = _f32(s.position_limit_squared)
        nlim = _f32(s.normal_limit_squared)
        prev = torch.cat([state["positions"], state["normals"],
                          state["noisy"], state["spp"][None]])
        for i, (wgt, dx, dy) in enumerate(taps):
            sx, sy = ix + dx, iy + dy
            inb = (sx >= 0) & (sx < W) & (sy >= 0) & (sy < H)
            t = _gather(prev, sy, sx)
            pd = t[0:3] - positions
            nd = t[3:6] - normals
            ok = (inb & ((pd[0] * pd[0] + pd[1] * pd[1] + pd[2] * pd[2])
                         < plim)
                  & ((nd[0] * nd[0] + nd[1] * nd[1] + nd[2] * nd[2])
                     < nlim))
            w = torch.where(ok, wgt, 0.0)
            sample_spp = sample_spp + w * t[9]
            prev_color = prev_color + w[None] * t[6:9]
            total = total + w
            accept = accept | (ok.to(torch.int32) << i)
    has = total > 0
    tw = torch.where(has, total, 1.0)
    prev_color = prev_color / tw[None]
    sample_spp = sample_spp / tw
    alpha = torch.where(
        has, torch.clamp_min(1.0 / (sample_spp + 1.0), _f32(s.blend_alpha)),
        1.0)
    # convert_uchar_sat_rte + saturation (opencl/bmfr.cl:432-442)
    new_spp = torch.where(
        alpha < 1.0,
        torch.where(sample_spp > 254.0, 255.0,
                    torch.round(sample_spp).clamp(0, 254) + 1.0), 1.0)
    accum = alpha[None] * noisy + (1.0 - alpha)[None] * prev_color
    return accum, new_spp, accept


def _features(s, positions, normals):
    """The basis at every pixel, f32 ``[F, H, W]`` (opencl/bmfr.cpp:
    65-77)."""
    x, y, z = positions[0], positions[1], positions[2]
    table = {"const": torch.ones_like(x),
             "normal_x": normals[0], "normal_y": normals[1],
             "normal_z": normals[2],
             "world_position_x": x, "world_position_y": y,
             "world_position_z": z, "world_position_x2": x * x,
             "world_position_y2": y * y, "world_position_z2": z * z}
    return torch.stack([table[n] for n in s.all_features])


def _mirror(idx, size):
    """opencl/bmfr.cl:209-216."""
    idx = torch.where(idx < 0, idx.abs() - 1, idx)
    return torch.where(idx >= size, 2 * size - idx - 1, idx)


def hash_uniform(a):
    """uint32 hash -> f32 in [0, 1] (opencl/bmfr.cl:162-171), in int64
    with every step kept to 32 bits."""
    a = a.to(torch.int64) & _M32
    a = ((a + 0x7ED55D16) + (a << 12)) & _M32
    a = ((a ^ 0xC761C23C) ^ (a >> 19)) & _M32
    a = ((a + 0x165667B1) + (a << 5)) & _M32
    a = ((a + 0xD3A2646C) ^ (a << 9)) & _M32
    a = ((a + 0xFD7046C5) + (a << 3)) & _M32
    a = ((a ^ 0xB55A4F09) ^ (a >> 16)) & _M32
    return a.to(torch.float32) / _f32(float(_M32))


def fit_noise(s, frame, device):
    """The noise the fit adds to the feature columns 1.. of every block
    (opencl/bmfr.cl:173-182, :625-627): f32 ``[F, bp]``, row 0 zero."""
    bp = s.block_pixels
    e = torch.arange(bp, dtype=torch.int64, device=device)[None]
    f = torch.arange(s.feature_count, dtype=torch.int64, device=device)[:, None]
    seed = e + f * bp + (frame & _M32) * s.buffer_count * bp
    amp = _f32(_f32(s.noise_amount) * 2.0)
    noise = amp * (hash_uniform(seed) - 0.5)
    noise[0] = 0.0
    return noise


def blocks_of(s, feats, accum, frame):
    """The jittered, mirror-addressed blocks ``f32[n_blocks, B, bp]`` of
    the features and the accumulated colour (opencl/bmfr.cl:447-476),
    NaN stored as 0 and half precision as its store rounds it."""
    H, W = s.image_height, s.image_width
    be, half = s.block_edge, s.block_edge // 2
    ox, oy = BLOCK_OFFSETS[frame % 16]
    dev = accum.device
    rows = _mirror(torch.arange(s.workset_with_margins_height, device=dev)
                   - half + oy, H)
    cols = _mirror(torch.arange(s.workset_with_margins_width, device=dev)
                   - half + ox, W)
    planes = torch.cat([feats, accum])
    planes = torch.where(torch.isnan(planes), 0.0, planes)
    if s.tmp_data_dtype == "float16":
        planes = planes.clamp(-65504.0, 65504.0).half().float()
    elif s.tmp_data_dtype != "float32":
        raise ValueError(f"tmp dtype {s.tmp_data_dtype!r} is not stated by "
                         "the oracle")
    view = planes[:, rows[:, None], cols[None, :]]
    B = view.shape[0]
    return (view.reshape(B, s.blocks_y, be, s.blocks_x, be)
            .permute(1, 3, 0, 2, 4).reshape(s.n_blocks, B, s.block_pixels))


def _round_tmp(s, x):
    return x.half().float() if s.tmp_data_dtype == "float16" else x


def fit(s, data, frame, precision="highest"):
    """The fitter (opencl/bmfr.cl:490-700): the min/max rescale of the
    scaled features, the noise, the Householder QR of the feature
    columns (``vec_length`` and ``u_head = u[col] - vec_length`` as the
    reference takes them) and its back substitution. The reflections of
    the colour columns touch rows the solve never reads and are left
    out. Returns ``(weights f32[n_blocks, F, 3], mins_maxs f32[n_blocks,
    n_scaled, 2])``."""
    F, nns = s.feature_count, s.features_not_scaled_count
    bp = s.block_pixels
    sub = data[:, nns:F]
    bmin = sub.amin(dim=-1, keepdim=True)
    bmax = sub.amax(dim=-1, keepdim=True)
    span = bmax - bmin
    scaled = torch.where(span.abs() > 1.0, (sub - bmin) / span, sub - bmin)
    mins_maxs = torch.cat([bmin, bmax], dim=-1)
    A = torch.cat([data[:, :nns], _round_tmp(s, scaled)], dim=1)
    A = A + fit_noise(s, frame, data.device)[None]
    T = torch.cat([A, data[:, F:]], dim=1).clone()     # [nb, B, bp]
    rows = torch.arange(bp, device=data.device)
    diag, tops = [], []
    for col in range(F):
        v = T[:, col]
        tail = torch.where(rows > col, v, 0.0)
        sigma = _mm(tail[:, None, :], tail[:, :, None], precision)[:, 0, 0]
        pivot = v[:, col]
        vec_len = torch.sqrt(sigma + pivot * pivot)
        head = pivot - vec_len
        u_len_sq = sigma + head * head
        u = torch.where(rows == col, head[:, None], tail)
        rest = T[:, col + 1:]
        dots = _mm(rest, u[:, :, None], precision)     # [nb, k, 1]
        new = rest - 2.0 * u[:, None, :] * dots / u_len_sq[:, None, None]
        T[:, col + 1:] = torch.where(rows >= col, _round_tmp(s, new), rest)
        diag.append(vec_len)
        tops.append(T[:, :, col].clone())   # row col of every column, final
    # back substitution in the reference's order (opencl/bmfr.cl:658-692):
    # w_i = rhs_i / R_ii - sum_j (R_ij w_j) / R_ii, j = i+1..F-1
    w = [None] * F
    for i in reversed(range(F)):
        d = diag[i][:, None]
        acc = tops[i][:, F:F + 3] / d
        for j in range(i + 1, F):
            acc = acc - (tops[i][:, j:j + 1] * w[j]) / d
        w[i] = acc
    return torch.stack(w, dim=1), mins_maxs


def reconstruct(s, weights, mins_maxs, feats, frame, precision="highest"):
    """weighted_sum (opencl/bmfr.cl:703-758): each pixel's basis, scaled
    by its block's min/max, times its block's weights, negatives to 0."""
    H, W = s.image_height, s.image_width
    be, half = s.block_edge, s.block_edge // 2
    ox, oy = BLOCK_OFFSETS[frame % 16]
    dev = feats.device
    ys, xs = torch.meshgrid(torch.arange(H, device=dev),
                            torch.arange(W, device=dev), indexing="ij")
    group = ((xs + half - ox) // be + ((ys + half - oy) // be) * s.blocks_x
             ).reshape(-1)
    nns = s.features_not_scaled_count
    f = feats.reshape(feats.shape[0], -1).t()           # [HW, F]
    mm = mins_maxs[group]                               # [HW, n_scaled, 2]
    lo, hi = mm[..., 0], mm[..., 1]
    span = hi - lo
    sc = f[:, nns:]
    sc = torch.where(span.abs() > 1.0, (sc - lo) / span, sc - lo)
    basis = torch.cat([f[:, :nns], sc], dim=1)
    color = _mm(basis[:, None, :], weights[group], precision)[:, 0]
    color = torch.where(color < 0.0, 0.0, color)
    return color.t().reshape(3, H, W)


def accumulate_filtered(s, state, filtered, albedo, spp, accept, pfx, pfy,
                        history):
    """K4 (opencl/bmfr.cl:761-857): ``(out, tone)``."""
    H, W = s.image_height, s.image_width
    prev = torch.zeros_like(filtered)
    total = torch.zeros((H, W), dtype=torch.float32, device=filtered.device)
    if history and not s.skip_second_accum:
        ix, iy, taps = _taps(pfx, pfy)
        for i, (wgt, dx, dy) in enumerate(taps):
            on = ((accept >> i) & 1) > 0
            w = torch.where(on, wgt, 0.0)
            total = total + w
            prev = prev + w[None] * _gather(state["out"], iy + dy, ix + dx)
    has = total > 0
    tw = torch.where(has, total, 1.0)
    prev = prev / tw[None]
    alpha = torch.where(
        has, torch.clamp_min(1.0 / spp, _f32(s.second_blend_alpha)), 1.0)
    out = alpha[None] * filtered + (1.0 - alpha)[None] * prev
    tone = torch.clamp(torch.pow(torch.clamp_min(albedo * out, 0.0),
                                 _f32(0.454545)), 0.0, 1.0)
    return out, tone


def _ycocg(c):
    r, g, b = c[0], c[1], c[2]
    return torch.stack([r + 2 * g + b, 2 * r - 2 * b, -r + 2 * g - b])


def _rgb(c):
    y, co, cg = c[0], c[1], c[2]
    return torch.stack([0.25 * y + 0.25 * co - 0.25 * cg,
                        0.25 * y + 0.25 * cg,
                        0.25 * y - 0.25 * co - 0.25 * cg])


def _neighbourhood(yc, shape):
    """min and max over a 3x3 box or cross, out-of-image samples
    ignored."""
    H, W = yc.shape[-2:]
    pos = torch.nn.functional.pad(yc, (1, 1, 1, 1), value=math.inf)
    neg = torch.nn.functional.pad(yc, (1, 1, 1, 1), value=-math.inf)
    mn = torch.full_like(yc, math.inf)
    mx = torch.full_like(yc, -math.inf)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if shape == "cross" and dx != 0 and dy != 0:
                continue
            mn = torch.minimum(mn, pos[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
            mx = torch.maximum(mx, neg[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W])
    return mn, mx


def taa(s, state, tone, pfx, pfy, history):
    """K5 (opencl/bmfr.cl:860-974): the previous result, clamped to the
    YCoCg neighbourhood of this frame's tone, blended in."""
    if not history or s.skip_taa:
        return tone
    H, W = s.image_height, s.image_width
    ix, iy, taps = _taps(pfx, pfy)
    off_screen = (ix < -1) | (iy < -1) | (ix >= W) | (iy >= H)
    yc = _ycocg(tone)
    if s.residual_dtype == "bfloat16":
        yc = yc.to(torch.bfloat16).float()
    elif s.residual_dtype != "float32":
        raise ValueError(f"bad residual dtype {s.residual_dtype!r}")
    mn_box, mx_box = _neighbourhood(yc, "box")
    mn_cross, mx_cross = _neighbourhood(yc, "cross")
    masks = ((iy >= 0) & (ix >= 0), (iy >= 0) & (ix < W - 1),
             (iy < H - 1) & (ix >= 0), (iy < H - 1) & (ix < W - 1))
    prev = torch.zeros_like(tone)
    total = torch.zeros((H, W), dtype=torch.float32, device=tone.device)
    for (wgt, dx, dy), on in zip(taps, masks):
        w = torch.where(on, wgt, 0.0)
        prev = prev + w[None] * _gather(state["result"], iy + dy, ix + dx)
        total = total + w
    prev = prev / torch.where(total > 0, total, 1.0)[None]
    clamped = torch.minimum(torch.maximum(_ycocg(prev),
                                          (mn_box + mn_cross) / 2.0),
                            (mx_box + mx_cross) / 2.0)
    alpha = _f32(s.taa_blend_alpha)
    result = alpha * tone + _f32(1.0 - alpha) * _rgb(clamped)
    return torch.where(off_screen[None], tone, result)


def frame_step(s, state, positions, normals, noisy, albedo, prev_cam,
               pixel_offset, frame, history, precision="highest"):
    """One frame (opencl/bmfr.cpp:417-485): ``(next state, outputs)``.
    ``frame`` the frame number (the block jitter and the fit's noise),
    ``history`` whether it reads ``state``; inputs f32 ``[3, H, W]``,
    ``prev_cam`` f32 ``[4, 4]`` (columns project), ``pixel_offset`` f32
    ``[2]``; ``precision`` that of the fit's and the reconstruction's
    products (:func:`_mm`). The next state is stored as :func:`store`
    stores it."""
    pfx, pfy = reproject(s, positions, prev_cam, pixel_offset, history)
    accum, spp, accept = accumulate_noisy(s, state, positions, normals,
                                          noisy, pfx, pfy, history)
    feats = _features(s, positions, normals)
    if s.skip_fitting:
        filtered = accum
    else:
        weights, mins_maxs = fit(s, blocks_of(s, feats, accum, frame), frame,
                                 precision)
        filtered = reconstruct(s, weights, mins_maxs, feats, frame,
                               precision)
    out, tone = accumulate_filtered(s, state, filtered, albedo, spp, accept,
                                    pfx, pfy, history)
    result = taa(s, state, tone, pfx, pfy, history)
    nxt = {"positions": positions, "normals": normals, "noisy": accum,
           "spp": spp, "out": out, "result": result}
    nxt = {k: store(s, v) for k, v in nxt.items()}
    return nxt, dict(accum=accum, spp=spp, accept=accept, filtered=filtered,
                     out=out, tone=tone, result=result, pfx=pfx, pfy=pfy)
