// The per-pixel blend of the four bilinear taps shared by kernels A
// (warp_blend.cu: the taps from the bf16 channel-pair state) and I
// (warp_taps.cu: from the raw f32 planes): ops/warp_blend.py::
// blend_from_taps and mask_bits, operation by operation.
//
// From pfx/pfy: floor toward -inf with int32 saturation, NaN -> 0
// (ops/gather.py::floor_int), the fractions from the integer converted
// back, the four bilinear weights, K1's screen bounds of each tap and K5's
// border masks, and the tap addresses (clip(iy + dy), clip(ix + dx)) with
// iy + 1 and ix + 1 wrapping at INT_MAX as ops/warp.py::add_wrap (XLA)
// adds. At ix < 0 the plain version's bit 8 substitutes taps 0 and 2 for
// taps 1 and 3: there clip(ix + 1) == clip(ix) == 0, so the taps already
// agree.
//
// Then each tap's 16 channels (positions 0:3, normals 3:6, noisy 6:9, spp
// 9, out 10:13, result 13:16) add into the 13 planes: K1's weight where
// the tap is on screen and within the position/normal limits (its accept
// bit), K4 the same, K5 its border mask and no limit test. Every product
// and sum is rounded on its own (torch_ops.cuh: no FMA contraction), since
// the limit compares decide the accept bits; a masked tap still multiplies
// (where(ok, w, 0) * t is NaN for a NaN or infinite tap).

#pragma once

#include "torch_ops.cuh"

namespace tap_blend {

using namespace torch_ops;

constexpr int kIntMax = 0x7fffffff;

// clip(i + 1) into [0, size) with i + 1 wrapping at INT_MAX (add_wrap),
// written without the + 1 overflowing
__device__ __forceinline__ int clip_next(int i, int size) {
  return i == kIntMax ? 0 : min(max(i, -1), size - 2) + 1;
}

// what a pixel's four taps need besides their values
struct Taps {
  int ix, cx0, cx1;
  int64_t row0, row1;  // offsets of the tap rows clip(iy), clip(iy + 1)
  float w[4];
  bool inb[4], k5m[4];
};

__device__ __forceinline__ Taps pixel_taps(float px, float py, int H, int W) {
  Taps t;
  const int ix = __float2int_rd(px);
  const int iy = __float2int_rd(py);
  const float fx = sub(px, (float)ix);
  const float fy = sub(py, (float)iy);
  const bool x0_in = ix >= 0 && ix < W;
  const bool x1_in = ix >= -1 && ix < W - 1;
  const bool y0_in = iy >= 0 && iy < H;
  const bool y1_in = iy >= -1 && iy < H - 1;
  t.inb[0] = y0_in && x0_in;
  t.inb[1] = y0_in && x1_in;
  t.inb[2] = y1_in && x0_in;
  t.inb[3] = y1_in && x1_in;
  const bool x_lo = ix >= 0, x_hi = ix < W - 1;
  const bool y_lo = iy >= 0, y_hi = iy < H - 1;
  t.k5m[0] = y_lo && x_lo;
  t.k5m[1] = y_lo && x_hi;
  t.k5m[2] = y_hi && x_lo;
  t.k5m[3] = y_hi && x_hi;
  t.ix = ix;
  t.cx0 = min(max(ix, 0), W - 1);
  t.cx1 = clip_next(ix, W);
  t.row0 = (int64_t)min(max(iy, 0), H - 1) * W;
  t.row1 = (int64_t)clip_next(iy, H) * W;
  const float omfx = sub(1.0f, fx), omfy = sub(1.0f, fy);
  t.w[0] = mul(omfx, omfy);
  t.w[1] = mul(fx, omfy);
  t.w[2] = mul(omfx, fy);
  t.w[3] = mul(fx, fy);
  return t;
}

// the offset of tap i, (dx, dy) = TAP_OFFSETS[i], at columns cx0 / cx1
__device__ __forceinline__ int64_t tap_offset(const Taps& t, int i, int cx1) {
  return (i < 2 ? t.row0 : t.row1) + (i & 1 ? cx1 : t.cx0);
}

struct Sums {
  float pc[3] = {0.f, 0.f, 0.f}, k4[3] = {0.f, 0.f, 0.f},
        k5[3] = {0.f, 0.f, 0.f};
  float spp = 0.f, tw = 0.f, k5w = 0.f;
  int accept = 0;
};

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return add(add(mul(a, a), mul(b, b)), mul(c, c));
}

// tap i's 16 channels t into the sums; cur: the pixel's current positions
// 0:3 and normals 3:6
__device__ __forceinline__ void add_tap(Sums& s, const Taps& tp, int i,
                                        const float t[16], const float cur[6],
                                        float pos_lim, float nrm_lim) {
  const float pd = sq3(sub(t[0], cur[0]), sub(t[1], cur[1]),
                       sub(t[2], cur[2]));
  const float nd = sq3(sub(t[3], cur[3]), sub(t[4], cur[4]),
                       sub(t[5], cur[5]));
  const bool ok = tp.inb[i] && (pd < pos_lim) && (nd < nrm_lim);
  const float wgt = ok ? tp.w[i] : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.pc[c] = add(s.pc[c], mul(wgt, t[6 + c]));
    s.k4[c] = add(s.k4[c], mul(wgt, t[10 + c]));
  }
  s.spp = add(s.spp, mul(wgt, t[9]));
  s.tw = add(s.tw, wgt);
  s.accept |= ok ? (1 << i) : 0;
  const float wm = tp.k5m[i] ? tp.w[i] : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) s.k5[c] = add(s.k5[c], mul(wm, t[13 + c]));
  s.k5w = add(s.k5w, wm);
}

// the 13 planes of pixel p (warp_blend.py::BLEND_PLANES' layout)
__device__ __forceinline__ void store(float* __restrict__ out, int64_t n,
                                      int64_t p, const Sums& s) {
  out[0 * n + p] = s.pc[0];
  out[1 * n + p] = s.pc[1];
  out[2 * n + p] = s.pc[2];
  out[3 * n + p] = s.spp;
  out[4 * n + p] = s.tw;
  out[5 * n + p] = (float)s.accept;
  out[6 * n + p] = s.k4[0];
  out[7 * n + p] = s.k4[1];
  out[8 * n + p] = s.k4[2];
  out[9 * n + p] = s.k5[0];
  out[10 * n + p] = s.k5[1];
  out[11 * n + p] = s.k5[2];
  out[12 * n + p] = s.k5w;
}

}  // namespace tap_blend
