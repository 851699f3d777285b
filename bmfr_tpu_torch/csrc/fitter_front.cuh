// The shared front and back of the direct fitter kernels for Hopper
// (sm_90a): kernel B (fitter_chol.cu, Cholesky) and kernel C
// (householder.cu, Householder QR). The TPU kernels share them the same
// way (_build_block_data, bmfr_tpu/ops/fitter_direct.py:165-217).
//
// One CTA of 256 threads fits one 32x32 block of the jittered margins
// grid; thread t owns pixels e = t + 256 k, k < 4. Per block:
//   stage_raw    view cell (gy, gx) reads image pixel (mirror(gy-16+oy, H),
//                mirror(gx-16+ox, W)) -- the symmetric pad as arithmetic,
//                no padded copy -- for the 9 raw planes (normals,
//                positions, accumulated colour), staged in shared memory;
//   block_scale  the block min/max of the 6 stored scaled features;
//   fit_values   the 13 values of a pixel's row of the fit: the K1 store
//                contract (NaN -> 0, f16 clamp to +-65504, storage
//                rounding), the rescale with its storage rounding, then
//                the hash noise (not rounded; row 0 of the noise is zero);
//   reconstruct  max(sum_f w_f * basis_f, 0) with the basis built from the
//                pre-rounding, unsanitized, noise-free f32 features,
//                written straight to image pixel (gy-16+oy, gx-16+ox) when
//                that lies in the image (in-image view cells map one to
//                one onto the image): the inverse-jitter slice of the JAX
//                pipeline (bmfr_tpu/pipeline/denoise.py:218-225) is fused.
// Rounding is __float2half_rn / __float2bfloat16_rn (nearest-even; above
// 65504 a half rounds to inf, as a half store does).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bmfr {

constexpr int BE = 32;             // block edge
constexpr int BP = BE * BE;        // pixels per block
constexpr int NF = 10;             // features of the default basis
constexpr int NBUF = NF + 3;       // features + colours
constexpr int LO = 4;              // features not scaled
constexpr int NSC = NF - LO;       // scaled features
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = BP / THREADS;  // pixels per thread

// tmp_data_dtype codes shared with the Python wrappers
enum Storage { kF32 = 0, kF16 = 1, kBF16 = 2 };

// The storage mode M is a template parameter: each tmp dtype gets its own
// kernel, and the f32 one carries no rounding branches.
template <int M>
__device__ __forceinline__ float quantize(float v) {
  if (M == kF16) return __half2float(__float2half_rn(v));
  if (M == kBF16) return __bfloat162float(__float2bfloat16_rn(v));
  return v;
}

// the K1 store contract (opencl/bmfr.cl:455-476)
template <int M>
__device__ __forceinline__ float store(float v) {
  v = isnan(v) ? 0.0f : v;
  if (M == kF16) v = fminf(fmaxf(v, -65504.0f), 65504.0f);
  return quantize<M>(v);
}

__device__ __forceinline__ int mirror(int i, int size) {
  // symmetric reflection, periodic in 2*size (jnp.pad "symmetric")
  const int period = 2 * size;
  int m = i % period;
  if (m < 0) m += period;
  return m < size ? m : period - 1 - m;
}

// raw feature j of the 6 scaled ones: positions, then positions squared
__device__ __forceinline__ float scaled_feature(const float* raw, int e,
                                                int j) {
  const float p = raw[(3 + j % 3) * BP + e];
  return j < 3 ? p : __fmul_rn(p, p);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// raw[c * BP + e], c: normals 0:3, positions 3:6, accumulated colour 6:9
__device__ __forceinline__ void stage_raw(float* raw,
                                          const float* __restrict__ normals,
                                          const float* __restrict__ positions,
                                          const float* __restrict__ accum,
                                          int H, int W, int ox, int oy) {
  const int64_t n = (int64_t)H * W;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = threadIdx.x + THREADS * k;
    const int sy = mirror((int)blockIdx.y * BE + (e >> 5) - BE / 2 + oy, H);
    const int sx = mirror((int)blockIdx.x * BE + (e & 31) - BE / 2 + ox, W);
    const int64_t off = (int64_t)sy * W + sx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      raw[c * BP + e] = normals[c * n + off];
      raw[(3 + c) * BP + e] = positions[c * n + off];
      raw[(6 + c) * BP + e] = accum[c * n + off];
    }
  }
}

// Block min/max of the stored scaled features (opencl/bmfr.cl:511-542):
// smin/smax/sden[NSC] in shared memory, the denominator rmax - rmin only
// where |rmax - rmin| > 1. red: shared scratch of WARPS * 2 * NSC floats.
// Call after stage_raw and a barrier; ends with a barrier.
template <int M>
__device__ __forceinline__ void block_scale(const float* raw, float* red,
                                            float* smin, float* smax,
                                            float* sden) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mn[NSC], mx[NSC];
#pragma unroll
  for (int j = 0; j < NSC; ++j) {
    mn[j] = INFINITY;
    mx[j] = -INFINITY;
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      const float v = store<M>(scaled_feature(raw, e, j));
      mn[j] = fminf(mn[j], v);
      mx[j] = fmaxf(mx[j], v);
    }
  }
#pragma unroll
  for (int j = 0; j < NSC; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn[j] = fminf(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], o));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      red[warp * 2 * NSC + j] = mn[j];
      red[warp * 2 * NSC + NSC + j] = mx[j];
    }
  }
  __syncthreads();
  if (tid < NSC) {
    float rmin = red[tid], rmax = red[NSC + tid];
    for (int w = 1; w < WARPS; ++w) {
      rmin = fminf(rmin, red[w * 2 * NSC + tid]);
      rmax = fmaxf(rmax, red[w * 2 * NSC + NSC + tid]);
    }
    const float r = rmax - rmin;
    smin[tid] = rmin;
    smax[tid] = rmax;
    sden[tid] = fabsf(r) > 1.0f ? r : 1.0f;
  }
  __syncthreads();
}

// The row of pixel e in the fit: features 0:NF (stored, scaled, rounded,
// plus noise[f * BP + e]) and the 3 stored colours.
template <int M>
__device__ __forceinline__ void fit_values(const float* raw, int e,
                                           const float* smin,
                                           const float* sden,
                                           const float* __restrict__ noise,
                                           float v[NBUF]) {
  v[0] = 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c)
    v[1 + c] = store<M>(raw[c * BP + e]) + noise[(1 + c) * BP + e];
#pragma unroll
  for (int j = 0; j < NSC; ++j) {
    const float f = store<M>(scaled_feature(raw, e, j));
    v[LO + j] = quantize<M>((f - smin[j]) / sden[j]) +
                noise[(LO + j) * BP + e];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) v[NF + c] = store<M>(raw[(6 + c) * BP + e]);
}

// max(sum_f w[ch * NF + f] * basis_f, 0) into the image (NaN kept, as
// torch.maximum / jnp.maximum keep it).
__device__ __forceinline__ void reconstruct(const float* raw,
                                            const float* smin,
                                            const float* sden, const float* w,
                                            float* __restrict__ out, int H,
                                            int W, int ox, int oy) {
  const int64_t n = (int64_t)H * W;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = threadIdx.x + THREADS * k;
    const int iy = (int)blockIdx.y * BE + (e >> 5) - BE / 2 + oy;
    const int ix = (int)blockIdx.x * BE + (e & 31) - BE / 2 + ox;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
    float basis[NF];
    basis[0] = 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) basis[1 + c] = raw[c * BP + e];
#pragma unroll
    for (int j = 0; j < NSC; ++j)
      basis[LO + j] = (scaled_feature(raw, e, j) - smin[j]) / sden[j];
    const int64_t off = (int64_t)iy * W + ix;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float col = 0.0f;
#pragma unroll
      for (int f = 0; f < NF; ++f) col = col + basis[f] * w[ch * NF + f];
      out[ch * n + off] = isnan(col) ? col : fmaxf(col, 0.0f);
    }
  }
}

}  // namespace bmfr
