// PyTorch's elementwise semantics, one operation at a time, for the kernels
// that replace the TPU step's XLA fusions (kernels F, G and H:
// filtered_tail.cu, noisy_tail.cu, reproject.cu).
//
// Their plain versions run one torch operation per kernel, so every
// product, sum and quotient is rounded on its own. The __f*_rn intrinsics
// keep nvcc from contracting a product and a sum into an FMA (one rounding
// fewer), and __fdiv_rn is the IEEE division torch's div and reciprocal
// compute. torch's min/max family propagates NaN where fminf/fmaxf drop
// it, so each is written out with the test torch's CUDA kernels make.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace torch_ops {

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float quot(float a, float b) { return __fdiv_rn(a, b); }

// torch.clamp_min(v, lo) with a scalar bound (NaN passes through)
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return isnan(v) ? v : fmaxf(v, lo);
}

// torch.clamp(v, lo, hi), scalar or tensor bounds: a NaN in v, then in lo,
// then in hi is the result
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  if (isnan(v)) return v;
  if (isnan(lo)) return lo;
  if (isnan(hi)) return hi;
  return fminf(fmaxf(v, lo), hi);
}

// one step of max_pool2d's scan (a NaN wins) and of its negated twin
__device__ __forceinline__ float nan_max(float m, float v) {
  return (v > m || isnan(v)) ? v : m;
}
__device__ __forceinline__ float nan_min(float m, float v) {
  return (v < m || isnan(v)) ? v : m;
}

// color.rgb_to_ycocg: r + 2g + b, 2r - 2b, -r + 2g - b, left to right
__device__ __forceinline__ void rgb_to_ycocg(const float c[3], float y[3]) {
  const float g2 = mul(2.0f, c[1]);
  y[0] = add(add(c[0], g2), c[2]);
  y[1] = sub(mul(2.0f, c[0]), mul(2.0f, c[2]));
  y[2] = sub(add(-c[0], g2), c[2]);
}

// color.ycocg_to_rgb with its 0.25 scaling, left to right
__device__ __forceinline__ void ycocg_to_rgb(const float y[3], float c[3]) {
  const float qy = mul(0.25f, y[0]), qo = mul(0.25f, y[1]),
              qg = mul(0.25f, y[2]);
  c[0] = sub(add(qy, qo), qg);
  c[1] = add(qy, qg);
  c[2] = sub(sub(qy, qo), qg);
}

// ops/warp.py::pack_pairs_bf16's word: channel lo in the low 16 bits,
// hi in the high 16, each rounded to bf16 to nearest even (as torch's
// f32 -> bf16 copy on the card)
__device__ __forceinline__ int32_t pack_pair(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return (int32_t)(l | (h << 16));
}

}  // namespace torch_ops
