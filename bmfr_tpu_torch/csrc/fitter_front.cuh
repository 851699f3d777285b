// The shared front and back of the direct fitter kernels for Hopper
// (sm_90a): kernel B (fitter_chol.cu, Cholesky) and kernel C
// (householder_direct.cu, Householder QR), and what every fitter kernel
// (B, C, D) shares: the hash noise it adds to its feature columns and the
// transpose reduction of its per-warp sums (transpose_halves). The TPU
// kernels share the front the same way (_build_block_data,
// bmfr_tpu/ops/fitter_direct.py:165-217).
//
// Both direct kernels fit one 32x32 block of the jittered margins grid per
// CTA (C: 256 threads, B: 128). A view cell (gy, gx) reads image pixel
// (mirror(gy-16+oy, H), mirror(gx-16+ox, W)) -- the symmetric pad as
// arithmetic, no padded copy -- for the 9 raw planes (normals, positions,
// accumulated colour): a pixel's 9 values px[9]. Per pixel:
//   scaled_store  the 6 stored scaled features, whose block min/max the
//                 kernels reduce;
//   fit_values    the 13 values of the pixel's row of the fit: the K1 store
//                 contract (NaN -> 0, f16 clamp to +-65504, storage
//                 rounding; stored_row), then the rescale with its storage
//                 rounding and the hash noise (not rounded; feature 0 gets
//                 none; finish_row);
//   reconstruct_pixel  max(sum_f w_f * basis_f, 0) with the basis built
//                 from the pre-rounding, unsanitized, noise-free f32
//                 features (scaled_basis; reconstruct_from_basis takes a
//                 basis built ahead), written straight to image pixel
//                 (gy-16+oy, gx-16+ox) when that lies in the image
//                 (in-image view cells map one to one onto the image): the
//                 inverse-jitter slice of the JAX pipeline
//                 (bmfr_tpu/pipeline/denoise.py:218-225) is fused.
// Rounding is __float2half_rn / __float2bfloat16_rn (nearest-even; above
// 65504 a half rounds to inf, as a half store does).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace bmfr {

constexpr int BE = 32;             // block edge of the direct kernels
constexpr int BP = BE * BE;        // pixels per block
constexpr int NF = 10;             // features of the default basis
constexpr int NBUF = NF + 3;       // features + colours
constexpr int LO = 4;              // features not scaled
constexpr int NSC = NF - LO;       // scaled features
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = BP / THREADS;  // pixels per thread
constexpr unsigned FULL = 0xffffffffu;

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

// The hash noise of feature f at pixel e of a block (opencl/bmfr.cl:
// 162-182, :625-627; bmfr_tpu_torch/rng.py, bit-equal to feature_noise):
// seed e + f * bp + base, base = frame * buffer_count * bp mod 2^32, the
// hash's uint32 mapped to [0, 1] by a / 2^32 (float32(UINT_MAX) = 2^32),
// then amp * (u - 0.5) with amp = float32(noise_amount) * 2.
struct Noise {
  uint32_t base;
  float amp;
  int bp;
};

__device__ __forceinline__ uint32_t hash32(uint32_t a) {
  a = (a + 0x7ED55D16u) + (a << 12);
  a = (a ^ 0xC761C23Cu) ^ (a >> 19);
  a = (a + 0x165667B1u) + (a << 5);
  a = (a + 0xD3A2646Cu) ^ (a << 9);
  a = (a + 0xFD7046C5u) + (a << 3);
  a = (a ^ 0xB55A4F09u) ^ (a >> 16);
  return a;
}

// feature f >= 1 (feature 0, the constant, gets no noise)
__device__ __forceinline__ float noise_at(const Noise& nz, int f, int e) {
  const uint32_t a = hash32((uint32_t)e + (uint32_t)f * (uint32_t)nz.bp +
                            nz.base);
  const float u = __fmul_rn(__uint2float_rn(a), 2.3283064365386963e-10f);
  return __fmul_rn(nz.amp, __fsub_rn(u, 0.5f));
}

__device__ __forceinline__ int mirror(int i, int size) {
  // symmetric reflection, periodic in 2*size (jnp.pad "symmetric")
  const int period = 2 * size;
  int m = i % period;
  if (m < 0) m += period;
  return m < size ? m : period - 1 - m;
}

// the 9 raw values of image pixel off: normals 0:3, positions 3:6,
// accumulated colour 6:9
__device__ __forceinline__ void load_pixel(float px[9],
                                           const float* __restrict__ normals,
                                           const float* __restrict__ positions,
                                           const float* __restrict__ accum,
                                           int64_t n, int64_t off) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    px[c] = normals[c * n + off];
    px[3 + c] = positions[c * n + off];
    px[6 + c] = accum[c * n + off];
  }
}

// raw feature j of the 6 scaled ones: positions, then positions squared
__device__ __forceinline__ float scaled_feature(const float* px, int j) {
  const float p = px[3 + j % 3];
  return j < 3 ? p : __fmul_rn(p, p);
}

// the stored value of scaled feature j, whose block min/max the fit uses
template <int M>
__device__ __forceinline__ float scaled_store(const float* px, int j) {
  return store<M>(scaled_feature(px, j));
}

// rescale denominator: rmax - rmin only where |rmax - rmin| > 1
__device__ __forceinline__ float scale_den(float rmin, float rmax) {
  const float r = rmax - rmin;
  return fabsf(r) > 1.0f ? r : 1.0f;
}

struct SumOp {
  __device__ static float f(float a, float b) { return a + b; }
};
struct MaxOp {
  __device__ static float f(float a, float b) { return fmaxf(a, b); }
};

// The transpose reduction of P values over a warp (kernels B, C, D): at
// each of STEPS steps a lane and its partner (lane ^ o, o = 16, 8, ..)
// split the values they still carry; each keeps one half, combines its
// partner's copy of that half into it and hands over the other half
// (P/2 + P/4 + .. shuffles, not 5 P). After the steps a[0 .. P >> STEPS)
// of lane L hold the Op-totals, over the 2^STEPS lanes that differ from L
// only in the bits o, of values i + (P >> STEPS) * ((L >> (5 - STEPS)) &
// (2^STEPS - 1)): with P = 96 and STEPS = 5, lane L holds the warp's
// totals of values 3L, 3L + 1 and 3L + 2.
template <class Op, int P, int STEPS, int S = 0>
__device__ __forceinline__ void transpose_halves(float (&a)[P], int lane) {
  static_assert(STEPS <= 5 && (P >> STEPS) << STEPS == P, "P / 2^STEPS");
  if constexpr (S < STEPS) {
    // one step per instance: its trip count is a constant, so the loop
    // unrolls and a[] stays in registers
    constexpr int half = P >> (S + 1), o = 16 >> S;
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const float give = upper ? a[i] : a[i + half];
      const float keep = upper ? a[i + half] : a[i];
      a[i] = Op::f(keep, __shfl_xor_sync(FULL, give, o));
    }
    transpose_halves<Op, P, STEPS, S + 1>(a, lane);
  }
}

// The stored values of a pixel's row of the fit before the rescale and
// the noise: the constant, the 3 normals, the 6 scaled features, the 3
// colours, each through the K1 store contract.
template <int M>
__device__ __forceinline__ void stored_row(const float* px, float v[NBUF]) {
  v[0] = 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) v[1 + c] = store<M>(px[c]);
#pragma unroll
  for (int j = 0; j < NSC; ++j) v[LO + j] = scaled_store<M>(px, j);
#pragma unroll
  for (int c = 0; c < 3; ++c) v[NF + c] = store<M>(px[6 + c]);
}

// The rescale (with its storage rounding) of the scaled features by the
// block min/max, then the hash noise on features 1.. of pixel e.
template <int M>
__device__ __forceinline__ void finish_row(float v[NBUF], int e,
                                           const float* smin,
                                           const float* sden,
                                           const Noise& nz) {
#pragma unroll
  for (int c = 1; c < LO; ++c) v[c] = v[c] + noise_at(nz, c, e);
#pragma unroll
  for (int j = 0; j < NSC; ++j)
    v[LO + j] = quantize<M>((v[LO + j] - smin[j]) / sden[j]) +
                noise_at(nz, LO + j, e);
}

// The row of pixel e in the fit: features 0:NF (stored, scaled, rounded,
// plus the hash noise) and the 3 stored colours.
template <int M>
__device__ __forceinline__ void fit_values(const float* px, int e,
                                           const float* smin,
                                           const float* sden,
                                           const Noise& nz, float v[NBUF]) {
  stored_row<M>(px, v);
  finish_row<M>(v, e, smin, sden, nz);
}

// scaled basis feature j (0..NSC) of a pixel: its raw feature rescaled by
// the block min/max, without the storage rounding
__device__ __forceinline__ float scaled_basis(const float* px, int j,
                                              const float* smin,
                                              const float* sden) {
  return (scaled_feature(px, j) - smin[j]) / sden[j];
}

// max(sum_f w[ch * NF + f] * basis[f], 0) for each colour ch into image
// pixel off (NaN kept, as torch.maximum / jnp.maximum keep it).
__device__ __forceinline__ void reconstruct_from_basis(
    const float (&basis)[NF], const float* w, float* __restrict__ out,
    int64_t n, int64_t off) {
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    float col = 0.0f;
#pragma unroll
    for (int f = 0; f < NF; ++f) col = col + basis[f] * w[ch * NF + f];
    out[ch * n + off] = isnan(col) ? col : fmaxf(col, 0.0f);
  }
}

// The reconstruction of one pixel into image pixel off.
__device__ __forceinline__ void reconstruct_pixel(const float* px,
                                                  const float* smin,
                                                  const float* sden,
                                                  const float* w,
                                                  float* __restrict__ out,
                                                  int64_t n, int64_t off) {
  float basis[NF];
  basis[0] = 1.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) basis[1 + c] = px[c];
#pragma unroll
  for (int j = 0; j < NSC; ++j)
    basis[LO + j] = scaled_basis(px, j, smin, sden);
  reconstruct_from_basis(basis, w, out, n, off);
}

}  // namespace bmfr
