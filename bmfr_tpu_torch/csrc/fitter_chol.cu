// Fused per-block fit + reconstruction with the Cholesky solver (kernel B)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _chol_kernel (bmfr_tpu/ops/fitter_direct.py,
// entry fit_reconstruct_cholesky) and the inverse-jitter slice after it
// (bmfr_tpu/pipeline/denoise.py:218-225). One CTA per 32x32 block of the
// jittered margins grid (blocks_y x blocks_x = 24 x 41 = 984 at 1280x720);
// only real blocks are fitted. Per block:
//   1. view cell (gy, gx) reads image pixel (mirror(gy-16+oy, H),
//      mirror(gx-16+ox, W)) -- the symmetric pad as arithmetic, no padded
//      copy; the 9 raw values per pixel are staged in shared memory;
//   2. the 6 scaled features' block min/max (NaN -> 0 first);
//   3. the 10 features (scaled, plus the hash noise) and 3 colours per
//      pixel, and the 55 Gram-triangle + 30 rhs sums in plain f32
//      (CUDA-core FMAs: no TF32, no tensor cores -- the normal equations
//      cancel catastrophically under rounded operands);
//   4. the 10x10 Cholesky and the forward/back solves per colour channel
//      in _chol_kernel's loop order, IEEE sqrt and division, NaN -> 0;
//   5. max(sum_f w_f * basis_f, 0) with the noise-free, unsanitized basis,
//      written directly to image pixel (gy-16+oy, gx-16+ox) when that lies
//      in the image (in-image view cells map one-to-one onto the image).
//
// What bounds it on this card: f32 FMAs. The sums are 85 products x 1024
// pixels per block (87k FMAs, 86M per frame) plus ~10 divides per pixel;
// the loads are 9 f32 per view cell (37 KB per block, ~41 MB per frame,
// mostly cache-resident). The design gives each thread 4 pixels and 85
// register accumulators, so the products never touch shared memory; a
// warp-shuffle tree and one 8-way shared-memory pass reduce them. The
// serial 10x10 factorization runs on one thread (3 threads for the
// solves) while the SM's other resident blocks keep its lanes busy.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BE = 32;           // block edge
constexpr int BP = BE * BE;      // pixels per block
constexpr int NF = 10;           // features
constexpr int NBUF = NF + 3;     // features + colours
constexpr int NG = 85;           // Gram triangle (55) + rhs (30) sums
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PPT = BP / THREADS;  // pixels per thread

__device__ __forceinline__ int mirror(int i, int size) {
  // symmetric reflection, periodic in 2*size (jnp.pad "symmetric")
  const int period = 2 * size;
  int m = i % period;
  if (m < 0) m += period;
  return m < size ? m : period - 1 - m;
}

__device__ __forceinline__ float san(float v) { return isnan(v) ? 0.0f : v; }

// raw feature j of the 6 scaled ones: positions, then positions squared
__device__ __forceinline__ float scaled_feature(const float* p, int j) {
  return j < 3 ? p[j] : __fmul_rn(p[j - 3], p[j - 3]);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(THREADS)
fit_chol_kernel(const float* __restrict__ normals,
                const float* __restrict__ positions,
                const float* __restrict__ accum,
                const float* __restrict__ noise,  // [NF, BP], row 0 zero
                float* __restrict__ out, float* __restrict__ weights, int H,
                int W, int ox, int oy) {
  __shared__ float raw[9][BP];        // normals 0:3, positions 3:6, accum 6:9
  __shared__ float red[WARPS][NG];
  __shared__ float gram[NG];
  __shared__ float smin[6], sden[6];
  __shared__ float sL[NF][NF];
  __shared__ float sw[3][NF];

  const int bx = blockIdx.x, by = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n = (int64_t)H * W;

  // ---- 1. stage the block's raw planes (mirror-addressed) ----
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    const int sy = mirror(by * BE + (e >> 5) - BE / 2 + oy, H);
    const int sx = mirror(bx * BE + (e & 31) - BE / 2 + ox, W);
    const int64_t off = (int64_t)sy * W + sx;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      raw[c][e] = normals[c * n + off];
      raw[3 + c][e] = positions[c * n + off];
      raw[6 + c][e] = accum[c * n + off];
    }
  }
  __syncthreads();

  // ---- 2. block min/max of the scaled features ----
  float mn[6], mx[6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    mn[j] = INFINITY;
    mx[j] = -INFINITY;
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    const float p[3] = {raw[3][e], raw[4][e], raw[5][e]};
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float v = san(scaled_feature(p, j));
      mn[j] = fminf(mn[j], v);
      mx[j] = fmaxf(mx[j], v);
    }
  }
#pragma unroll
  for (int j = 0; j < 6; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn[j] = fminf(mn[j], __shfl_xor_sync(0xffffffffu, mn[j], o));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(0xffffffffu, mx[j], o));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      red[warp][j] = mn[j];
      red[warp][6 + j] = mx[j];
    }
  }
  __syncthreads();
  if (tid < 6) {
    float rmin = red[0][tid], rmax = red[0][6 + tid];
    for (int w = 1; w < WARPS; ++w) {
      rmin = fminf(rmin, red[w][tid]);
      rmax = fmaxf(rmax, red[w][6 + tid]);
    }
    const float r = rmax - rmin;
    smin[tid] = rmin;
    sden[tid] = fabsf(r) > 1.0f ? r : 1.0f;
  }
  __syncthreads();

  // ---- 3. Gram + rhs sums ----
  float acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    const float p[3] = {san(raw[3][e]), san(raw[4][e]), san(raw[5][e])};
    float v[NBUF];
    v[0] = 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) v[1 + c] = san(raw[c][e]) + noise[(1 + c) * BP + e];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      const float f = san(scaled_feature(p, j));
      v[4 + j] = (f - smin[j]) / sden[j] + noise[(4 + j) * BP + e];
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) v[NF + c] = san(raw[6 + c][e]);
    int g = 0;
#pragma unroll
    for (int f1 = 0; f1 < NF; ++f1) {
#pragma unroll
      for (int f2 = f1; f2 < NBUF; ++f2) acc[g++] += v[f1] * v[f2];
    }
  }
#pragma unroll
  for (int g = 0; g < NG; ++g) {
    const float s = warp_sum(acc[g]);
    if (lane == 0) red[warp][g] = s;
  }
  __syncthreads();
  if (tid < NG) {
    float s = red[0][tid];
    for (int w = 1; w < WARPS; ++w) s += red[w][tid];
    gram[tid] = s;
  }
  __syncthreads();

  // ---- 4. Cholesky G = L L^T, then the 3 solves ----
  // gram index of entry (f1 <= f2): row f1 starts at sum_{r<f1} (NBUF-r)
  auto at = [&](int f1, int f2) {
    return gram[f1 * NBUF - f1 * (f1 - 1) / 2 + (f2 - f1)];
  };
  if (tid == 0) {
    for (int j = 0; j < NF; ++j) {
      float d = at(j, j);
      for (int k = 0; k < j; ++k) d = d - sL[j][k] * sL[j][k];
      sL[j][j] = sqrtf(d);
      for (int i = j + 1; i < NF; ++i) {
        float v = at(j, i);
        for (int k = 0; k < j; ++k) v = v - sL[i][k] * sL[j][k];
        sL[i][j] = v / sL[j][j];
      }
    }
  }
  __syncthreads();
  if (tid < 3) {
    const int ch = tid;
    float y[NF], x[NF];
    for (int i = 0; i < NF; ++i) {
      float v = at(i, NF + ch);
      for (int k = 0; k < i; ++k) v = v - sL[i][k] * y[k];
      y[i] = v / sL[i][i];
    }
    for (int i = NF - 1; i >= 0; --i) {
      float v = y[i];
      for (int k = i + 1; k < NF; ++k) v = v - sL[k][i] * x[k];
      x[i] = v / sL[i][i];
    }
    const int64_t b = (int64_t)by * gridDim.x + bx;
    for (int f = 0; f < NF; ++f) {
      const float wf = isnan(x[f]) ? 0.0f : x[f];
      sw[ch][f] = wf;
      weights[(b * NF + f) * 3 + ch] = wf;  // [n_blocks, F, 3]
    }
  }
  __syncthreads();

  // ---- 5. reconstruction straight into the image ----
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    const int iy = by * BE + (e >> 5) - BE / 2 + oy;
    const int ix = bx * BE + (e & 31) - BE / 2 + ox;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
    const float p[3] = {raw[3][e], raw[4][e], raw[5][e]};
    float basis[NF];
    basis[0] = 1.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) basis[1 + c] = raw[c][e];
#pragma unroll
    for (int j = 0; j < 6; ++j)
      basis[4 + j] = (scaled_feature(p, j) - smin[j]) / sden[j];
    const int64_t off = (int64_t)iy * W + ix;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      float col = 0.0f;
#pragma unroll
      for (int f = 0; f < NF; ++f) col = col + basis[f] * sw[ch][f];
      // max(col, 0) keeping NaN, as torch.maximum / jnp.maximum do
      out[ch * n + off] = isnan(col) ? col : fmaxf(col, 0.0f);
    }
  }
}

}  // namespace

extern "C" int bmfr_fit_reconstruct_cholesky(
    const float* normals, const float* positions, const float* accum,
    const float* noise, float* out, float* weights, int H, int W,
    int blocks_x, int blocks_y, int ox, int oy, cudaStream_t stream) {
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  fit_chol_kernel<<<grid, THREADS, 0, stream>>>(
      normals, positions, accum, noise, out, weights, H, W, ox, oy);
  return (int)cudaGetLastError();
}
