// Fused per-block fit + reconstruction with the Cholesky solver (kernel B)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _chol_kernel (bmfr_tpu/ops/fitter_direct.py,
// entry fit_reconstruct_cholesky) and the inverse-jitter slice after it
// (bmfr_tpu/pipeline/denoise.py:218-225). One CTA per 32x32 block of the
// jittered margins grid (blocks_y x blocks_x = 24 x 41 = 984 at 1280x720);
// only real blocks are fitted. Per block:
//   1. stage the 9 raw planes, mirror-addressed (fitter_front.cuh);
//   2. the block min/max of the 6 stored scaled features;
//   3. per pixel the 13 values of the fit (K1 store contract and storage
//      rounding in the tmp dtype, rescale, the hash noise computed in the
//      kernel, fitter_front.cuh), and the 55
//      Gram-triangle + 30 rhs sums in plain f32 (CUDA-core FMAs: no TF32,
//      no tensor cores -- the normal equations cancel catastrophically
//      under rounded operands);
//   4. the 10x10 Cholesky and the forward/back solves per colour channel
//      in _chol_kernel's loop order, IEEE sqrt and division, NaN -> 0;
//   5. the reconstruction straight into the image (fitter_front.cuh).
//
// What bounds it on this card: f32 FMAs. The sums are 85 products x 1024
// pixels per block (87k FMAs, 86M per frame) plus ~10 divides per pixel;
// the loads are 9 f32 per view cell (37 KB per block, ~41 MB per frame,
// mostly cache-resident). The design gives each thread 4 pixels and 85
// register accumulators, so the products never touch shared memory; a
// warp-shuffle tree and one 8-way shared-memory pass reduce them. The
// serial 10x10 factorization runs on one thread (3 threads for the
// solves) while the SM's other resident blocks keep its lanes busy.

#include "fitter_front.cuh"

namespace {

using namespace bmfr;

constexpr int NG = 85;  // Gram triangle (55) + rhs (30) sums

// the 9 staged raw values of view cell e
__device__ __forceinline__ void staged_pixel(const float* raw, int e,
                                             float px[9]) {
#pragma unroll
  for (int c = 0; c < 9; ++c) px[c] = raw[c * BP + e];
}

template <int M>
__global__ void __launch_bounds__(THREADS)
fit_chol_kernel(const float* __restrict__ normals,
                const float* __restrict__ positions,
                const float* __restrict__ accum, float* __restrict__ out,
                float* __restrict__ weights, int H, int W, int ox, int oy,
                Noise nz) {
  __shared__ float raw[9 * BP];
  __shared__ float red[WARPS * NG];
  __shared__ float gram[NG];
  __shared__ float smin[NSC], sden[NSC];
  __shared__ float sL[NF][NF];
  __shared__ float sw[3 * NF];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n = (int64_t)H * W;

  // ---- 1. stage the raw planes, mirror-addressed ----
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    const int sy = mirror((int)blockIdx.y * BE + (e >> 5) - BE / 2 + oy, H);
    const int sx = mirror((int)blockIdx.x * BE + (e & 31) - BE / 2 + ox, W);
    float px[9];
    load_pixel(px, normals, positions, accum, n, (int64_t)sy * W + sx);
#pragma unroll
    for (int c = 0; c < 9; ++c) raw[c * BP + e] = px[c];
  }
  __syncthreads();

  // ---- 2. block min/max of the stored scaled features ----
  float mn[NSC], mx[NSC];
#pragma unroll
  for (int j = 0; j < NSC; ++j) {
    mn[j] = INFINITY;
    mx[j] = -INFINITY;
  }
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    float px[9];
    staged_pixel(raw, tid + THREADS * k, px);
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      const float v = scaled_store<M>(px, j);
      mn[j] = fminf(mn[j], v);
      mx[j] = fmaxf(mx[j], v);
    }
  }
#pragma unroll
  for (int j = 0; j < NSC; ++j) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      mn[j] = fminf(mn[j], __shfl_xor_sync(FULL, mn[j], o));
      mx[j] = fmaxf(mx[j], __shfl_xor_sync(FULL, mx[j], o));
    }
    if (lane == 0) {
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
    smin[tid] = rmin;
    sden[tid] = scale_den(rmin, rmax);
  }
  __syncthreads();

  // ---- 3. Gram + rhs sums ----
  float acc[NG];
#pragma unroll
  for (int g = 0; g < NG; ++g) acc[g] = 0.0f;
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    float px[9], v[NBUF];
    staged_pixel(raw, e, px);
    fit_values<M>(px, e, smin, sden, nz, v);
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
    if (lane == 0) red[warp * NG + g] = s;
  }
  __syncthreads();
  if (tid < NG) {
    float s = red[tid];
    for (int w = 1; w < WARPS; ++w) s += red[w * NG + tid];
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
    const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
    for (int f = 0; f < NF; ++f) {
      const float wf = isnan(x[f]) ? 0.0f : x[f];
      sw[ch * NF + f] = wf;
      weights[(b * NF + f) * 3 + ch] = wf;  // [n_blocks, F, 3]
    }
  }
  __syncthreads();

  // ---- 5. reconstruction straight into the image ----
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    const int iy = (int)blockIdx.y * BE + (e >> 5) - BE / 2 + oy;
    const int ix = (int)blockIdx.x * BE + (e & 31) - BE / 2 + ox;
    if (iy < 0 || iy >= H || ix < 0 || ix >= W) continue;
    float px[9];
    staged_pixel(raw, e, px);
    reconstruct_pixel(px, smin, sden, sw, out, n, (int64_t)iy * W + ix);
  }
}

template <int M>
int launch(const float* normals, const float* positions, const float* accum,
           float* out, float* weights, int H, int W, int blocks_x,
           int blocks_y, int ox, int oy, Noise nz, cudaStream_t stream) {
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  fit_chol_kernel<M><<<grid, THREADS, 0, stream>>>(
      normals, positions, accum, out, weights, H, W, ox, oy, nz);
  return (int)cudaGetLastError();
}

}  // namespace

// mode: the tmp dtype, 0 f32, 1 f16, 2 bf16; noise_base, noise_amp: the
// hash noise's frame term and amplitude (fitter_front.cuh)
extern "C" int bmfr_fit_reconstruct_cholesky(
    const float* normals, const float* positions, const float* accum,
    float* out, float* weights, int H, int W, int blocks_x, int blocks_y,
    int ox, int oy, int mode, unsigned noise_base, float noise_amp,
    cudaStream_t stream) {
  const Noise nz{noise_base, noise_amp, BP};
  if (mode == kF16)
    return launch<kF16>(normals, positions, accum, out, weights, H, W,
                        blocks_x, blocks_y, ox, oy, nz, stream);
  if (mode == kBF16)
    return launch<kBF16>(normals, positions, accum, out, weights, H, W,
                         blocks_x, blocks_y, ox, oy, nz, stream);
  return launch<kF32>(normals, positions, accum, out, weights, H, W,
                      blocks_x, blocks_y, ox, oy, nz, stream);
}
