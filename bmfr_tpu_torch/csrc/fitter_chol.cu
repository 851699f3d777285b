// Fused per-block fit + reconstruction with the Cholesky solver (kernel B)
// for Hopper (sm_90a).
//
// Replaces the TPU kernel _chol_kernel (bmfr_tpu/ops/fitter_direct.py,
// entry fit_reconstruct_cholesky) and the inverse-jitter slice after it
// (bmfr_tpu/pipeline/denoise.py:218-225). One CTA of 128 threads per 32x32
// block of the jittered margins grid (blocks_y x blocks_x = 24 x 41 = 984
// at 1280x720); only real blocks are fitted. Thread t owns view cells
// t + 128 k (k < 8): one column of the block, its lane, so the column's
// mirror address is computed once. Per block:
//   1. stage the 9 raw planes, mirror-addressed (fitter_front.cuh; all 72
//      loads of a thread issued together), and take the block min/max of
//      the 6 stored scaled features from the loaded values (a transpose
//      reduction of 12 maxima per warp, then every warp its own copy of
//      the scale: one barrier);
//   2. per view cell the 13 values of the fit (K1 store contract and
//      storage rounding in the tmp dtype, rescale, the hash noise computed
//      in the kernel, fitter_front.cuh) and the 55 Gram-triangle + 30 rhs
//      sums in plain f32 (CUDA-core FMAs: no TF32, no tensor cores -- the
//      normal equations cancel catastrophically under rounded operands);
//   3. one transpose reduction of the 85 sums per warp (93 shuffles a
//      lane, fitter_front.cuh), the warps' totals to shared memory;
//   4. on warp 0: lane r sums row r of the augmented system [G; b^T] over
//      the warps in warp order, and the 13 x 10 system is factored
//      right-looking -- the forward solve L y = b is the same recurrence
//      as three more rows of the factorization -- then the back solve on
//      30 lanes, one per (colour, row), x handed out by shuffles. Every
//      entry takes its subtractions in _chol_kernel's order
//      (tests/test_torch_chol_schedule.py replays the schedule bit for
//      bit against the plain loops); IEEE sqrt and division; NaN -> 0.
//      Meanwhile the other 3 warps rescale every view cell's basis
//      features for the reconstruction, in place of its positions and
//      colours in shared memory;
//   5. the reconstruction straight into the image (fitter_front.cuh).
//
// What bounded it on this card (PERF.md, PR 4): the serial solve -- a
// 10x10 Cholesky on one thread and the solves on three, 41 % of a CTA's
// life while 255 threads waited at a barrier -- and 85 five-level warp
// sums (425 shuffles a thread). The design replaces both, and 4 CTAs of 4
// warps share an SM, so the lanes one CTA leaves idle at a barrier go to
// the others. What bounds it now is the per-view-cell front of phase 2
// (9 hashes, 6 IEEE divisions, the store contract; ~38 % of a CTA's
// life), the latency of the staging loads (~28 %) and the solve's chain
// of ~20 dependent sqrt/divide/shuffle steps (~27 %, shared with the
// basis rescale).

#include "fitter_front.cuh"

namespace {

using namespace bmfr;

// a CTA of 4 warps per block, 8 view cells a thread; 4 CTAs per SM at
// 128 registers
constexpr int T = 128, NW = T / 32, PP = BP / T;
constexpr int NG = 85;   // Gram triangle (55) + rhs (30) sums
constexpr int NGP = 96;  // padded to 3 per lane for the transpose reduction
constexpr int NMM = 2 * NSC;  // -min and max of the scaled features

// index of Gram/rhs entry (f1 <= f2): row f1 starts at sum_{r<f1} (NBUF-r)
__device__ __forceinline__ int gram_index(int f1, int f2) {
  return f1 * NBUF - f1 * (f1 - 1) / 2 + (f2 - f1);
}

// the 9 staged raw values of view cell e
__device__ __forceinline__ void staged_pixel(const float* raw, int e,
                                             float px[9]) {
#pragma unroll
  for (int c = 0; c < 9; ++c) px[c] = raw[c * BP + e];
}

// mirror() with the in-range case first (a row of view cells is uniform
// over a warp, so the branch does not diverge)
__device__ __forceinline__ int mirror_row(int i, int size) {
  return (unsigned)i < (unsigned)size ? i : mirror(i, size);
}

template <int M>
__global__ void __launch_bounds__(T, 4)
fit_chol_kernel(const float* __restrict__ normals,
                const float* __restrict__ positions,
                const float* __restrict__ accum, float* __restrict__ out,
                float* __restrict__ weights, int H, int W,
                const int* __restrict__ frame_ptr, float amp) {
  __shared__ float raw[9 * BP];
  __shared__ float red[NW * NGP];
  __shared__ float mmw[NW * 16];
  __shared__ float scale[NW][NMM];  // each warp's copy: smin, then sden
  __shared__ float sL[NBUF * NF];   // rows of L, then y of each colour
  __shared__ float sw[3 * NF];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n = (int64_t)H * W;
  const int frame = __ldg(frame_ptr);
  const int2 jit = jitter_offset(frame, BE);
  const Noise nz = frame_noise(frame, amp, BP, NBUF);
  // view cell tid + T k is image pixel (iy0 + NW k, ix) before the mirror
  const int iy0 = (int)blockIdx.y * BE - BE / 2 + jit.y + warp;
  const int ix = (int)blockIdx.x * BE - BE / 2 + jit.x + lane;
  const int sx = mirror(ix, W);

  // ---- 1. stage the raw planes and the block min/max ----
  float mm[16];  // mm[j] = max(-v) = -min, mm[NSC + j] = max
#pragma unroll
  for (int j = 0; j < 16; ++j) mm[j] = -INFINITY;
#pragma unroll
  for (int k = 0; k < PP; ++k) {
    const int e = tid + T * k;
    float px[9];
    load_pixel(px, normals, positions, accum, n,
               (int64_t)mirror_row(iy0 + NW * k, H) * W + sx);
#pragma unroll
    for (int c = 0; c < 9; ++c) raw[c * BP + e] = px[c];
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      const float v = scaled_store<M>(px, j);
      mm[j] = fmaxf(mm[j], -v);
      mm[NSC + j] = fmaxf(mm[NSC + j], v);
    }
  }
  // lanes 2c and 2c + 1 end with the warp's maximum of value c
  transpose_halves<MaxOp, 16, 4>(mm, lane);
  mm[0] = fmaxf(mm[0], __shfl_xor_sync(FULL, mm[0], 1));
  if ((lane & 1) == 0 && (lane >> 1) < NMM)
    mmw[warp * 16 + (lane >> 1)] = mm[0];
  __syncthreads();
  // every warp combines the warps' maxima into its own copy of the
  // block's scale: no second barrier
  {
    float t = -INFINITY;
    if (lane < NMM) {
      t = mmw[lane];
      for (int w = 1; w < NW; ++w) t = fmaxf(t, mmw[w * 16 + lane]);
    }
    const float hi = __shfl_down_sync(FULL, t, NSC);
    if (lane < NSC) {
      scale[warp][lane] = -t;
      scale[warp][NSC + lane] = scale_den(-t, hi);
    }
    __syncwarp();
  }
  const float* smin = scale[warp];
  const float* sden = scale[warp] + NSC;

  // ---- 2. the values of the fit and the Gram + rhs sums ----
  float acc[NGP];
#pragma unroll
  for (int g = 0; g < NGP; ++g) acc[g] = 0.0f;
#pragma unroll 1
  for (int k = 0; k < PP; ++k) {
    const int e = tid + T * k;
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

  // ---- 3. transpose reduction of the sums ----
  // lane L ends with the warp's totals of sums 3L, 3L + 1, 3L + 2
  transpose_halves<SumOp, NGP, 5>(acc, lane);
#pragma unroll
  for (int i = 0; i < 3; ++i)
    if (3 * lane + i < NG) red[warp * NGP + 3 * lane + i] = acc[i];
  __syncthreads();

  // ---- 4. the solve on warp 0; the other warps rescale the basis ----
  if (warp == 0) {
    // lane r < NBUF: row r of [G; b^T], columns 0..NF-1 (entries above
    // the diagonal of G are read and never used)
    const int r = min(lane, NBUF - 1);
    float a[NF];
#pragma unroll
    for (int c = 0; c < NF; ++c) {
      const int idx = gram_index(min(r, c), max(r, c));
      float s = red[idx];
      for (int w = 1; w < NW; ++w) s += red[w * NGP + idx];
      a[c] = s;
    }
    // right-looking: at step j lane j's diagonal is final; lanes r > j
    // divide to L[r][j] (y_j on the colour rows), then every entry (r, c
    // > j) subtracts L[r][j] L[c][j] -- for each entry in the order
    // k = 0, 1, .., as _chol_kernel's loops take them
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      const float ljj = sqrtf(__shfl_sync(FULL, a[j], j));
      a[j] = lane == j ? ljj : a[j] / ljj;
#pragma unroll
      for (int c = j + 1; c < NF; ++c)
        a[c] = a[c] - a[j] * __shfl_sync(FULL, a[j], c);
    }
    if (lane < NBUF) {
#pragma unroll
      for (int c = 0; c < NF; ++c) sL[lane * NF + c] = a[c];
    }
    __syncwarp();
    // back solve L^T x = y: lane ch * NF + i computes x_i of colour ch
    // from column i of L, in the order k = i + 1, .., NF - 1
    const int ch = min(lane / NF, 2), i = lane - (lane / NF) * NF;
    float col[NF], x[NF];
#pragma unroll
    for (int k = 0; k < NF; ++k) col[k] = sL[k * NF + i];
    const float y = sL[(NF + ch) * NF + i];
    float xi = 0.0f;
#pragma unroll
    for (int s = NF - 1; s >= 0; --s) {
      float v = y;
#pragma unroll
      for (int k = s + 1; k < NF; ++k) v = v - col[k] * x[k];
      const float xs = v / col[s];
      if (i == s) xi = xs;
      x[s] = __shfl_sync(FULL, xs, ch * NF + s);
    }
    if (lane < 3 * NF) {
      const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
      const float wf = isnan(xi) ? 0.0f : xi;
      sw[ch * NF + i] = wf;
      weights[(b * NF + i) * 3 + ch] = wf;  // [n_blocks, F, 3]
    }
  } else {
    // the scaled basis features of every view cell, written over its
    // positions and colours (planes 3..8; the colours are read no more)
#pragma unroll 1
    for (int e = tid - 32; e < BP; e += T - 32) {
      float px[9];
#pragma unroll
      for (int c = 3; c < 6; ++c) px[c] = raw[c * BP + e];
#pragma unroll
      for (int j = 0; j < NSC; ++j)
        raw[(LO - 1 + j) * BP + e] = scaled_basis(px, j, smin, sden);
    }
  }
  __syncthreads();

  // ---- 5. reconstruction straight into the image ----
  const bool col_in = ix >= 0 && ix < W;
#pragma unroll 1
  for (int k = 0; k < PP; ++k) {
    const int iy = iy0 + NW * k;
    if (!col_in || iy < 0 || iy >= H) continue;
    // basis feature f >= 1 is plane f - 1: the normals, then the scaled
    // features of phase 4
    float basis[NF];
    basis[0] = 1.0f;
#pragma unroll
    for (int f = 1; f < NF; ++f) basis[f] = raw[(f - 1) * BP + tid + T * k];
    reconstruct_from_basis(basis, sw, out, n, (int64_t)iy * W + ix);
  }
}

template <int M>
int launch(const float* normals, const float* positions, const float* accum,
           float* out, float* weights, int H, int W, int blocks_x,
           int blocks_y, const int* frame, float amp, cudaStream_t stream) {
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  fit_chol_kernel<M><<<grid, T, 0, stream>>>(
      normals, positions, accum, out, weights, H, W, frame, amp);
  return (int)cudaGetLastError();
}

}  // namespace

// frame: the frame number, an int on the device (its jitter and noise are
// derived in the kernel, fitter_front.cuh); mode: the tmp dtype, 0 f32,
// 1 f16, 2 bf16; noise_amp: the hash noise's amplitude
extern "C" int bmfr_fit_reconstruct_cholesky(
    const float* normals, const float* positions, const float* accum,
    float* out, float* weights, int H, int W, int blocks_x, int blocks_y,
    const int* frame, int mode, float noise_amp, cudaStream_t stream) {
  if (mode == kF16)
    return launch<kF16>(normals, positions, accum, out, weights, H, W,
                        blocks_x, blocks_y, frame, noise_amp, stream);
  if (mode == kBF16)
    return launch<kBF16>(normals, positions, accum, out, weights, H, W,
                         blocks_x, blocks_y, frame, noise_amp, stream);
  return launch<kF32>(normals, positions, accum, out, weights, H, W,
                      blocks_x, blocks_y, frame, noise_amp, stream);
}
