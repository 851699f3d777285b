// Householder QR fitters for Hopper (sm_90a): the block fitter (kernel D)
// and the direct fitter (kernel C), one CUDA core for both.
//
// Kernel D replaces the TPU kernel _fitter_kernel
// (bmfr_tpu/ops/fitter_pallas.py, entry fit_blocks_pallas): from
// pre-built blocks tmp [n_blocks, B, bp] in the storage dtype (f32, f16 or
// bf16; any block_edge 8..64) it rescales the scaled features by the block
// min/max, rounds them to the storage dtype, adds the hash noise (not
// rounded), runs the F Householder reflections with the storage rounding
// of every trailing column after each, and back-substitutes the reduced
// F x F system against the 3 colours in the kernel. Outputs: weights
// [n_blocks, F, 3] and mins_maxs [n_blocks, n_scaled, 2] (from the stored
// values).
//
// Kernel C replaces the TPU kernel _qr_kernel
// (bmfr_tpu/ops/fitter_direct.py, entries fit_blocks_direct and
// fit_reconstruct_direct): kernel B's front half (fitter_front.cuh: mirror
// loads of the raw planes, features, K1 store contract, scale, noise), the
// same reflections and back substitution, then either the reconstruction
// straight into the image or the weights and mins/maxs.
//
// One CTA of 256 threads fits one block. The block's matrix, column b at
// data + b * bp, lives in shared memory (dynamic: 13 x 1024 x 4 = 53 KB
// at block_edge 32, 213 KB at 64, under the 227 KB a block may use).
// Per reflection col (bmfr_tpu/ops/fitter.py:90-115, opencl/bmfr.cl:
// 549-656): sigma = sum_{e > col} v_e^2, vec_len = sqrt(sigma + pivot^2),
// head = pivot - vec_len, u_len_sq = sigma + head^2; every trailing column
// c gets c -= (2 / u_len_sq)(u . c) u and the storage rounding; column col
// becomes (r_0..r_{col-1}, vec_len, 0...). The reference's cross-colour
// reflections only touch rows the solve never reads and are skipped, as
// in the JAX package. The two CTA-wide sums of a reflection (sigma, then
// the up to 12 dot products at once) are warp-shuffle trees and one
// 8-way shared-memory pass, in plain f32 on the CUDA cores.
//
// What bounds it on this card: the chain of 2 F CTA-wide reductions with
// a barrier each. The arithmetic is small (~2 x 13 x 1024 x 10 = 0.27M
// FMAs per block, 0.26G per 1280x720 frame, 4 ms of one SM's lanes but
// ~30 us over 132 SMs), the bytes smaller (53 KB per block in, 0.1 KB
// out, 52 MB per frame); the design keeps the whole block on chip, so the
// 10 reflections never touch device memory, and relies on several
// resident CTAs per SM (4 at 53 KB) to hide the barriers.

#include "fitter_front.cuh"

namespace {

using namespace bmfr;

constexpr int MAXB = 16;  // columns (features + colours) a block may have

struct SumOp {
  __device__ static float f(float a, float b) { return a + b; }
};
struct MinOp {
  __device__ static float f(float a, float b) { return fminf(a, b); }
};
struct MaxOp {
  __device__ static float f(float a, float b) { return fmaxf(a, b); }
};

// Reduce the per-thread partials v[c], c in [lo, hi), over the CTA; every
// thread ends with the totals in v (warp tree, then warps 0..7 in order).
// red: shared scratch of WARPS * N floats. Begins and ends with a barrier
// on the caller's side of red.
template <class Op, int N>
__device__ __forceinline__ void block_reduce(float (&v)[N], int lo, int hi,
                                             float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c >= lo && c < hi) {
      float s = v[c];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        s = Op::f(s, __shfl_xor_sync(0xffffffffu, s, o));
      if (lane == 0) red[warp * N + c] = s;
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < N; ++c) {
    if (c >= lo && c < hi) {
      float s = red[c];
      for (int w = 1; w < WARPS; ++w) s = Op::f(s, red[w * N + c]);
      v[c] = s;
    }
  }
  __syncthreads();
}

// In-place Householder QR of data (B columns of bp values) over its first
// F columns, with the storage rounding after each reflection. Call after
// a barrier; ends with one.
template <int M>
__device__ void householder_qr(float* data, int B, int F, int bp,
                               float* red) {
  const int tid = threadIdx.x;
  for (int col = 0; col < F; ++col) {
    const float* v = data + col * bp;
    const float pivot = v[col];
    float s[1] = {0.0f};
    for (int e = tid; e < bp; e += THREADS)
      if (e > col) s[0] += v[e] * v[e];
    block_reduce<SumOp>(s, 0, 1, red);
    const float sigma = s[0];
    const float vec_len = sqrtf(sigma + pivot * pivot);
    const float head = pivot - vec_len;
    const float u_len_sq = sigma + head * head;

    float d[MAXB];
#pragma unroll
    for (int c = 0; c < MAXB; ++c) d[c] = 0.0f;
    for (int e = tid; e < bp; e += THREADS) {
      const float u = e > col ? v[e] : (e == col ? head : 0.0f);
#pragma unroll
      for (int c = 0; c < MAXB; ++c)
        if (c > col && c < B) d[c] += u * data[c * bp + e];
    }
    block_reduce<SumOp>(d, col + 1, B, red);

    const float coef = 2.0f / u_len_sq;
    for (int e = tid; e < bp; e += THREADS) {
      const float ve = v[e];
      const float u = e > col ? ve : (e == col ? head : 0.0f);
#pragma unroll
      for (int c = 0; c < MAXB; ++c) {
        if (c > col && c < B) {
          float* x = data + c * bp + e;
          // (coef * dot) * u, unfused, as the plain version evaluates it
          *x = quantize<M>(__fsub_rn(*x, __fmul_rn(__fmul_rn(coef, d[c]), u)));
        }
      }
      data[col * bp + e] = e < col ? ve : (e == col ? vec_len : 0.0f);
    }
    __syncthreads();
  }
}

// Back substitution R w = Q^T b (opencl/bmfr.cl:657-699) with R[r][c] =
// data[c * bp + r] and the right-hand side of colour ch in column F + ch:
// w[ch * F + r], one thread per colour. Ends with a barrier.
__device__ void back_substitute(const float* data, int F, int bp, float* w) {
  const int ch = threadIdx.x;
  if (ch < 3) {
    for (int r = F - 1; r >= 0; --r) {
      float acc = data[(F + ch) * bp + r];
      for (int c = r + 1; c < F; ++c) acc = acc - data[c * bp + r] * w[ch * F + c];
      w[ch * F + r] = acc / data[r * bp + r];
    }
  }
  __syncthreads();
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- kernel D: the block fitter (tmp in storage type T, mode M) ----
template <typename T, int M>
__global__ void __launch_bounds__(THREADS)
fit_blocks_kernel(const T* __restrict__ tmp,
                  const float* __restrict__ noise,  // [F, bp], row 0 zero
                  float* __restrict__ weights, float* __restrict__ mins_maxs,
                  int B, int F, int lo, int bp) {
  extern __shared__ float data[];  // [B][bp]
  __shared__ float red[WARPS * MAXB];
  __shared__ float sw[3 * MAXB];
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const T* src = tmp + b * B * bp;
  for (int i = tid; i < B * bp; i += THREADS) data[i] = to_float(src[i]);
  __syncthreads();

  // block min/max of the scaled features (opencl/bmfr.cl:511-542)
  float mn[MAXB], mx[MAXB];
#pragma unroll
  for (int c = 0; c < MAXB; ++c) {
    mn[c] = INFINITY;
    mx[c] = -INFINITY;
  }
  for (int e = tid; e < bp; e += THREADS) {
#pragma unroll
    for (int c = 0; c < MAXB; ++c) {
      if (c >= lo && c < F) {
        const float x = data[c * bp + e];
        mn[c] = fminf(mn[c], x);
        mx[c] = fmaxf(mx[c], x);
      }
    }
  }
  block_reduce<MinOp>(mn, lo, F, red);
  block_reduce<MaxOp>(mx, lo, F, red);
  const int n_sc = F - lo;
#pragma unroll
  for (int c = 0; c < MAXB; ++c) {
    if (c >= lo && c < F && tid == c - lo) {
      mins_maxs[(b * n_sc + tid) * 2] = mn[c];
      mins_maxs[(b * n_sc + tid) * 2 + 1] = mx[c];
    }
  }

  // rescale + storage rounding, then the noise on the feature columns
  for (int e = tid; e < bp; e += THREADS) {
#pragma unroll
    for (int c = 0; c < MAXB; ++c) {
      if (c < F) {
        float x = data[c * bp + e];
        if (c >= lo) {
          const float r = mx[c] - mn[c];
          x = quantize<M>((x - mn[c]) / (fabsf(r) > 1.0f ? r : 1.0f));
        }
        data[c * bp + e] = x + noise[c * bp + e];
      }
    }
  }
  __syncthreads();

  householder_qr<M>(data, B, F, bp, red);
  back_substitute(data, F, bp, sw);
  for (int i = tid; i < 3 * F; i += THREADS)
    weights[b * F * 3 + i] = sw[(i % 3) * F + i / 3];  // [n_blocks, F, 3]
}

// ---- kernel C: the direct fitter ----
template <int M>
__global__ void __launch_bounds__(THREADS)
fit_direct_kernel(const float* __restrict__ normals,
                  const float* __restrict__ positions,
                  const float* __restrict__ accum,
                  const float* __restrict__ noise,  // [NF, BP], row 0 zero
                  float* __restrict__ out,          // [3, H, W] or null
                  float* __restrict__ weights,      // [n_blocks, NF, 3]
                  float* __restrict__ mins_maxs,    // [n_blocks, NSC, 2] or null
                  int H, int W, int ox, int oy) {
  extern __shared__ float dyn[];
  float* raw = dyn;            // [9][BP]
  float* data = dyn + 9 * BP;  // [NBUF][BP]
  __shared__ float red[WARPS * MAXB];
  __shared__ float smin[NSC], smax[NSC], sden[NSC];
  __shared__ float sw[3 * NF];
  const int tid = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;

  stage_raw(raw, normals, positions, accum, H, W, ox, oy);
  __syncthreads();
  block_scale<M>(raw, red, smin, smax, sden);
#pragma unroll
  for (int k = 0; k < PPT; ++k) {
    const int e = tid + THREADS * k;
    float v[NBUF];
    fit_values<M>(raw, e, smin, sden, noise, v);
#pragma unroll
    for (int c = 0; c < NBUF; ++c) data[c * BP + e] = v[c];
  }
  __syncthreads();

  householder_qr<M>(data, NBUF, NF, BP, red);
  back_substitute(data, NF, BP, sw);
  if (tid < 3 * NF) weights[b * NF * 3 + tid] = sw[(tid % 3) * NF + tid / 3];
  if (mins_maxs != nullptr && tid < NSC) {
    mins_maxs[(b * NSC + tid) * 2] = smin[tid];
    mins_maxs[(b * NSC + tid) * 2 + 1] = smax[tid];
  }
  if (out != nullptr) reconstruct(raw, smin, sden, sw, out, H, W, ox, oy);
}

// Opt in to more than 48 KB of dynamic shared memory (once per kernel).
template <typename K>
int allow_smem(K kernel, int bytes, int* granted) {
  if (bytes <= *granted) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return (int)err;
}

template <typename T, int M>
int launch_fit_blocks(const void* tmp, const float* noise, float* weights,
                      float* mins_maxs, int nb, int B, int F, int lo, int bp,
                      cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int smem = B * bp * (int)sizeof(float);
  const int err = allow_smem(fit_blocks_kernel<T, M>, smem, &granted);
  if (err != 0) return err;
  fit_blocks_kernel<T, M><<<(unsigned)nb, THREADS, smem, stream>>>(
      (const T*)tmp, noise, weights, mins_maxs, B, F, lo, bp);
  return (int)cudaGetLastError();
}

template <int M>
int launch_fit_direct(const float* normals, const float* positions,
                      const float* accum, const float* noise, float* out,
                      float* weights, float* mins_maxs, int H, int W,
                      int blocks_x, int blocks_y, int ox, int oy,
                      cudaStream_t stream) {
  static int granted = 48 * 1024;
  const int smem = (9 + NBUF) * BP * (int)sizeof(float);
  const int err = allow_smem(fit_direct_kernel<M>, smem, &granted);
  if (err != 0) return err;
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  fit_direct_kernel<M><<<grid, THREADS, smem, stream>>>(
      normals, positions, accum, noise, out, weights, mins_maxs, H, W, ox, oy);
  return (int)cudaGetLastError();
}

}  // namespace

// tmp dtype (and rounding mode): 0 f32, 1 f16, 2 bf16. B <= 16.
extern "C" int bmfr_fit_blocks_householder(const void* tmp, const float* noise,
                                           float* weights, float* mins_maxs,
                                           int nb, int B, int F, int lo,
                                           int bp, int mode,
                                           cudaStream_t stream) {
  if (B > MAXB) return (int)cudaErrorInvalidValue;
  if (mode == kF16)
    return launch_fit_blocks<__half, kF16>(tmp, noise, weights, mins_maxs, nb,
                                           B, F, lo, bp, stream);
  if (mode == kBF16)
    return launch_fit_blocks<__nv_bfloat16, kBF16>(tmp, noise, weights,
                                                   mins_maxs, nb, B, F, lo, bp,
                                                   stream);
  return launch_fit_blocks<float, kF32>(tmp, noise, weights, mins_maxs, nb, B,
                                        F, lo, bp, stream);
}

extern "C" int bmfr_fit_direct_householder(
    const float* normals, const float* positions, const float* accum,
    const float* noise, float* out, float* weights, float* mins_maxs, int H,
    int W, int blocks_x, int blocks_y, int ox, int oy, int mode,
    cudaStream_t stream) {
  if (mode == kF16)
    return launch_fit_direct<kF16>(normals, positions, accum, noise, out,
                                   weights, mins_maxs, H, W, blocks_x,
                                   blocks_y, ox, oy, stream);
  if (mode == kBF16)
    return launch_fit_direct<kBF16>(normals, positions, accum, noise, out,
                                    weights, mins_maxs, H, W, blocks_x,
                                    blocks_y, ox, oy, stream);
  return launch_fit_direct<kF32>(normals, positions, accum, noise, out,
                                 weights, mins_maxs, H, W, blocks_x, blocks_y,
                                 ox, oy, stream);
}
