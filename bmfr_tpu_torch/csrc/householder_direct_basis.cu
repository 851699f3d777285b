// The Householder direct fitter (kernel C) on any feature basis, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _qr_kernel (bmfr_tpu/ops/fitter_direct.py,
// entries fit_blocks_direct and fit_reconstruct_direct) for a basis other
// than the default one: _qr_kernel evaluates whatever basis the config
// names (fitter_direct.py:180-181). The default basis keeps its own front
// (householder_direct.cu).
//
// The kernel reads the raw normals, positions and accumulated colour and
// computes each feature from its plane (basis_front.cuh: the built-in ones
// from the raw planes, any other from the extra planes the wrapper
// evaluates with the feature registry), through the mirrored, jittered
// addressing of the default front.
//
// One CTA of 256 threads fits one 32x32 block of the jittered margins
// grid. Thread t owns view cells 4t .. 4t + 3 and holds their NB = F + 3
// values of the fit in registers (4 .. 16 columns, a template parameter,
// so every column index is static): the K1 store contract (NaN -> 0, f16
// clamp, storage rounding), the block min/max of every stored feature
// but feature 0 (one reduction; the fit rescales those from lo >= 1),
// the rescale with its storage rounding, the hash noise on features 1..,
// then the reflections and the back substitution of householder.cuh. The
// reconstruction computes each in-image pixel's features again from its
// raw planes (from L2) and rescales the pre-rounding values, as
// fitter_direct.py:199-209 builds its basis.
//
// What bounds it on this card: as kernel C, the F barrier-separated
// reductions of each block, whose latency only another CTA on the SM
// hides, and the loads of the staging and the reconstruction. The kernel
// asks for 4 CTAs an SM up to 7 columns, 3 up to 10 and 2 above (at most
// 64, 85 and 128 registers a thread): at 16 columns 2 CTAs with a few
// dozen bytes of spill took 0.70x the time of 1 CTA without, and at 7 and
// 10 columns 4 and 3 CTAs 0.82x and 0.91x the time of 2 (PERF.md,
// Findings). The block min/max skips feature 0, never scaled, which
// spares the registers of two values. The bytes are the accumulated colour,
// the raw planes the features read and the K extra planes
// in (none on a basis of built-in features), the image out.

#include "basis_front.cuh"

namespace {

using namespace bmfr;

// rs as back_substitute reads it: column c at row r
struct RsAt {
  const float* rs;
  __device__ float operator()(int c, int r) const { return rs[c * 16 + r]; }
};

template <int M, int NB>
__global__ void __launch_bounds__(THREADS, NB <= 7 ? 4 : (NB <= 10 ? 3 : 2))
fit_direct_basis_kernel(const float* __restrict__ accum,  // [3, H, W]
                        const Basis basis,  // each feature's plane and op
                        float* __restrict__ out,          // [3, H, W] or null
                        float* __restrict__ weights,      // [n_blocks, F, 3]
                        float* __restrict__ mins_maxs,  // [n_blocks, F-lo, 2]
                        int H, int W, int lo,
                        const int* __restrict__ frame_ptr, float amp) {
  constexpr int F = NB - 3, RS = 2 * NB;
  __shared__ float red[2 * WARPS * RS];
  __shared__ float rows[2 * NB];
  __shared__ float rs[NB * 16];
  __shared__ float sw[3 * F];
  __shared__ float smm[2 * F];  // each feature's block min, then max
  const Group g = make_group(THREADS);
  const int tid = threadIdx.x;
  const int64_t n = (int64_t)H * W;
  const int e0 = 4 * tid;
  const int frame = __ldg(frame_ptr);
  const int2 jit = jitter_offset(frame, BE);
  const Noise nz = frame_noise(frame, amp, BP, NB);
  const int gy = (int)blockIdx.y * BE + (e0 >> 5) - BE / 2 + jit.y;
  const int gx0 = (int)blockIdx.x * BE + (e0 & 31) - BE / 2 + jit.x;
  const int64_t row = (int64_t)mirror(gy, H) * W;

  // ---- 1. the stored values of the fit and the block min/max ----
  float x[NB][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t off = row + mirror(gx0 + k, W);
#pragma unroll
    for (int c = 0; c < F; ++c)
      x[c][k] = store<M>(feature_value(basis, c, off));
#pragma unroll
    for (int c = 0; c < 3; ++c) x[F + c][k] = store<M>(accum[c * n + off]);
  }
  // features 1..F-1 (lo >= 1: feature 0 is never scaled): mm[c - 1] =
  // -min, mm[NS + c - 1] = max
  constexpr int NS = F > 1 ? F - 1 : 1;
  float mm[2 * NS];
#pragma unroll
  for (int j = 0; j < 2 * NS; ++j) mm[j] = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 1; c < F; ++c) {
      mm[c - 1] = fmaxf(mm[c - 1], -x[c][k]);
      mm[NS + c - 1] = fmaxf(mm[NS + c - 1], x[c][k]);
    }
  }
  group_reduce<MaxOp, 2 * NS>(mm, g, red + WARPS * RS);

  // ---- 2. the rescale, the noise and the reflections ----
  // the rescale (with its storage rounding) of the scaled features, then
  // the hash noise on features 1..
#pragma unroll
  for (int c = 1; c < F; ++c) {
    const float smin = -mm[c - 1], sden = scale_den(smin, mm[NS + c - 1]);
    const bool scaled = c >= lo;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float v = scaled ? quantize<M>((x[c][k] - smin) / sden)
                             : x[c][k];
      x[c][k] = v + noise_at(nz, c, e0 + k);
    }
  }
  if (tid == 0) {
#pragma unroll
    for (int c = 1; c < F; ++c) {
      smm[c] = -mm[c - 1];
      smm[F + c] = mm[NS + c - 1];
    }
  }
  qr_registers<M, NB, false>(x, g, red, rows, rs, WARPS, 1);
  __syncthreads();

  // ---- 3. the back substitution ----
  const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  if (tid < 3) {
    float w[F];
    back_substitute<F>(tid, RsAt{rs}, w);
#pragma unroll
    for (int f = 0; f < F; ++f) {
      sw[tid * F + f] = w[f];
      weights[(b * F + f) * 3 + tid] = w[f];  // [n_blocks, F, 3]
    }
  }
  if (mins_maxs != nullptr && tid >= lo && tid < F) {
    const int64_t j = b * (F - lo) + (tid - lo);
    mins_maxs[j * 2] = smm[tid];
    mins_maxs[j * 2 + 1] = smm[F + tid];
  }
  __syncthreads();

  // ---- 4. reconstruction straight into the image ----
  if (out != nullptr && gy >= 0 && gy < H) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int ix = gx0 + k;
      if (ix < 0 || ix >= W) continue;
      // an in-image view cell reads its own pixel; the basis is the
      // pre-rounding, unsanitized feature, rescaled from lo on
      const int64_t off = (int64_t)gy * W + ix;
      float col[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int f = 0; f < F; ++f) {
        float v = feature_value(basis, f, off);
        if (f >= lo) v = (v - smm[f]) / scale_den(smm[f], smm[F + f]);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + v * sw[ch * F + f];
      }
#pragma unroll
      for (int ch = 0; ch < 3; ++ch)
        out[ch * n + off] = isnan(col[ch]) ? col[ch] : fmaxf(col[ch], 0.0f);
    }
  }
}

template <int M, int NB>
int launch(const float* accum, const Basis& basis, float* out, float* weights,
           float* mins_maxs, int H, int W, int blocks_x, int blocks_y, int lo,
           const int* frame, float amp, cudaStream_t stream) {
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  fit_direct_basis_kernel<M, NB><<<grid, THREADS, 0, stream>>>(
      accum, basis, out, weights, mins_maxs, H, W, lo, frame, amp);
  return (int)cudaGetLastError();
}

}  // namespace

// accum: [3, H, W]; planes: a host array of F device addresses, feature
// i's plane (basis_front.cuh); ops_lo, ops_hi: feature i's op in byte i % 8
// of word i / 8; out (or null for the blocks entry) [3, H, W]; mins_maxs
// (or null) [n_blocks, F - lo, 2]; F: features (4 <= F + 3 <= 16); lo:
// features not scaled (>= 1); frame: the frame number, an int on the
// device (fitter_front.cuh); mode: tmp dtype 0 f32, 1 f16, 2 bf16;
// noise_amp: the hash noise's amplitude.
extern "C" int bmfr_fit_direct_householder_basis(
    const float* accum, const unsigned long long* planes,
    unsigned long long ops_lo, unsigned long long ops_hi, float* out,
    float* weights, float* mins_maxs, int H, int W, int blocks_x,
    int blocks_y, int F, int lo, const int* frame, int mode, float noise_amp,
    cudaStream_t stream) {
  if (lo < 1 || lo > F) return (int)cudaErrorInvalidValue;
  const Basis basis = make_basis(planes, F, ops_lo, ops_hi);
  return with_storage(mode, [&](auto, auto m) {
    constexpr int Mv = decltype(m)::value;
    return with_columns(F + 3, [&](auto nb) {
      return launch<Mv, decltype(nb)::value>(accum, basis, out, weights,
                                             mins_maxs, H, W, blocks_x,
                                             blocks_y, lo, frame, noise_amp,
                                             stream);
    });
  });
}
