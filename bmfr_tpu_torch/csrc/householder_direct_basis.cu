// The Householder direct fitter (kernel C) on any feature basis, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel _qr_kernel (bmfr_tpu/ops/fitter_direct.py,
// entries fit_blocks_direct and fit_reconstruct_direct) for a basis other
// than the default one: _qr_kernel evaluates whatever basis the config
// names (fitter_direct.py:180-181). The default basis keeps its own front
// (householder_direct.cu), which builds the 10 features from the raw
// planes in code.
//
// Here the wrapper (ops/fitter_direct.py) evaluates the basis with the
// feature registry into F f32 planes [F, H, W], and the kernel reads them
// with the accumulated colour through the same mirrored, jittered
// addressing as the raw planes (a feature is a per-pixel function, so
// mirror-then-evaluate equals evaluate-then-mirror). Any registered
// feature is served, not only expressions written in C.
//
// One CTA of 256 threads fits one 32x32 block of the jittered margins
// grid. Thread t owns view cells 4t .. 4t + 3 and holds their NB = F + 3
// values of the fit in registers (4 .. 16 columns, a template parameter,
// so every column index is static): the K1 store contract (NaN -> 0, f16
// clamp, storage rounding), the block min/max of every stored feature
// (one reduction; the fit rescales those from lo, the first scaled one),
// the rescale with its storage rounding, the hash noise on features 1..,
// then the reflections and the back substitution of householder.cuh. The
// reconstruction reads each in-image pixel's F planes again (from L2) and
// rescales the pre-rounding values, as fitter_direct.py:199-209 builds
// its basis.
//
// What bounds it on this card: as kernel C, the F barrier-separated
// reductions of each block; the bytes are (F + 3) planes in and the image
// out, (F + 6) * 3.7 MB per 1280x720 frame.

#include "householder.cuh"

namespace {

using namespace bmfr;

template <int M, int NB>
__global__ void __launch_bounds__(THREADS, NB <= 13 && M == kF32 ? 2 : 1)
fit_direct_basis_kernel(const float* __restrict__ feats,  // [F, H, W]
                        const float* __restrict__ accum,  // [3, H, W]
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
  const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int64_t n = (int64_t)H * W;
  const int e0 = 4 * tid;
  const int frame = __ldg(frame_ptr);
  const int2 jit = jitter_offset(frame, BE);
  const Noise nz = frame_noise(frame, amp, BP, NB);
  const int gy = (int)blockIdx.y * BE + (e0 >> 5) - BE / 2 + jit.y;
  const int gx0 = (int)blockIdx.x * BE + (e0 & 31) - BE / 2 + jit.x;
  const int64_t row = (int64_t)mirror(gy, H) * W;

  // the stored values of the fit straight from the loads
  float x[NB][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int64_t off = row + mirror(gx0 + k, W);
#pragma unroll
    for (int c = 0; c < F; ++c) x[c][k] = store<M>(feats[c * n + off]);
#pragma unroll
    for (int c = 0; c < 3; ++c) x[F + c][k] = store<M>(accum[c * n + off]);
  }

  // block min/max of the stored features: mm[c] = -min, mm[F + c] = max
  float mm[2 * F];
#pragma unroll
  for (int j = 0; j < 2 * F; ++j) mm[j] = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      mm[c] = fmaxf(mm[c], -x[c][k]);
      mm[F + c] = fmaxf(mm[F + c], x[c][k]);
    }
  }
  group_reduce<MaxOp, 2 * F>(mm, g, red + WARPS * RS);
  // the rescale (with its storage rounding) of the scaled features, then
  // the hash noise on features 1..
#pragma unroll
  for (int c = 1; c < F; ++c) {
    const float smin = -mm[c], sden = scale_den(smin, mm[F + c]);
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
    for (int c = 0; c < F; ++c) {
      smm[c] = -mm[c];
      smm[F + c] = mm[F + c];
    }
  }

  qr_registers<M, NB, false>(x, g, red, rows, rs, WARPS, 1);
  __syncthreads();
  if (tid < 3) {
    float w[F];
    back_substitute<F>(tid, [&](int c, int r) { return rs[c * 16 + r]; }, w);
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
  if (out == nullptr) return;
  __syncthreads();
  if (gy < 0 || gy >= H) return;
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
      float v = feats[f * n + off];
      if (f >= lo) v = (v - smm[f]) / scale_den(smm[f], smm[F + f]);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) col[ch] = col[ch] + v * sw[ch * F + f];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      out[ch * n + off] = isnan(col[ch]) ? col[ch] : fmaxf(col[ch], 0.0f);
  }
}

template <int M, int NB>
int launch(const float* feats, const float* accum, float* out, float* weights,
           float* mins_maxs, int H, int W, int blocks_x, int blocks_y, int lo,
           const int* frame, float amp, cudaStream_t stream) {
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  fit_direct_basis_kernel<M, NB><<<grid, THREADS, 0, stream>>>(
      feats, accum, out, weights, mins_maxs, H, W, lo, frame, amp);
  return (int)cudaGetLastError();
}

}  // namespace

// feats: the F feature planes [F, H, W]; accum: [3, H, W]; out (or null
// for the blocks entry) [3, H, W]; mins_maxs (or null) [n_blocks, F - lo,
// 2]; F: features (4 <= F + 3 <= 16); lo: features not scaled (>= 1);
// frame: the frame number, an int on the device (fitter_front.cuh); mode:
// tmp dtype 0 f32, 1 f16, 2 bf16; noise_amp: the hash noise's amplitude.
extern "C" int bmfr_fit_direct_householder_basis(
    const float* feats, const float* accum, float* out, float* weights,
    float* mins_maxs, int H, int W, int blocks_x, int blocks_y, int F, int lo,
    const int* frame, int mode, float noise_amp, cudaStream_t stream) {
  if (lo < 1 || lo > F) return (int)cudaErrorInvalidValue;
  return with_storage(mode, [&](auto, auto m) {
    constexpr int Mv = decltype(m)::value;
    return with_columns(F + 3, [&](auto nb) {
      return launch<Mv, decltype(nb)::value>(
          feats, accum, out, weights, mins_maxs, H, W, blocks_x, blocks_y,
          lo, frame, noise_amp, stream);
    });
  });
}
