// The block fitter (kernel D) for Hopper (sm_90a), register-resident
// route: block_edge <= 32 (at most 1024 pixels a block).
//
// Replaces the TPU kernel _fitter_kernel (bmfr_tpu/ops/fitter_pallas.py,
// entry fit_blocks_pallas): from pre-built blocks tmp [n_blocks, NB, bp]
// in the storage dtype (f32, f16 or bf16) it rescales the scaled features
// by the block min/max, rounds them to the storage dtype, adds the hash
// noise (computed here, not rounded), runs the F = NB - 3 Householder
// reflections with the storage rounding of every trailing column after
// each (householder.cuh), and back-substitutes the reduced F x F system
// against the 3 colours. Outputs: weights [n_blocks, F, 3] and mins_maxs
// [n_blocks, F - lo, 2] (from the stored values). Blocks past 1024 pixels
// take householder_blocks_smem.cu.
//
// Layout (ops/fitter_pallas.py::launch_geometry): a group of G threads
// fits one block, thread gt holding rows 4 gt .. 4 gt + 3 of all NB
// columns in registers (52 floats at NB = 13), loaded as one vector per
// column (16 bytes in f32, 8 in f16/bf16). G = bp / 4, rounded up to a
// whole number of warps above 32 (rows past the block are zero): 16
// threads at block_edge 8 (16 blocks per CTA of 256), 64 at 16 (4
// blocks), 160 at 24, 256 at 32. Dots and updates never leave the
// registers; a group of 16 (HALF, its own instance) reduces and hands out
// the pivot row with warp shuffles alone, larger groups with one barrier
// per reflection.
//
// What bounds it on this card: the 10 reductions per block, each a
// dependent chain of shuffles (and a barrier above 32 threads). The
// arithmetic is ~0.4 GFLOP per 1280x720 frame (6 us at the f32 peak),
// the bytes 52 MB in (16 us at 3.35 TB/s), so the chain, not the card's
// rates, sets its time; several resident CTAs per SM (launch bounds of 2
// x 256 threads, <= 128 registers, for f32 tmp with up to 13 columns;
// 14 to 16 columns, and f16/bf16 tmp, whose rounding needs a few more
// registers, take 1 x 256 and up to 255 registers rather than spill)
// hide it.

#include "householder.cuh"

namespace {

using namespace bmfr;

// rows e0 .. e0 + 3 of one column: one 16-byte (f32) or 8-byte (f16,
// bf16) load
__device__ __forceinline__ void load4(const float* p, float (&v)[4]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load4(const __half* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a = __half22float2(*reinterpret_cast<const __half2*>(&q.x));
  const float2 b = __half22float2(*reinterpret_cast<const __half2*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&v)[4]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  const float2 a =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.x));
  const float2 b =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&q.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

// Shared scratch (dynamic, sized by launch_geometry): red [2][warps][2 NB],
// rows [2][groups][NB], rs [groups][NB][16].
template <typename T, int M, int NB, bool HALF>
__global__ void __launch_bounds__(THREADS, NB <= 13 && M == kF32 ? 2 : 1)
fit_blocks_regs_kernel(const T* __restrict__ tmp, float* __restrict__ weights,
                       float* __restrict__ mins_maxs, int nb, int lo, int bp,
                       int G, const int* __restrict__ frame, float amp) {
  constexpr int F = NB - 3, RS = 2 * NB;
  extern __shared__ float smem[];
  // ---- 1. loads ----
  const Group g = make_group(G);
  const int groups = blockDim.x / G, warps = (blockDim.x + 31) / 32;
  float* red = smem;
  float* rows = red + 2 * warps * RS;
  float* rs = rows + 2 * groups * NB + g.grp * NB * 16;
  const int64_t b = (int64_t)blockIdx.x * groups + g.grp;
  const bool active = b < nb;
  const int e0 = 4 * g.gt;
  const bool rows_in = active && e0 < bp;  // bp is a multiple of 64

  float x[NB][4];
#pragma unroll
  for (int c = 0; c < NB; ++c) {
    if (rows_in) {
      load4(tmp + (b * NB + c) * bp + e0, x[c]);
    } else {
#pragma unroll
      for (int r = 0; r < 4; ++r) x[c][r] = 0.0f;
    }
  }

  // ---- 2. block min/max and rescale ----
  // block min/max of the scaled features (opencl/bmfr.cl:511-542):
  // mm[c] = max(-x) = -min, mm[F + c] = max
  float mm[2 * F];
#pragma unroll
  for (int c = 0; c < 2 * F; ++c) mm[c] = -INFINITY;
  if (rows_in) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mm[c] = fmaxf(mm[c], -x[c][r]);
        mm[F + c] = fmaxf(mm[F + c], x[c][r]);
      }
    }
  }
  group_reduce<MaxOp, 2 * F>(mm, g, red + warps * RS);
  if (active && g.gt == 0) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      if (c >= lo) {
        mins_maxs[(b * (F - lo) + c - lo) * 2] = -mm[c];
        mins_maxs[(b * (F - lo) + c - lo) * 2 + 1] = mm[F + c];
      }
    }
  }

  // rescale + storage rounding, then the noise on the feature columns.
  // The frame is read here, not at the start: held across the reduction
  // its word spilled the f32 13-column instance (12 B stores, 52 B loads)
  const Noise nz = frame_noise(__ldg(frame), amp, bp, NB);
  if (rows_in) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float v = x[c][r];
        if (c >= lo) v = quantize<M>((v + mm[c]) / scale_den(-mm[c], mm[F + c]));
        if (c > 0) v = v + noise_at(nz, c, e0 + r);
        x[c][r] = v;
      }
    }
  }

  // ---- 3. reflections ----
  qr_registers<M, NB, HALF>(x, g, red, rows, rs, warps, groups);
  if (HALF) {
    __syncwarp();
  } else {
    __syncthreads();
  }
  // ---- 4. back substitution ----
  if (active && g.gt < 3) {
    float w[F];
    back_substitute<F>(g.gt, [&](int c, int r) { return rs[c * 16 + r]; }, w);
#pragma unroll
    for (int f = 0; f < F; ++f) weights[(b * F + f) * 3 + g.gt] = w[f];
  }
}

}  // namespace

// Register route of kernel D. mode: tmp dtype 0 f32, 1 f16, 2 bf16; B:
// columns (4..16); group, blocks_per_cta, smem: the launch geometry;
// frame: the frame number, an int on the device; noise_amp: the hash
// noise's amplitude (fitter_front.cuh).
extern "C" int bmfr_fit_blocks_registers(const void* tmp, float* weights,
                                         float* mins_maxs, int nb, int B,
                                         int lo, int bp, int mode, int group,
                                         int blocks_per_cta, int smem,
                                         const int* frame, float noise_amp,
                                         cudaStream_t stream) {
  const unsigned grid = (unsigned)((nb + blocks_per_cta - 1) / blocks_per_cta);
  return with_storage(mode, [&](auto tag, auto m) {
    using T = typename decltype(tag)::type;
    return with_columns(B, [&](auto cols) {
      constexpr int NB = decltype(cols)::value, Mv = decltype(m)::value;
      const unsigned threads = (unsigned)(blocks_per_cta * group);
      if (group == 16)
        fit_blocks_regs_kernel<T, Mv, NB, true><<<grid, threads, smem, stream>>>(
            (const T*)tmp, weights, mins_maxs, nb, lo, bp, group, frame,
            noise_amp);
      else
        fit_blocks_regs_kernel<T, Mv, NB, false><<<grid, threads, smem, stream>>>(
            (const T*)tmp, weights, mins_maxs, nb, lo, bp, group, frame,
            noise_amp);
      return (int)cudaGetLastError();
    });
  });
}
