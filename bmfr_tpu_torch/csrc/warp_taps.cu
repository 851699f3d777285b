// The raw-plane tap warp + blend (kernel I) for Hopper (sm_90a).
//
// Replaces what XLA fuses on the TPU on every path whose warp is not the
// fused kernel: stack_state (bmfr_tpu/pipeline/denoise.py:115-119),
// gather_taps (bmfr_tpu/ops/warp.py:65) and the tap branches of K1, K4 and
// K5 (bmfr_tpu/ops/reproject.py:78-114, accumulate.py:32-55,
// taa.py:72-97). For every pixel it reads the four clipped bilinear taps
// (clip(iy+dy), clip(ix+dx)) of the 16 recurrent channels straight from
// the TemporalState's six tensors (positions, normals, noisy colour:
// f32[3, H, W]; spp: u8[H, W]; out, result: f32[3, H, W]), with no stacked
// copy and no [4, 16, H, W] tap tensor, and writes the 13 blend planes of
// blend_from_taps in kernel A's layout (bmfr_tpu_torch/ops/warp_blend.py).
//
// The warp mode is a template parameter:
//   kF32      the taps as they are (warp_mode "float32");
//   kPairs    every tap rounded to bf16, nearest-even: the values the
//             channel-pair pack of "packed_bf16" holds, at the same
//             coordinates;
//   kXPairs   every tap rounded to bf16 at the coordinates of the x-pair
//             words of "packed_x_bf16": the dx = 1 taps read the high half
//             of the word at clip(ix), which is column min(clip(ix)+1, W-1)
//             for ix >= 0 and, through the ix < 0 select, column 0 below.
//             That equals clip(ix + 1) everywhere but at ix = INT_MAX,
//             where ix + 1 wraps to INT_MIN (column 0) and the word gives
//             column W-1 (tests/test_torch_default_kernels.py proves both
//             rules against gather_taps).
// The coordinates, the masks and the blend are tap_blend.cuh's, which
// kernel A shares.
//
// What bounds it on this card: bytes. Per pixel it reads pfx, pfy and the
// 6 current planes (32 B) and writes 13 planes (52 B); the state it
// gathers is 61 B a pixel (15 f32 and the u8 spp) read once: 145 B, 134 MB
// per 1280x720 frame (40 us at 3.35 TB/s). One thread per pixel, x
// fastest, so the 64 gathered loads of a warp fall on a few neighbouring
// rows of each plane (reprojection is coherent) and hit L1/L2 after the
// first; the taps stay in registers.
//
// The arithmetic mirrors the plain version operation by operation, so
// the planes equal ops/warp_blend.py::warp_blend_planes_reference's.

#include "tap_blend.cuh"

namespace {

using namespace tap_blend;

enum TapMode { kF32 = 0, kPairs = 1, kXPairs = 2 };

template <int MODE>
__device__ __forceinline__ float tap_value(float v) {
  if (MODE == kF32) return v;
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <int MODE>
__global__ void warp_taps_kernel(const float* __restrict__ prev_positions,
                                 const float* __restrict__ prev_normals,
                                 const float* __restrict__ prev_noisy,
                                 const uint8_t* __restrict__ prev_spp,
                                 const float* __restrict__ prev_out,
                                 const float* __restrict__ prev_result,
                                 const float* __restrict__ positions,
                                 const float* __restrict__ normals,
                                 const float* __restrict__ pfx,
                                 const float* __restrict__ pfy,
                                 float* __restrict__ dst, int H, int W,
                                 float pos_lim, float nrm_lim) {
  const int64_t n = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  const Taps tp = pixel_taps(pfx[p], pfy[p], H, W);
  // the x-pair word at clip(ix) holds column min(clip(ix) + 1, W - 1) in
  // its high half, which the ix < 0 select replaces by the low half
  const int cx1 = MODE == kXPairs
                      ? (tp.ix < 0 ? 0 : min(tp.cx0 + 1, W - 1))
                      : tp.cx1;
  float cur[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cur[c] = positions[c * n + p];
    cur[3 + c] = normals[c * n + p];
  }

  Sums s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t o = tap_offset(tp, i, cx1);
    float t[16];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      t[c] = tap_value<MODE>(__ldg(prev_positions + c * n + o));
      t[3 + c] = tap_value<MODE>(__ldg(prev_normals + c * n + o));
      t[6 + c] = tap_value<MODE>(__ldg(prev_noisy + c * n + o));
      t[10 + c] = tap_value<MODE>(__ldg(prev_out + c * n + o));
      t[13 + c] = tap_value<MODE>(__ldg(prev_result + c * n + o));
    }
    t[9] = tap_value<MODE>((float)__ldg(prev_spp + o));
    add_tap(s, tp, i, t, cur, pos_lim, nrm_lim);
  }
  store(dst, n, p, s);
}

}  // namespace

// mode: 0 float32, 1 packed_bf16, 2 packed_x_bf16 (ops/warp_blend.py::
// TAP_MODES); any other value returns cudaErrorInvalidValue
extern "C" int bmfr_warp_taps(const float* prev_positions,
                              const float* prev_normals,
                              const float* prev_noisy, const uint8_t* prev_spp,
                              const float* prev_out, const float* prev_result,
                              const float* positions, const float* normals,
                              const float* pfx, const float* pfy, float* dst,
                              int H, int W, float pos_lim, float nrm_lim,
                              int mode, cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
#define BMFR_WARP_TAPS(M)                                                   \
  warp_taps_kernel<M><<<blocks, threads, 0, stream>>>(                      \
      prev_positions, prev_normals, prev_noisy, prev_spp, prev_out,         \
      prev_result, positions, normals, pfx, pfy, dst, H, W, pos_lim, nrm_lim)
  switch (mode) {
    case kF32: BMFR_WARP_TAPS(kF32); break;
    case kPairs: BMFR_WARP_TAPS(kPairs); break;
    case kXPairs: BMFR_WARP_TAPS(kXPairs); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BMFR_WARP_TAPS
  return (int)cudaGetLastError();
}
