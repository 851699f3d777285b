// Fused temporal warp + per-stage blend (kernel A) for Hopper (sm_90a).
//
// Replaces the TPU kernel _blend_kernel3 (bmfr_tpu/ops/warp_pallas.py,
// entry warp_blend_pallas). One thread per pixel with a direct global
// gather, the reference's own design (opencl/bmfr.cl:374-419): the thread
// reads the 8 int32 channel-pair words of the previous state at each of
// the 4 clipped bilinear taps (clip(iy+dy), clip(ix+dx)), unpacks them to
// 16 bf16->f32 channels, and runs blend_from_taps
// (bmfr_tpu_torch/ops/warp_blend.py) to write the 13 blend planes.
// floor, the bilinear fractions and the mask bits are computed here from
// pfx/pfy, never transported.
//
// What bounds it on this card: bytes. Per pixel it gathers 32 words
// (128 B, mostly L2 hits: reprojection is coherent, so neighbouring
// threads read neighbouring words), reads 8 f32 (pfx, pfy, 6 current
// planes) and writes 13 f32 planes: with one read of the 8 state words,
// 116 B of compulsory DRAM traffic per pixel, 107 MB per 1280x720 frame
// (32 us at 3.35 TB/s). The design keeps every access
// coalesced along x (one thread per pixel, x fastest), reads each tap word
// once, and keeps the 16 channels of a tap in registers, so no
// intermediate tap plane is ever written.
//
// The coordinates, the masks and the blend are tap_blend.cuh's (which
// kernel I shares): operation by operation the plain PyTorch version's,
// unfused, which keeps the limit compares (and hence the accept bits)
// identical to the plain version's.

#include "tap_blend.cuh"

namespace {

using namespace tap_blend;

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

__global__ void warp_blend_kernel(const int32_t* __restrict__ src8,
                                  const float* __restrict__ positions,
                                  const float* __restrict__ normals,
                                  const float* __restrict__ pfx,
                                  const float* __restrict__ pfy,
                                  float* __restrict__ out, int H, int W,
                                  float pos_lim, float nrm_lim) {
  const int64_t n = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  const Taps tp = pixel_taps(pfx[p], pfy[p], H, W);
  float cur[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cur[c] = positions[c * n + p];
    cur[3 + c] = normals[c * n + p];
  }

  Sums s;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t o = tap_offset(tp, i, tp.cx1);
    float t[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t u = (uint32_t)__ldg(src8 + k * n + o);
      t[2 * k] = bf16_lo(u);
      t[2 * k + 1] = bf16_hi(u);
    }
    add_tap(s, tp, i, t, cur, pos_lim, nrm_lim);
  }
  store(out, n, p, s);
}

}  // namespace

extern "C" int bmfr_warp_blend(const int32_t* src8, const float* positions,
                               const float* normals, const float* pfx,
                               const float* pfy, float* out, int H, int W,
                               float pos_lim, float nrm_lim,
                               cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp_blend_kernel<<<blocks, threads, 0, stream>>>(
      src8, positions, normals, pfx, pfy, out, H, W, pos_lim, nrm_lim);
  return (int)cudaGetLastError();
}
