// Clipped row-pair gather of an x-pair-packed source (kernel E) for Hopper
// (sm_90a).
//
// Replaces the TPU kernel _warp_kernel (bmfr_tpu/ops/warp_pallas.py, entry
// warp_rows_pallas). For every pixel p = (y, x) and channel c:
//   row0[c, p] = src[c, clip(iy[p], 0, H-1), clip(ix[p], 0, W-1)]
//   row1[c, p] = src[c, clip(iy[p] + 1, 0, H-1), clip(ix[p], 0, W-1)]
// with iy + 1 wrapping at INT_MAX, as XLA and torch add int32 (the sum is
// taken in unsigned arithmetic: signed overflow is undefined in C++). The
// TPU kernel emulates a gather with window plans, a fix-up of uncovered
// pixels and a whole-frame fallback; the card has a hardware gather, so
// one thread per pixel reads both rows directly and the result equals the
// plain version (ops/warp.py::warp_rows_reference) on every pixel.
//
// What bounds it on this card: bytes. Per pixel it reads iy and ix (8 B),
// gathers 2C words and writes 2C words: at C = 16, 264 B per pixel, 243 MB
// per 1280x720 frame (73 us at 3.35 TB/s) if every gathered word came
// from DRAM. Reprojection is coherent, so neighbouring threads gather
// neighbouring words and most gathers hit L2; the stores are coalesced
// along x (one thread per pixel, x fastest).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ int clip(int i, int n) { return min(max(i, 0), n - 1); }

__global__ void warp_rows_kernel(const int32_t* __restrict__ src,
                                 const int32_t* __restrict__ iy,
                                 const int32_t* __restrict__ ix,
                                 int32_t* __restrict__ row0,
                                 int32_t* __restrict__ row1, int C, int H,
                                 int W) {
  const int64_t n = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int y = iy[p];
  const int y1 = (int)((unsigned)y + 1u);  // two's-complement wrap
  const int cx = clip(ix[p], W);
  const int64_t off0 = (int64_t)clip(y, H) * W + cx;
  const int64_t off1 = (int64_t)clip(y1, H) * W + cx;
  for (int c = 0; c < C; ++c) {
    row0[c * n + p] = __ldg(src + c * n + off0);
    row1[c * n + p] = __ldg(src + c * n + off1);
  }
}

}  // namespace

extern "C" int bmfr_warp_rows(const int32_t* src, const int32_t* iy,
                              const int32_t* ix, int32_t* row0, int32_t* row1,
                              int C, int H, int W, cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp_rows_kernel<<<blocks, threads, 0, stream>>>(src, iy, ix, row0, row1, C,
                                                   H, W);
  return (int)cudaGetLastError();
}
