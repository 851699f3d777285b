// The reprojection (kernel H) for Hopper (sm_90a).
//
// Replaces what XLA fuses on the TPU out of bmfr_tpu/ops/reproject.py:22
// (reproject_coords, opencl/bmfr.cl:338-356) inside the jitted step. For
// every pixel it projects the world position with the previous camera and
// writes the previous-frame coordinates pfx, pfy as the two planes of
// prev_pixels f32[2, H, W]. The camera f32[4, 4] and the sub-pixel offset
// f32[2] are read on the card, never on the host, so a captured step
// replays with each frame's values. With the history flag off (frame 0)
// it writes each pixel's own coordinates, which K1 records at frame 0
// (ops/reproject.py::accumulate_noisy_data).
//
// What bounds it on this card: bytes. Per pixel it reads 3 f32 and writes
// 2: 20 B, 18 MB per 1280x720 frame (5.5 us at 3.35 TB/s). One thread per
// pixel, coalesced along x; the 18 camera and offset words are the same
// for every thread and stay in the read-only cache.
//
// Kernel A computes its accept bits from pfx/pfy by compares against
// limits, so one ulp moves a bit: every operation runs in the plain
// version's order with its own rounding (torch_ops.cuh), bit-equal to
// ops/reproject.py::reproject_coords_reference on the card.

#include "torch_ops.cuh"

namespace {

using namespace torch_ops;

// cam[0, col] * x + cam[1, col] * y + cam[2, col] * z + cam[3, col], left
// to right
__device__ __forceinline__ float cam_dot(const float* __restrict__ cam,
                                         int col, float x, float y, float z) {
  return add(add(add(mul(__ldg(cam + col), x), mul(__ldg(cam + 4 + col), y)),
                 mul(__ldg(cam + 8 + col), z)),
             __ldg(cam + 12 + col));
}

__global__ void reproject_kernel(const float* __restrict__ positions,
                                 const float* __restrict__ cam,
                                 const float* __restrict__ offset,
                                 float* __restrict__ out, int H, int W,
                                 int history) {
  const int64_t n = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  if (!history) {
    out[p] = (float)(p % W);
    out[n + p] = (float)(p / W);
    return;
  }
  const float x = positions[p], y = positions[n + p], z = positions[2 * n + p];
  const float u = cam_dot(cam, 0, x, y, z), v = cam_dot(cam, 1, x, y, z),
              w = cam_dot(cam, 3, x, y, z);
  const float po0 = __ldg(offset), po1 = __ldg(offset + 1);
  // ((u / w + 1) * 0.5) * W - offset[0]; the same in y with 1 - offset[1]
  out[p] = sub(mul(mul(add(quot(u, w), 1.0f), 0.5f), (float)W), po0);
  out[n + p] = sub(mul(mul(add(quot(v, w), 1.0f), 0.5f), (float)H),
                   sub(1.0f, po1));
}

}  // namespace

extern "C" int bmfr_reproject(const float* positions, const float* cam,
                              const float* offset, float* out, int H, int W,
                              int history, cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  reproject_kernel<<<blocks, threads, 0, stream>>>(positions, cam, offset, out,
                                                   H, W, history);
  return (int)cudaGetLastError();
}
