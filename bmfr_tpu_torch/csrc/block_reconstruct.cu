// The block reconstruction (kernel K) for Hopper (sm_90a).
//
// Replaces what XLA fuses on the TPU out of weighted_sum
// (bmfr_tpu/ops/weighted_sum.py:27; opencl/bmfr.cl:703-758): the image
// window of the block-layout product max(sum_f basis_f * w_f, 0). Per image
// pixel (y, x) it finds its block under the inverse jitter, the margins-grid
// cell (y + half - oy, x + half - ox) (ops/weighted_sum.py::
// weighted_sum_image's mapping, the same cell unblockify_planes slices), takes
// the pixel's features (feature_table.cuh), rescales those from lo on with
// the block's mins_maxs ((v - min) / d, d = max - min only where
// |max - min| > 1: fitter.scale_with_mins_maxs), dots them with the block's
// [F, 3] weights in f32 and clamps at 0 with NaN kept (torch.clamp_min).
// The slice, the rescale, the product and the clamp are one pass with no
// [n_blocks, 3, block_pixels] intermediate.
//
// The features: the plain version reuses tmp's feature rows under f32
// storage, whose K1 store contract turned NaN into 0, and evaluates the raw
// f32 features (NaN kept) under f16/bf16 storage. A pixel's tmp row is its
// own pixel's features (an in-image cell mirrors onto itself), so the kernel
// reads the raw planes either way and applies NaN -> 0 exactly when the
// flag `sanitize` says the plain version reads tmp.
//
// The plain version's product is a batched matrix product whose summation
// order this kernel does not copy: each colour is one fused multiply-add
// chain in feature order, held to the plain version within a stated
// tolerance (chip_smoke.py K_TOL), NaN where NaN.
//
// What bounds it on this card: bytes. Per pixel it reads the planes of the
// basis (the 6 raw geometry planes of the default basis, 24 B; the
// constant reads the first normal plane again, from L1) and writes 3
// planes (12 B); the weights and mins_maxs of a block (168 B) are shared by
// its ~1000 pixels: 33 MB per 1280x720 frame (10 us at 3.35 TB/s). One
// thread per pixel, coalesced along x.

#include "feature_table.cuh"
#include "torch_ops.cuh"

namespace {

using namespace bmfr;

__global__ void block_reconstruct_kernel(FeatureTable table,
                                         const float* __restrict__ weights,
                                         const float* __restrict__ mins_maxs,
                                         float* __restrict__ out,
                                         const int* __restrict__ frame,
                                         int H, int W, int be, int blocks_x,
                                         int F, int lo, int sanitize) {
  const int64_t n = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;
  const int y = (int)(p / W), x = (int)(p - (int64_t)(p / W) * W);
  const int half = be / 2;
  const int2 off = jitter_offset(__ldg(frame), be);
  // the cell is never negative: the jitter lies in [-half, half)
  const int b = ((y + half - off.y) / be) * blocks_x + (x + half - off.x) / be;
  const float* w = weights + (int64_t)b * F * 3;
  const float* mm = mins_maxs + (int64_t)b * (F - lo) * 2;

  float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int f0 = 0; f0 < kMaxFeatures; f0 += 4) {
    if (f0 >= F) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = f0 + j < F ? feature_value(table, f0 + j, p) : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = f0 + j;
      if (f >= F) break;
      float s = sanitize && isnan(v[j]) ? 0.0f : v[j];
      if (f >= lo) {
        const float bmin = __ldg(mm + 2 * (f - lo));
        const float bmax = __ldg(mm + 2 * (f - lo) + 1);
        const float range = torch_ops::sub(bmax, bmin);
        const float d = fabsf(range) > 1.0f ? range : 1.0f;
        s = torch_ops::quot(torch_ops::sub(s, bmin), d);
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) acc[k] = fmaf(s, __ldg(w + 3 * f + k), acc[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) out[k * n + p] = torch_ops::clamp_min(acc[k], 0.0f);
}

}  // namespace

// planes/ops: the feature table's host arrays (make_feature_table);
// weights f32[n_blocks, F, 3]; mins_maxs f32[n_blocks, F - lo, 2]; out
// f32[3, H, W]; sanitize: NaN -> 0 on the features (the plain version
// reads f32 tmp)
extern "C" int bmfr_block_reconstruct(const unsigned long long* planes,
                                      const unsigned long long* ops, int F,
                                      int lo, const float* weights,
                                      const float* mins_maxs, float* out,
                                      const int* frame, int H, int W, int be,
                                      int blocks_x, int sanitize,
                                      cudaStream_t stream) {
  if (F < 1 || F > kMaxFeatures || lo < 0 || lo > F)
    return (int)cudaErrorInvalidValue;
  const FeatureTable table = make_feature_table(planes, ops, F);
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  block_reconstruct_kernel<<<blocks, threads, 0, stream>>>(
      table, weights, mins_maxs, out, frame, H, W, be, blocks_x, F, lo,
      sanitize);
  return (int)cudaGetLastError();
}
