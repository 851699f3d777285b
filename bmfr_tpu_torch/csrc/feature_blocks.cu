// The feature-block store (kernel J) for Hopper (sm_90a).
//
// Replaces what XLA fuses on the TPU out of build_feature_blocks
// (bmfr_tpu/ops/blockify.py:181; opencl/bmfr.cl:447-476): the feature
// basis and the accumulated colour, NaN -> 0, clamped to +-65504 under f16
// storage, laid out as the tmp [n_blocks, buffer_count, block_pixels] that
// kernel D fits, in the storage dtype. Margins-grid cell (gy, gx) of block
// b = (gy / be) * blocks_x + gx / be, element e = (gy % be) * be + gx % be,
// reads image pixel (mirror(gy - half + oy, H), mirror(gx - half + ox, W))
// (ops/blockify.py: jittered_view and view_to_blocks), (ox, oy) the frame's
// jitter from fitter_front.cuh's table (scaled by be / 32 with floor, >> 5)
// and the frame read on the card, so a captured step replays every frame.
//
// The basis is the wrapper's feature table (feature_table.cuh): the
// built-in features computed here from the raw planes, a registered one
// read from the plane the wrapper evaluated. The storage mode is a
// template parameter; each cast rounds to nearest even (__float2half_rn,
// __float2bfloat16_rn, as torch's casts on the card).
//
// What bounds it on this card: bytes. It reads the 9 raw planes (33 MB at
// 1280x720; the margins grid reads 9 % more, from L2) and writes tmp,
// 984 * 13 * 1024 values (52 MB in f32, 26 MB in f16/bf16): 26 us (18 us)
// at 3.35 TB/s. One thread per margins-grid cell, cells in tmp's element
// order: a warp reads 32 neighbouring pixels of each plane and writes a
// contiguous run of each row of a block (128 B in f32). A thread loads its
// features four at a time before it stores them.

#include "feature_table.cuh"

namespace {

using namespace bmfr;

template <int M>
struct Stored;
template <>
struct Stored<kF32> {
  using T = float;
  static __device__ __forceinline__ T from(float v) { return v; }
};
template <>
struct Stored<kF16> {
  using T = __half;
  static __device__ __forceinline__ T from(float v) {
    return __float2half_rn(v);
  }
};
template <>
struct Stored<kBF16> {
  using T = __nv_bfloat16;
  static __device__ __forceinline__ T from(float v) {
    return __float2bfloat16_rn(v);
  }
};

// the K1 store contract (fitter_front.cuh::store) and the cast
template <int M>
__device__ __forceinline__ typename Stored<M>::T stored(float v) {
  return Stored<M>::from(store<M>(v));
}

template <int M>
__global__ void feature_blocks_kernel(FeatureTable table,
                                      const float* __restrict__ accum,
                                      typename Stored<M>::T* __restrict__ out,
                                      const int* __restrict__ frame, int H,
                                      int W, int be, int blocks_x, int F,
                                      int64_t cells) {
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= cells) return;
  const int bp = be * be;
  const int b = (int)(p / bp);
  const int e = (int)(p - (int64_t)b * bp);
  const int ey = e / be, ex = e - ey * be;
  const int by = b / blocks_x, bx = b - by * blocks_x;
  const int half = be / 2;
  const int2 off = jitter_offset(__ldg(frame), be);
  const int y = mirror(by * be + ey - half + off.y, H);
  const int x = mirror(bx * be + ex - half + off.x, W);
  const int64_t n = (int64_t)H * W;
  const int64_t px = (int64_t)y * W + x;
  typename Stored<M>::T* row = out + (int64_t)b * (F + 3) * bp + e;

#pragma unroll
  for (int f0 = 0; f0 < kMaxFeatures; f0 += 4) {
    if (f0 >= F) break;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      v[j] = f0 + j < F ? feature_value(table, f0 + j, px) : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (f0 + j < F) row[(int64_t)(f0 + j) * bp] = stored<M>(v[j]);
  }
  float c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = __ldg(accum + k * n + px);
#pragma unroll
  for (int k = 0; k < 3; ++k) row[(int64_t)(F + k) * bp] = stored<M>(c[k]);
}

}  // namespace

// planes/ops: the feature table's host arrays (make_feature_table); mode:
// the storage code (kF32, kF16, kBF16); out: tmp, n_blocks * (F + 3) *
// be * be values of the storage dtype
extern "C" int bmfr_feature_blocks(const unsigned long long* planes,
                                   const unsigned long long* ops, int F,
                                   const float* accum, void* out,
                                   const int* frame, int H, int W, int be,
                                   int blocks_x, int n_blocks, int mode,
                                   cudaStream_t stream) {
  if (F < 1 || F > kMaxFeatures) return (int)cudaErrorInvalidValue;
  const FeatureTable table = make_feature_table(planes, ops, F);
  const int threads = 256;
  const int64_t cells = (int64_t)n_blocks * be * be;
  const unsigned blocks = (unsigned)((cells + threads - 1) / threads);
#define BMFR_FEATURE_BLOCKS(M)                                              \
  feature_blocks_kernel<M><<<blocks, threads, 0, stream>>>(                 \
      table, accum, static_cast<typename Stored<M>::T*>(out), frame, H, W,  \
      be, blocks_x, F, cells)
  switch (mode) {
    case kF32: BMFR_FEATURE_BLOCKS(kF32); break;
    case kF16: BMFR_FEATURE_BLOCKS(kF16); break;
    case kBF16: BMFR_FEATURE_BLOCKS(kBF16); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef BMFR_FEATURE_BLOCKS
  return (int)cudaGetLastError();
}
