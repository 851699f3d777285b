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
// basis (the 6 raw geometry planes of the default basis, 24 B) and writes 3
// planes (12 B); the weights and mins_maxs of a block (168 B) are shared by
// its ~1000 pixels: 33 MB per 1280x720 frame (10 us at 3.35 TB/s).
//
// The layout. On the TPU each block is one [block_pixels, F] x [F, 3]
// product; a 10 x 3 product is too shallow for tensor cores, so here one
// CTA owns a 32 x 32 tile of the margins grid, which at block_edge 32 is
// one block of the fit. The grid is the whole margins grid whatever the
// frame (ops/weighted_sum.py::reconstruct_geometry sizes it from the
// config; the frame is read on the card, so one captured launch serves
// every jitter). The CTA finds the tile's image window under the inverse
// jitter, clipped to the image; an empty window leaves before any barrier,
// the whole CTA together. It stages the weights and (min, d) of each block
// the window touches in shared memory once, d computed once per feature
// and block; where block_edge is a multiple of 32 the tile lies in one
// block whatever the jitter, so those loads go out beside the frame's. Its
// 128 threads are the tile's 32 columns by 4 bands of 8
// rows: a warp walks one row of 32 cells at a time, one 128 B run the
// jitter leaves unaligned. A band starts at a multiple of 8 and so does a
// block (block_edge is a multiple of 8), so a thread's 8 pixels lie in one
// block, whatever block_edge is. The default basis' threads copy their
// block's 42 values into registers and read 6 planes per pixel (the
// constant is 1, each square comes from its position's register); any
// other basis reads its features through the table and the block's values
// from shared memory. Indices are 32-bit (H * W < 2^31).

#include "feature_table.cuh"
#include "torch_ops.cuh"

namespace {

using namespace bmfr;

// the tile of the margins grid a CTA owns (cells a side), the rows of a
// thread's band, and the CTA's threads (ops/weighted_sum.py: TILE, BAND,
// THREADS)
constexpr int kTile = 32;
constexpr int kBand = 8;
constexpr int kThreads = kTile * (kTile / kBand);

// the default basis: const, normal_{x,y,z}, world_position_{x,y,z} and
// their squares, the first four not rescaled (fitter_direct.plane_table:
// planes 1-3 the normals, 4-6 the positions, 7-9 the positions squared)
constexpr int kDefaultF = 10;
constexpr int kDefaultLo = 4;
constexpr int kDefaultScaled = kDefaultF - kDefaultLo;

// feature value v as the plain version's basis holds it: NaN -> 0 where
// it reads f32 tmp, then (v - min) / d where the feature is rescaled
__device__ __forceinline__ float basis_value(float v, int sanitize,
                                             bool scaled, float2 md) {
  const float s = sanitize && isnan(v) ? 0.0f : v;
  return scaled ? torch_ops::quot(torch_ops::sub(s, md.x), md.y) : s;
}

// Stage the (min, d) pairs [blocks][fm] and then the weights [blocks][fw]
// of the nby x nbx blocks from (by0, bx0) on in shared memory, d = max -
// min only where |max - min| > 1, once per feature and block; the blocks
// of a row of them lie side by side in both arrays.
__device__ __forceinline__ void stage_blocks(
    float2* smem, const float* __restrict__ weights,
    const float* __restrict__ mins_maxs, int bx0, int by0, int nbx, int nby,
    int blocks_x, int fw, int fm) {
  float* s_w = reinterpret_cast<float*>(smem + nby * nbx * fm);
  for (int i = threadIdx.x; i < nby * nbx * fw; i += kThreads) {
    const int j = i / (nbx * fw);
    s_w[i] = __ldg(weights + ((by0 + j) * blocks_x + bx0) * fw + i -
                   j * nbx * fw);
  }
  for (int i = threadIdx.x; i < nby * nbx * fm; i += kThreads) {
    const int j = i / (nbx * fm);
    const float* mm =
        mins_maxs + 2 * (((by0 + j) * blocks_x + bx0) * fm + i - j * nbx * fm);
    const float bmin = __ldg(mm), bmax = __ldg(mm + 1);
    const float range = torch_ops::sub(bmax, bmin);
    smem[i] = make_float2(bmin, fabsf(range) > 1.0f ? range : 1.0f);
  }
}

template <bool kDefaultBasis>
__global__ void __launch_bounds__(kThreads, 8)
    block_reconstruct_kernel(FeatureTable table,
                             const float* __restrict__ weights,
                             const float* __restrict__ mins_maxs,
                             float* __restrict__ out,
                             const int* __restrict__ frame, int H, int W,
                             int be, int blocks_x, int F, int lo,
                             int sanitize) {
  // ---- 1. set-up: the window, its blocks' weights and divisors ----
  const int fr = __ldg(frame);
  const int half = be / 2;
  const int mx0 = blockIdx.x * kTile, my0 = blockIdx.y * kTile;
  const int fw = F * 3, fm = F - lo;
  extern __shared__ float2 smem[];
  // a tile inside one block (block_edge a multiple of 32) knows its block
  // before the frame: its values load while the frame does
  const bool one_block = be % kTile == 0;
  if (one_block)
    stage_blocks(smem, weights, mins_maxs, mx0 / be, my0 / be, 1, 1,
                 blocks_x, fw, fm);
  // the image pixel the tile's first cell falls on, and the window
  const int2 off = jitter_offset(fr, be);
  const int x0 = mx0 - half + off.x, y0 = my0 - half + off.y;
  const int xa = max(x0, 0), xb = min(x0 + kTile, W);
  const int ya = max(y0, 0), yb = min(y0 + kTile, H);
  if (xa >= xb || ya >= yb) return;
  // the blocks the window touches (a cell is never negative: the jitter
  // lies in [-half, half))
  const int bx0 = (mx0 + xa - x0) / be, by0 = (my0 + ya - y0) / be;
  const int nbx = (mx0 + xb - 1 - x0) / be - bx0 + 1;
  const int nby = (my0 + yb - 1 - y0) / be - by0 + 1;
  if (!one_block)
    stage_blocks(smem, weights, mins_maxs, bx0, by0, nbx, nby, blocks_x, fw,
                 fm);
  const float2* s_md = smem;
  const float* s_w = reinterpret_cast<const float*>(smem + nby * nbx * fm);
  __syncthreads();

  // the thread's column and band, and the block they lie in
  const int c = threadIdx.x % kTile, band = threadIdx.x / kTile;
  const int x = x0 + c;
  const int r0 = max(ya, y0 + band * kBand);
  const int r1 = min(yb, y0 + band * kBand + kBand);
  if (x < xa || x >= xb || r0 >= r1) return;
  const int slot = ((my0 + band * kBand) / be - by0) * nbx +
                   (mx0 + c) / be - bx0;
  const float2* md = s_md + slot * fm;
  const float* w = s_w + slot * fw;
  const int n = H * W;
  float* out0 = out + x;
  float* out1 = out0 + n;
  float* out2 = out1 + n;

  if constexpr (kDefaultBasis) {
    float wr[kDefaultF * 3];
    float2 mdr[kDefaultScaled];
#pragma unroll
    for (int i = 0; i < kDefaultF * 3; ++i) wr[i] = w[i];
#pragma unroll
    for (int i = 0; i < kDefaultScaled; ++i) mdr[i] = md[i];
#pragma unroll 1
    for (int y = r0; y < r1; ++y) {
      // ---- 2. loads and products ----
      const int p = y * W + x;
      float v[kDefaultF];
      v[0] = 1.0f;
#pragma unroll
      for (int f = 1; f < 7; ++f) v[f] = __ldg(table.plane[f] + p);
#pragma unroll
      for (int f = 7; f < kDefaultF; ++f) v[f] = __fmul_rn(v[f - 3], v[f - 3]);
      float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int f = 0; f < kDefaultF; ++f) {
        const float s = basis_value(
            v[f], sanitize, f >= kDefaultLo,
            mdr[f >= kDefaultLo ? f - kDefaultLo : 0]);
#pragma unroll
        for (int k = 0; k < 3; ++k) acc[k] = fmaf(s, wr[3 * f + k], acc[k]);
      }
      // ---- 3. stores ----
      const int q = y * W;
      out0[q] = torch_ops::clamp_min(acc[0], 0.0f);
      out1[q] = torch_ops::clamp_min(acc[1], 0.0f);
      out2[q] = torch_ops::clamp_min(acc[2], 0.0f);
    }
  } else {
#pragma unroll 1
    for (int y = r0; y < r1; ++y) {
      // ---- 2. loads and products ----
      const int p = y * W + x;
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
          const float s = basis_value(v[j], sanitize, f >= lo,
                                      f >= lo ? md[f - lo] : float2{});
#pragma unroll
          for (int k = 0; k < 3; ++k)
            acc[k] = fmaf(s, w[3 * f + k], acc[k]);
        }
      }
      // ---- 3. stores ----
      const int q = y * W;
      out0[q] = torch_ops::clamp_min(acc[0], 0.0f);
      out1[q] = torch_ops::clamp_min(acc[1], 0.0f);
      out2[q] = torch_ops::clamp_min(acc[2], 0.0f);
    }
  }
}

}  // namespace

// planes/ops: the feature table's host arrays (make_feature_table);
// weights f32[n_blocks, F, 3]; mins_maxs f32[n_blocks, F - lo, 2]; out
// f32[3, H, W]; sanitize: NaN -> 0 on the features (the plain version
// reads f32 tmp); default_basis: the table is the default basis' (F = 10,
// lo = 4); tiles_x, tiles_y, smem: the launch (reconstruct_geometry)
extern "C" int bmfr_block_reconstruct(const unsigned long long* planes,
                                      const unsigned long long* ops, int F,
                                      int lo, const float* weights,
                                      const float* mins_maxs, float* out,
                                      const int* frame, int H, int W, int be,
                                      int blocks_x, int sanitize,
                                      int default_basis, int tiles_x,
                                      int tiles_y, int smem,
                                      cudaStream_t stream) {
  if (F < 1 || F > kMaxFeatures || lo < 0 || lo > F || be % kBand ||
      (default_basis && (F != kDefaultF || lo != kDefaultLo)))
    return (int)cudaErrorInvalidValue;
  const FeatureTable table = make_feature_table(planes, ops, F);
  const dim3 grid(tiles_x, tiles_y);
  if (default_basis)
    block_reconstruct_kernel<true><<<grid, kThreads, smem, stream>>>(
        table, weights, mins_maxs, out, frame, H, W, be, blocks_x, F, lo,
        sanitize);
  else
    block_reconstruct_kernel<false><<<grid, kThreads, smem, stream>>>(
        table, weights, mins_maxs, out, frame, H, W, be, blocks_x, F, lo,
        sanitize);
  return (int)cudaGetLastError();
}
