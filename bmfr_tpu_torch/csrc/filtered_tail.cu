// K4 + K5 + the out/result pack (kernel F) for Hopper (sm_90a).
//
// Replaces what XLA fuses on the TPU out of the pre-blended branches of
// bmfr_tpu/ops/accumulate.py:16 (accumulate_filtered_data, K4: second
// temporal accumulation, albedo remodulation, tone map; opencl/bmfr.cl:
// 761-857) and bmfr_tpu/ops/taa.py:29 (taa, K5: YCoCg neighbourhood clamp
// and blend; opencl/bmfr.cl:860-974), and the next state's words 5:8 (w_out,
// bmfr_tpu/pipeline/denoise.py:272-277).
//
// Design: a 32x8 output tile and its one-pixel halo, one thread per cell
// of the 34x10 halo tile (340 threads, one round of loads; 256 threads
// walking the 340 cells in two rounds ran as fast, within the 5 % that
// one build varies between calls on the H100; PERF.md, kernel F).
//   1. K4 is a pure function of its pixel (the filtered colour, blend
//      planes 4 and 6:9, albedo, spp), so every in-image cell's thread
//      runs it, the halo's recomputed by every tile that borders it, and
//      writes out, tone and YCoCg(tone) to shared memory, the YCoCg in
//      the residual dtype (bf16 rounded to nearest even on the flagship,
//      f32 on the default path). The inner threads first issue the loads
//      of their own K5 inputs (planes 9:13, prev_pixels).
//   2. Each inner thread takes the box (3x3) and cross (5 pixels) min and max of
//      YCoCg over its in-image neighbours from shared memory, as max
//      pooling's -inf padding ignores the ones outside, clamps the
//      pre-blended previous result (planes 9:13) into the mean of the two
//      boxes, blends, and keeps its tone where the reprojection leaves the
//      screen; then it writes out, tone and result, and with a PackedState
//      carry the bf16 pairs (out 0:3, result 3:6) as words 5:8.
// Without TAA (frame 0, skip_taa) the result is the tone: one pass of K4
// per pixel, no halo.
//
// What bounds it on this card: bytes. Per pixel it reads the filtered
// colour, albedo, 8 blend planes, spp and prev_pixels (73 B) and writes
// out, tone, result and 3 words (48 B): 121 B, 112 MB per 1280x720 frame
// (33 us at 3.35 TB/s). The halo's 33 % more K4 reads are the tile's
// neighbours' own pixels and come from L2.
//
// Every operation runs in the plain version's order with its own rounding,
// the min/max and clamps with torch's NaN rules (torch_ops.cuh), so the
// kernel equals ops/tail.py::filtered_tail_reference on the card; powf is
// the CUDA math library's, as torch's pow with a scalar exponent calls it.

#include "torch_ops.cuh"

namespace {

using namespace torch_ops;

constexpr int TX = 32, TY = 8, HX = TX + 2, HY = TY + 2, CELLS = HX * HY;
constexpr float GAMMA = 0.454545f;  // np.float32(0.454545)

struct Params {
  const float* filtered;     // [3, H, W]
  const float* planes;       // [13, H, W] blend planes
  const float* albedo;       // [3, H, W]
  const uint8_t* spp;        // [H, W], K1's new spp
  const float* prev_pixels;  // [2, H, W]
  float* out;
  float* tone;
  float* result;             // unused without TAA (the result is the tone)
  int32_t* pack;             // the state's [8, H, W] words, or null
  int H, W;
  float second_alpha, taa_alpha, taa_keep;
  int accum_prev;            // history and not skip_second_accum
};

// K4 at pixel q: out and tone (ops/accumulate.py::accumulate_filtered_data)
__device__ __forceinline__ void k4(const Params& a, int64_t n, int64_t q,
                                   float o[3], float t[3]) {
  const float tw = a.planes[4 * n + q];
  const bool has_prev = a.accum_prev && tw > 0.0f;
  const float safe_tw = tw > 0.0f ? tw : 1.0f;
  // max(1 / spp, second_alpha); 1 / x is torch's reciprocal
  const float alpha =
      has_prev ? clamp_min(quot(1.0f, (float)a.spp[q]), a.second_alpha)
               : 1.0f;
  const float keep = sub(1.0f, alpha);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float prev =
        has_prev ? quot(a.planes[(6 + c) * n + q], safe_tw) : 0.0f;
    o[c] = add(mul(alpha, a.filtered[c * n + q]), mul(keep, prev));
    t[c] = clamp(powf(clamp_min(mul(a.albedo[c * n + q], o[c]), 0.0f), GAMMA),
                 0.0f, 1.0f);
  }
}

__device__ __forceinline__ void store_out(const Params& a, int64_t n,
                                          int64_t p, const float o[3],
                                          const float t[3], const float r[3]) {
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.out[c * n + p] = o[c];
    a.tone[c * n + p] = t[c];
  }
  if (a.pack != nullptr) {
    a.pack[5 * n + p] = pack_pair(o[0], o[1]);
    a.pack[6 * n + p] = pack_pair(o[2], r[0]);
    a.pack[7 * n + p] = pack_pair(r[1], r[2]);
  }
}

template <typename Y>
__device__ __forceinline__ Y to_residual(float v);
template <>
__device__ __forceinline__ float to_residual<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 to_residual<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float from_residual(float v) { return v; }
__device__ __forceinline__ float from_residual(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// K4 only: no TAA, so the result is the tone (ops/taa.py's early-out)
__global__ void __launch_bounds__(TX * TY)
filtered_tail_k4_kernel(Params a) {
  const int x = blockIdx.x * TX + threadIdx.x;
  const int y = blockIdx.y * TY + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const int64_t n = (int64_t)a.H * a.W, p = (int64_t)y * a.W + x;
  float o[3], t[3];
  k4(a, n, p, o, t);
  store_out(a, n, p, o, t, t);
}

// one thread per cell of the 34x10 halo tile: thread (hx, hy) runs K4
// for pixel (32 bx - 1 + hx, 8 by - 1 + hy), and the inner 32x8 threads
// then run K5 for their own pixel
template <typename Y>
__global__ void __launch_bounds__(CELLS)
filtered_tail_kernel(Params a) {
  __shared__ Y s_ycc[3][CELLS];
  __shared__ float s_out[3][CELLS];
  __shared__ float s_tone[3][CELLS];
  const int H = a.H, W = a.W;
  const int64_t n = (int64_t)H * W;
  const int c = threadIdx.y * HX + threadIdx.x;
  const int x = blockIdx.x * TX - 1 + threadIdx.x;
  const int y = blockIdx.y * TY - 1 + threadIdx.y;
  const bool in_image = x >= 0 && x < W && y >= 0 && y < H;
  const bool own = in_image && threadIdx.x >= 1 && threadIdx.x <= TX &&
                   threadIdx.y >= 1 && threadIdx.y <= TY;
  const int64_t p = in_image ? (int64_t)y * W + x : 0;

  // K5's own inputs, loaded first so that their latency overlaps phase 1
  float prev[3], tw = 0.0f, px = 0.0f, py = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) prev[k] = own ? a.planes[(9 + k) * n + p] : 0.0f;
  if (own) {
    tw = a.planes[12 * n + p];
    px = a.prev_pixels[p];
    py = a.prev_pixels[n + p];
  }

  // ---- 1. K4 on the tile and its halo ----
  if (in_image) {
    float o[3], t[3], ycc[3];
    k4(a, n, p, o, t);
    rgb_to_ycocg(t, ycc);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      s_out[k][c] = o[k];
      s_tone[k][c] = t[k];
      s_ycc[k][c] = to_residual<Y>(ycc[k]);
    }
  }
  __syncthreads();

  // ---- 2. K5 on the tile's own pixels ----
  if (!own) return;
  float o[3], t[3], lo[3], hi[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = s_out[k][c];
    t[k] = s_tone[k][c];
    float mx_box = -INFINITY, mn_box = INFINITY;
    float mx_cross = -INFINITY, mn_cross = INFINITY;
#pragma unroll
    for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
      for (int dx = -1; dx <= 1; ++dx) {
        if (y + dy < 0 || y + dy >= H || x + dx < 0 || x + dx >= W) continue;
        const float v = from_residual(s_ycc[k][c + dy * HX + dx]);
        mx_box = nan_max(mx_box, v);
        mn_box = nan_min(mn_box, v);
        if (dx == 0 || dy == 0) {
          mx_cross = nan_max(mx_cross, v);
          mn_cross = nan_min(mn_cross, v);
        }
      }
    }
    lo[k] = mul(add(mn_box, mn_cross), 0.5f);
    hi[k] = mul(add(mx_box, mx_cross), 0.5f);
  }

  // the previous result, pre-blended by the warp, clamped into the box
  const float safe_tw = tw > 0.0f ? tw : 1.0f;
  float prev_ycc[3], clamped[3], prev_rgb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) prev[k] = quot(prev[k], safe_tw);
  rgb_to_ycocg(prev, prev_ycc);
#pragma unroll
  for (int k = 0; k < 3; ++k) clamped[k] = clamp(prev_ycc[k], lo[k], hi[k]);
  ycocg_to_rgb(clamped, prev_rgb);

  // the reprojection fully off screen keeps the tone (XLA's floor to s32:
  // NaN -> 0, saturating, as cvt.rmi)
  const int ix = __float2int_rd(px);
  const int iy = __float2int_rd(py);
  const bool off_screen = ix < -1 || iy < -1 || ix >= W || iy >= H;
  float r[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    r[k] = off_screen ? t[k]
                      : add(mul(a.taa_alpha, t[k]), mul(a.taa_keep, prev_rgb[k]));
    a.result[k * n + p] = r[k];
  }
  store_out(a, n, p, o, t, r);
}

}  // namespace

extern "C" int bmfr_filtered_tail(const float* filtered, const float* planes,
                                  const float* albedo, const uint8_t* spp,
                                  const float* prev_pixels, float* out,
                                  float* tone, float* result, int32_t* pack,
                                  int H, int W, float second_alpha,
                                  float taa_alpha, float taa_keep,
                                  int residual_bf16, int accum_prev, int taa,
                                  cudaStream_t stream) {
  const Params a{filtered, planes,   albedo,       spp,
                 prev_pixels, out,    tone,         result,
                 pack,     H,         W,            second_alpha,
                 taa_alpha, taa_keep, accum_prev};
  const dim3 tile(TX, TY), halo(HX, HY);
  const dim3 blocks((W + TX - 1) / TX, (H + TY - 1) / TY);
  if (!taa)
    filtered_tail_k4_kernel<<<blocks, tile, 0, stream>>>(a);
  else if (residual_bf16)
    filtered_tail_kernel<__nv_bfloat16><<<blocks, halo, 0, stream>>>(a);
  else
    filtered_tail_kernel<float><<<blocks, halo, 0, stream>>>(a);
  return (int)cudaGetLastError();
}
