// K4 + K5 + the out/result pack (kernel F) for Hopper (sm_90a).
//
// Replaces what XLA fuses on the TPU out of the pre-blended branches of
// bmfr_tpu/ops/accumulate.py:16 (accumulate_filtered_data, K4: second
// temporal accumulation, albedo remodulation, tone map; opencl/bmfr.cl:
// 761-857) and bmfr_tpu/ops/taa.py:29 (taa, K5: YCoCg neighbourhood clamp
// and blend; opencl/bmfr.cl:860-974), and the next state's words 5:8 (w_out,
// bmfr_tpu/pipeline/denoise.py:272-277).
//
// What bounds it on this card: bytes, 31 us at 3.35 TB/s. Per pixel it
// reads the filtered colour, albedo, 8 blend planes, spp and prev_pixels
// (65 B) and writes out, tone and result (36 B) and, with a PackedState
// carry, 3 words (12 B): 113 B, 104.1 MB per 1280x720 frame (93.1 MB,
// 28 us, on the default path, which carries no words). Its arithmetic
// (three powf and three IEEE divisions a K4 cell, 1.20 cells a pixel,
// three more divisions in K5) is where a plain design spends its time,
// so the design below keeps the loads in flight behind it and cuts the
// instructions around it.
//
// Design: persistent CTAs (the card's SMs times the CTAs that fit, two at
// 32x16), each walking output tiles of TX x TY in a static stride, one
// thread a pixel, a warp a row of 32.
//   Loads. A tile's inputs land in one stage of a two-stage ring in
//   shared memory: six boxes, one TMA copy each, of the runs of planes
//   K4 reads (filtered 0:3, blend 4, blend 6:9, albedo 0:3) as (TX + 8)
//   x (TY + 2) boxes from (x0 - 4, y0 - 1), the one-pixel halo with a
//   16-byte-aligned left edge, and of K5's (blend 9:13, prev_pixels) as
//   TX x TY boxes. With TmaLoads one thread of the last warp (which runs
//   no halo cell) issues them, a tile ahead, completing on the stage's
//   mbarrier; the hardware fills cells outside the image, which the
//   kernel never reads. TMA needs every plane's address and row (W * 4 B)
//   to be a multiple of 16 B (ops/tail.py::filtered_tail_loader); other
//   shapes run the same body with ThreadLoads, every thread filling one
//   stage with 4 B loads before the tile. spp (u8) is loaded by the
//   threads a tile ahead, into registers, and K4's weights by spp come
//   from a 256-entry table each CTA computes once.
//   1. Each thread runs K4 on its pixel from shared memory, keeps out and
//      tone in registers and writes YCoCg(tone) to shared memory in the
//      residual dtype (bf16 rounded to nearest even on the flagship, f32
//      on the default path); the first 2 (TX + 2) + 2 TY threads also run
//      K4 on one halo cell each (1.20 K4 cells a pixel at 32x16). K5's
//      inputs move from the stage to registers, so one barrier frees the
//      stage and publishes the YCoCg (double-buffered: a tile's K4 never
//      overwrites what a slower warp of the last tile still reads).
//   2. Each thread takes the box (3x3) and cross (5 pixels) min and max
//      of YCoCg over its pixel's in-image neighbours (column extremes
//      shared along the row by warp shuffles; see neighbourhood), clamps
//      the pre-blended previous result (planes 9:13) into the mean of the
//      two boxes, blends, keeps the tone where the reprojection leaves
//      the screen, and stores out, tone, result and the words, a warp
//      128 B a plane.
// Without TAA (frame 0, skip_taa) the result is the tone: one pass of K4
// per pixel, one pixel a thread, no halo (filtered_tail_k4_kernel), which
// also stores the tone as the result where the result has a buffer of its
// own (a TemporalState carry's).
// Out and result go where the wrapper points them: fresh tensors, or a
// TemporalState carry's out and result, written in place as XLA writes
// the step's donated outputs (bmfr_tpu/pipeline/denoise.py:279-287). The
// stores are 4 B a thread along x, so no output needs more alignment
// than its element's.
//
// Every value equals ops/tail.py::filtered_tail_reference's on the card:
// each product, sum and quotient is rounded on its own (torch_ops.cuh),
// the clamps keep torch's NaN rules, powf is the CUDA math library's (as
// torch's pow with a scalar exponent calls it), and the neighbourhood's
// extremes, taken in another order and with max.NaN / min.NaN, give max
// pooling's values (see max_nan).
//
// The tile shape and ring depth are compile-time (BMFR_F_TX, BMFR_F_TY,
// BMFR_F_STAGES) so scripts/torch_chol_phases.py --kernel F can sweep them
// (PERF.md, kernel F).

#include <cuda.h>  // CUtensorMap and its encoder's types; no -lcuda

#include <cstring>
#include <mutex>
#include <type_traits>

#include "torch_ops.cuh"

#ifndef BMFR_F_TX
#define BMFR_F_TX 32
#endif
#ifndef BMFR_F_TY
#define BMFR_F_TY 16
#endif
#ifndef BMFR_F_STAGES
#define BMFR_F_STAGES 2
#endif

namespace {

using namespace torch_ops;

constexpr float GAMMA = 0.454545f;  // np.float32(0.454545)

// the K4-only kernel's block
constexpr int K4X = 32, K4Y = 8;

// kernel F's output tile, one pixel a thread, a warp a row of 32
constexpr int TX = BMFR_F_TX, TY = BMFR_F_TY, STAGES = BMFR_F_STAGES;
constexpr int THREADS = TX * TY;
// the K4 box: columns x0 - 4 .. x0 + TX + 3, rows y0 - 1 .. y0 + TY; a
// pixel's column in it (and in the YCoCg buffer) is x - x0 + 4, its row
// y - y0 + 1
constexpr int BW = TX + 8, BH = TY + 2;
constexpr int K4_PLANES = 10, K5_PLANES = 6;
constexpr int K4_BOX = BW * BH, K5_BOX = TX * TY;  // floats
// a stage: six TMA boxes, each on 128 B in shared memory as TMA wants,
// of the planes' runs filtered 0:3, blend 4, blend 6:9, albedo 0:3 (K4,
// BW x BH each) and blend 9:13, prev_pixels 0:2 (K5, TX x TY each);
// offsets in floats
constexpr int on128(int floats) { return (floats + 31) / 32 * 32; }
constexpr int FILT_OFF = 0, TW_OFF = on128(3 * K4_BOX);
constexpr int HIST_OFF = TW_OFF + on128(K4_BOX);
constexpr int ALB_OFF = HIST_OFF + on128(3 * K4_BOX);
constexpr int K5_OFF = ALB_OFF + on128(3 * K4_BOX);
constexpr int STAGE = K5_OFF + K5_PLANES * K5_BOX;
// the stage offset of K4 plane p (filtered 0:3, blend 4, blend 6:9,
// albedo 0:3)
__host__ __device__ constexpr int k4_off(int p) {
  return p < 3 ? FILT_OFF + p * K4_BOX
         : p == 3 ? TW_OFF
         : p < 7 ? HIST_OFF + (p - 4) * K4_BOX
                 : ALB_OFF + (p - 7) * K4_BOX;
}
constexpr uint32_t STAGE_TX_BYTES = 4 * (K4_PLANES * K4_BOX +
                                         K5_PLANES * K5_BOX);
// halo cells outside the tile: the rows above and below, the columns
// left and right
constexpr int BORDER = 2 * (TX + 2) + 2 * TY;
static_assert(TX % 32 == 0, "whole warps of a row");
// the thread that issues the TMA copies: lane 0 of the last warp, which
// runs no halo cell
constexpr int ISSUER = THREADS - 32;
static_assert(BORDER <= ISSUER, "one halo cell a thread, none in the last warp");
static_assert(K5_BOX % 32 == 0, "K5 boxes on 128 B");
static_assert(STAGES >= 2, "a tile's loads in flight while one computes");

struct Params {
  const float* filtered;     // [3, H, W]
  const float* planes;       // [13, H, W] blend planes
  const float* albedo;       // [3, H, W]
  const uint8_t* spp;        // [H, W], K1's new spp
  const float* prev_pixels;  // [2, H, W]
  float* out;
  float* tone;
  float* result;             // without TAA the tone, or a TemporalState
                             // carry's result, which gets the tone too
  int32_t* pack;             // the state's [8, H, W] words, or null
  int H, W;
  float second_alpha, taa_alpha, taa_keep;
  int accum_prev;            // history and not skip_second_accum
};

// the TMA-fed variant's tensor maps, passed by value (a CUDA graph keeps
// them with the launch): [C, H, W] f32, a box of each run of planes
struct Maps {
  CUtensorMap filtered, blend_tw, blend_hist, albedo, blend_k5, prev_pixels;
};

struct TmaLoads {};     // one thread fills the ring by TMA, a tile ahead
struct ThreadLoads {};  // every thread fills one stage before its tile

// K4's blend weights at a pixel with history and spp samples: alpha =
// max(1 / spp, second_alpha) (1 / x is torch's reciprocal) and 1 - alpha
__device__ __forceinline__ void k4_weights(float spp, float second_alpha,
                                           float& alpha, float& keep) {
  alpha = clamp_min(quot(1.0f, spp), second_alpha);
  keep = sub(1.0f, alpha);
}

// K4 at one pixel from its inputs and its weights with history: out and
// tone (ops/accumulate.py::accumulate_filtered_data)
__device__ __forceinline__ void k4(const float f[3], float tw,
                                   const float blend[3], const float alb[3],
                                   float alpha_h, float keep_h,
                                   bool accum_prev, float o[3], float t[3]) {
  const bool has_prev = accum_prev && tw > 0.0f;
  const float safe_tw = tw > 0.0f ? tw : 1.0f;
  // without history alpha is 1 and keep 1 - 1 = +0
  const float alpha = has_prev ? alpha_h : 1.0f;
  const float keep = has_prev ? keep_h : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float prev = has_prev ? quot(blend[c], safe_tw) : 0.0f;
    o[c] = add(mul(alpha, f[c]), mul(keep, prev));
    t[c] = clamp(powf(clamp_min(mul(alb[c], o[c]), 0.0f), GAMMA), 0.0f,
                 1.0f);
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

// ---- the K4-only kernel (no TAA: frame 0, skip_taa) ----

__global__ void __launch_bounds__(K4X * K4Y)
filtered_tail_k4_kernel(Params a) {
  const int x = blockIdx.x * K4X + threadIdx.x;
  const int y = blockIdx.y * K4Y + threadIdx.y;
  if (x >= a.W || y >= a.H) return;
  const int64_t n = (int64_t)a.H * a.W, p = (int64_t)y * a.W + x;
  const float tw = a.planes[4 * n + p];
  // the history planes and spp are read only where K4 blends them
  const bool has_prev = a.accum_prev && tw > 0.0f;
  float f[3], blend[3] = {0.0f, 0.0f, 0.0f}, alb[3], o[3], t[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    f[c] = a.filtered[c * n + p];
    alb[c] = a.albedo[c * n + p];
    if (has_prev) blend[c] = a.planes[(6 + c) * n + p];
  }
  float alpha = 1.0f, keep = 0.0f;
  if (has_prev) k4_weights((float)a.spp[p], a.second_alpha, alpha, keep);
  k4(f, tw, blend, alb, alpha, keep, a.accum_prev, o, t);
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.out[c * n + p] = o[c];
    a.tone[c * n + p] = t[c];
    if (a.result != a.tone) a.result[c * n + p] = t[c];
  }
  if (a.pack != nullptr) {
    a.pack[5 * n + p] = pack_pair(o[0], o[1]);
    a.pack[6 * n + p] = pack_pair(o[2], t[0]);
    a.pack[7 * n + p] = pack_pair(t[1], t[2]);
  }
}

// ---- the ring ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void bar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_box(float* dst, const CUtensorMap* map,
                                        int x, int y, int c, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      :
      : "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(x),
        "r"(y), "r"(c), "r"(smem_addr(bar))
      : "memory");
}

// the issuing thread: the tile at (x0, y0) into stage st, completing
// on bar
__device__ __forceinline__ void issue_tile(const Maps& m, float* st,
                                           uint64_t* bar, int x0, int y0) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :
               : "r"(smem_addr(bar)), "r"(STAGE_TX_BYTES)
               : "memory");
  const int hx = x0 - 4, hy = y0 - 1;
  tma_box(st + FILT_OFF, &m.filtered, hx, hy, 0, bar);
  tma_box(st + TW_OFF, &m.blend_tw, hx, hy, 4, bar);
  tma_box(st + HIST_OFF, &m.blend_hist, hx, hy, 6, bar);
  tma_box(st + ALB_OFF, &m.albedo, hx, hy, 0, bar);
  tma_box(st + K5_OFF, &m.blend_k5, x0, y0, 9, bar);
  tma_box(st + K5_OFF + 4 * K5_BOX, &m.prev_pixels, x0, y0, 0, bar);
}

// plane p of the stage's K4 boxes (filtered 0:3, blend 4, 6:9, albedo)
// and q of its K5 boxes (blend 9:13, prev_pixels), in global memory
__device__ __forceinline__ const float* k4_plane(const Params& a, int p,
                                                 int64_t n) {
  return p < 3 ? a.filtered + p * n
         : p == 3 ? a.planes + 4 * n
         : p < 7 ? a.planes + (p + 2) * n
                 : a.albedo + (p - 7) * n;
}
__device__ __forceinline__ const float* k5_plane(const Params& a, int q,
                                                 int64_t n) {
  return q < 4 ? a.planes + (9 + q) * n : a.prev_pixels + (q - 4) * n;
}

// every thread: the tile at (x0, y0) into stage st with 4 B loads, zero
// outside the image (as TMA fills it)
__device__ __forceinline__ void fill_tile(const Params& a, float* st, int x0,
                                          int y0) {
  const int64_t n = (int64_t)a.H * a.W;
  for (int e = threadIdx.x; e < K4_PLANES * K4_BOX; e += THREADS) {
    const int p = e / K4_BOX, r = e % K4_BOX;
    const int x = x0 - 4 + r % BW, y = y0 - 1 + r / BW;
    const bool in = x >= 0 && x < a.W && y >= 0 && y < a.H;
    st[k4_off(p) + r] = in ? k4_plane(a, p, n)[(int64_t)y * a.W + x] : 0.0f;
  }
  float* k5 = st + K5_OFF;
  for (int e = threadIdx.x; e < K5_PLANES * K5_BOX; e += THREADS) {
    const int q = e / K5_BOX, r = e % K5_BOX;
    const int x = x0 + r % TX, y = y0 + r / TX;
    const bool in = x < a.W && y < a.H;
    k5[e] = in ? k5_plane(a, q, n)[(int64_t)y * a.W + x] : 0.0f;
  }
}

// halo cell b (< BORDER) of a tile: its column and row from (x0, y0)
__device__ __forceinline__ void border_cell(int b, int& cx, int& cy) {
  if (b < 2 * (TX + 2)) {
    cx = b % (TX + 2) - 1;
    cy = b < TX + 2 ? -1 : TY;
  } else {
    b -= 2 * (TX + 2);
    cx = b < TY ? -1 : TX;
    cy = b % TY;
  }
}

// this thread's spp of a tile: its pixel's and its halo cell's; 0 where
// unread (spp matters only where K4 has history)
__device__ __forceinline__ void load_spp(const Params& a, int x0, int y0,
                                         uint32_t& own, uint32_t& halo) {
  own = 0;
  halo = 0;
  if (!a.accum_prev) return;
  const int x = x0 + threadIdx.x % TX, y = y0 + threadIdx.x / TX;
  if (x < a.W && y < a.H) own = __ldg(a.spp + (int64_t)y * a.W + x);
  if (threadIdx.x < BORDER) {
    int cx, cy;
    border_cell(threadIdx.x, cx, cy);
    const int hx = x0 + cx, hy = y0 + cy;
    if (hx >= 0 && hx < a.W && hy >= 0 && hy < a.H)
      halo = __ldg(a.spp + (int64_t)hy * a.W + hx);
  }
}

// max and min that give the card's canonical NaN when an operand is NaN
// (max.NaN, min.NaN: one instruction each). On YCoCg of tones they give
// what nan_max and nan_min give: every NaN there comes out of arithmetic
// (the canonical NaN in f32; bf16's NaN widens to another payload, which
// the sum and product that take the extremes make canonical again), and
// the YCoCg of a tone in [+0, 1] is never -0, so no +0 / -0 tie can go
// either way.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// the extremes of YCoCg over a column's rows y - 1 .. y + 1 in the image
// (EDGE: the tile touches the image's edge; an interior tile tests none)
template <bool EDGE, typename Y>
__device__ __forceinline__ void column_extremes(const Y* col, int y, int H,
                                                float& mx, float& mn,
                                                float& mid) {
  mx = -INFINITY;
  mn = INFINITY;
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
    const float v = from_residual(col[(dy + 1) * BW]);
    if (dy == 0) mid = v;
    if (EDGE && (y + dy < 0 || y + dy >= H)) continue;
    mx = max_nan(mx, v);
    mn = min_nan(mn, v);
  }
}

// the mean of the box (3x3) and cross (5 pixels) minima, and of their
// maxima, of YCoCg channel ycc over the in-image neighbours of pixel
// (x, y), as K5's max pooling takes them with -inf padding. A warp holds
// 32 pixels of a row: each lane takes its column's extremes over the
// three rows, gets its neighbours' by shuffles (the warp's end lanes read
// the column beyond from shared memory), and combines three columns for
// the box, its column and the two side pixels for the cross. The order
// differs from max pooling's scan and gives the same values, as max_nan
// gives nan_max's: a NaN met anywhere makes the extreme NaN, and
// otherwise the set of values, not their order, decides.
template <bool EDGE, typename Y>
__device__ __forceinline__ void neighbourhood(const Y* ycc, int lane, int x,
                                              int y, int H, int W, float& lo,
                                              float& hi) {
  constexpr unsigned ALL = 0xffffffffu;
  float mx, mn, mid;
  column_extremes<EDGE>(ycc, y, H, mx, mn, mid);
  // the column beyond the warp's ends (lane 0: x - 1, lane 31: x + 1)
  float emx = 0.0f, emn = 0.0f, emid = 0.0f;
  if (lane == 0 || lane == 31)
    column_extremes<EDGE>(ycc + (lane == 0 ? -1 : 1), y, H, emx, emn, emid);
  const float up_mx = __shfl_up_sync(ALL, mx, 1);
  const float up_mn = __shfl_up_sync(ALL, mn, 1);
  const float up_mid = __shfl_up_sync(ALL, mid, 1);
  const float dn_mx = __shfl_down_sync(ALL, mx, 1);
  const float dn_mn = __shfl_down_sync(ALL, mn, 1);
  const float dn_mid = __shfl_down_sync(ALL, mid, 1);
  const bool left = !EDGE || x >= 1, right = !EDGE || x + 1 < W;
  const float l_mx = lane == 0 ? emx : up_mx, l_mn = lane == 0 ? emn : up_mn;
  const float l_mid = lane == 0 ? emid : up_mid;
  const float r_mx = lane == 31 ? emx : dn_mx;
  const float r_mn = lane == 31 ? emn : dn_mn;
  const float r_mid = lane == 31 ? emid : dn_mid;
  float box_mx = mx, box_mn = mn, cross_mx = mx, cross_mn = mn;
  if (left) {
    box_mx = max_nan(box_mx, l_mx);
    box_mn = min_nan(box_mn, l_mn);
    cross_mx = max_nan(cross_mx, l_mid);
    cross_mn = min_nan(cross_mn, l_mid);
  }
  if (right) {
    box_mx = max_nan(box_mx, r_mx);
    box_mn = min_nan(box_mn, r_mn);
    cross_mx = max_nan(cross_mx, r_mid);
    cross_mn = min_nan(cross_mn, r_mid);
  }
  lo = mul(add(box_mn, cross_mn), 0.5f);
  hi = mul(add(box_mx, cross_mx), 0.5f);
}

template <class Loads>
__host__ __device__ constexpr int ring_stages() {
  return std::is_same<Loads, TmaLoads>::value ? STAGES : 1;
}

// dynamic shared memory: 128 B of slack to align the ring, the ring,
// two YCoCg buffers and one mbarrier a stage
template <class Loads, typename Y>
__host__ __device__ constexpr int smem_bytes() {
  return 128 + ring_stages<Loads>() * STAGE * 4 +
         2 * 3 * BH * BW * (int)sizeof(Y) + ring_stages<Loads>() * 8;
}

// the CTAs an SM holds by shared memory (f32 residual, the larger; the
// weight tables and 1 KB the card reserves a CTA beside it) and threads:
// the register budget __launch_bounds__ keeps
constexpr int CTAS_BY_SMEM =
    227 * 1024 / (smem_bytes<TmaLoads, float>() + 2048 + 1024);
constexpr int MIN_CTAS =
    CTAS_BY_SMEM < 2048 / THREADS ? CTAS_BY_SMEM : 2048 / THREADS;
static_assert(MIN_CTAS >= 1, "a CTA must fit on an SM");

// persistent CTAs: CTA b runs tiles b, b + gridDim.x, ...; thread
// (tx, ty) owns pixel (x0 + tx, y0 + ty)
template <class Loads, typename Y>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
filtered_tail_kernel(const Params a, const __grid_constant__ Maps m) {
  constexpr bool TMA = std::is_same<Loads, TmaLoads>::value;
  constexpr int NS = ring_stages<Loads>();
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // K4's weights with history by spp (u8), computed once
  __shared__ float s_alpha[256], s_keep[256];
  // the ring on 128 B (an offset from the array, not an integer address,
  // so that every access stays a shared-memory one)
  float* ring = reinterpret_cast<float*>(
      smem_raw + ((128 - (smem_addr(smem_raw) & 127)) & 127));
  Y* ycc_bufs = reinterpret_cast<Y*>(ring + NS * STAGE);
  uint64_t* full = reinterpret_cast<uint64_t*>(ycc_bufs + 2 * 3 * BH * BW);

  const int H = a.H, W = a.W;
  const int64_t n = (int64_t)H * W;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX, lane = tid % 32;
  // the pixel's cell in the K4 box and the YCoCg buffer, and the halo
  // cell's of the first BORDER threads
  const int cell = (ty + 1) * BW + tx + 4;
  int hcx = 0, hcy = 0;
  if (tid < BORDER) border_cell(tid, hcx, hcy);
  const int hcell = (hcy + 1) * BW + hcx + 4;
  const int tiles_x = (W + TX - 1) / TX;
  const int tiles = tiles_x * ((H + TY - 1) / TY);
  const int stride = gridDim.x;
  // the issuer starts the loads of the first NS - 1 tiles at once (each
  // tile's loop issues the one NS - 1 tiles ahead, so that every CTA's
  // first tile lands before the card streams the rest of the ring); the
  // barrier below shows every thread the mbarriers' initialization
  if constexpr (TMA) {
    if (tid == ISSUER) {
      for (int s = 0; s < NS; ++s)
        asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                     :
                     : "r"(smem_addr(&full[s]))
                     : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int s = 0; s < NS - 1; ++s) {
        const int t = blockIdx.x + s * stride;
        if (t < tiles)
          issue_tile(m, ring + s * STAGE, &full[s], (t % tiles_x) * TX,
                     (t / tiles_x) * TY);
      }
    }
  }
  for (int v = tid; v < 256; v += THREADS)
    k4_weights((float)v, a.second_alpha, s_alpha[v], s_keep[v]);
  __syncthreads();
  uint32_t spp_own, spp_halo;
  load_spp(a, (blockIdx.x % tiles_x) * TX, (blockIdx.x / tiles_x) * TY,
           spp_own, spp_halo);

  int i = 0;
  for (int t = blockIdx.x; t < tiles; t += stride, ++i) {
    const int s = i % NS;
    float* stage = ring + s * STAGE;
    const float* k5 = stage + K5_OFF + ty * TX + tx;
    Y* ycc = ycc_bufs + (i & 1) * 3 * BH * BW;
    const int x0 = (t % tiles_x) * TX, y0 = (t / tiles_x) * TY;
    const int x = x0 + tx, y = y0 + ty;

    // ---- 1. wait for the tile's loads ----
    if constexpr (TMA) {
      bar_wait(&full[s], (i / NS) & 1);
      // the tile NS - 1 ahead, into the stage the last tile freed at its
      // barrier
      const int ahead = t + (NS - 1) * stride, sa = (i + NS - 1) % NS;
      if (tid == ISSUER && ahead < tiles)
        issue_tile(m, ring + sa * STAGE, &full[sa], (ahead % tiles_x) * TX,
                   (ahead / tiles_x) * TY);
    } else {
      fill_tile(a, stage, x0, y0);
      __syncthreads();
    }
    // the next tile's spp, a tile ahead
    uint32_t next_own = 0, next_halo = 0;
    if (t + stride < tiles)
      load_spp(a, ((t + stride) % tiles_x) * TX,
               ((t + stride) / tiles_x) * TY, next_own, next_halo);

    // ---- 2. K4 on the tile and its halo ----
    float o[3], tn[3], c[3];
    {
      const float* in = stage + cell;
      const float f[3] = {in[k4_off(0)], in[k4_off(1)], in[k4_off(2)]};
      const float blend[3] = {in[k4_off(4)], in[k4_off(5)], in[k4_off(6)]};
      const float alb[3] = {in[k4_off(7)], in[k4_off(8)], in[k4_off(9)]};
      k4(f, in[k4_off(3)], blend, alb, s_alpha[spp_own], s_keep[spp_own],
         a.accum_prev, o, tn);
      rgb_to_ycocg(tn, c);
#pragma unroll
      for (int k = 0; k < 3; ++k) ycc[k * BH * BW + cell] = to_residual<Y>(c[k]);
    }
    if (tid < BORDER) {
      const float* in = stage + hcell;
      const float f[3] = {in[k4_off(0)], in[k4_off(1)], in[k4_off(2)]};
      const float blend[3] = {in[k4_off(4)], in[k4_off(5)], in[k4_off(6)]};
      const float alb[3] = {in[k4_off(7)], in[k4_off(8)], in[k4_off(9)]};
      float ho[3], ht[3];
      k4(f, in[k4_off(3)], blend, alb, s_alpha[spp_halo],
         s_keep[spp_halo], a.accum_prev, ho, ht);
      rgb_to_ycocg(ht, c);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        ycc[k * BH * BW + hcell] = to_residual<Y>(c[k]);
    }
    // K5's own inputs leave the stage before the barrier that frees it
    float prev[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) prev[k] = k5[k * K5_BOX];
    const float tw = k5[3 * K5_BOX];
    const float px = k5[4 * K5_BOX], py = k5[5 * K5_BOX];
    __syncthreads();

    // ---- 3. K5 on the tile's own pixels ----
    float lo[3], hi[3];
    const bool edge = x0 == 0 || y0 == 0 || x0 + TX >= W || y0 + TY >= H;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const Y* col = ycc + k * BH * BW + cell - BW;  // row y - 1
      if (edge)
        neighbourhood<true>(col, lane, x, y, H, W, lo[k], hi[k]);
      else
        neighbourhood<false>(col, lane, x, y, H, W, lo[k], hi[k]);
    }
    // the previous result, pre-blended by the warp, clamped into the box
    const float safe_tw = tw > 0.0f ? tw : 1.0f;
    float pv[3], prev_ycc[3], clamped[3], prev_rgb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) pv[k] = quot(prev[k], safe_tw);
    rgb_to_ycocg(pv, prev_ycc);
#pragma unroll
    for (int k = 0; k < 3; ++k) clamped[k] = clamp(prev_ycc[k], lo[k], hi[k]);
    ycocg_to_rgb(clamped, prev_rgb);
    // the reprojection fully off screen keeps the tone (XLA's floor to
    // s32: NaN -> 0, saturating, as cvt.rmi)
    const int ix = __float2int_rd(px);
    const int iy = __float2int_rd(py);
    const bool off_screen = ix < -1 || iy < -1 || ix >= W || iy >= H;
    float r[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      r[k] = off_screen ? tn[k]
                        : add(mul(a.taa_alpha, tn[k]),
                              mul(a.taa_keep, prev_rgb[k]));

    // ---- 4. stores ----
    if (x < W && y < H) {
      const int64_t p = (int64_t)y * W + x;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a.out[k * n + p] = o[k];
        a.tone[k * n + p] = tn[k];
        a.result[k * n + p] = r[k];
      }
      if (a.pack != nullptr) {
        a.pack[5 * n + p] = pack_pair(o[0], o[1]);
        a.pack[6 * n + p] = pack_pair(o[2], r[0]);
        a.pack[7 * n + p] = pack_pair(r[1], r[2]);
      }
    }
    spp_own = next_own;
    spp_halo = next_halo;
  }
}

// ---- the host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, found through the CUDA runtime, so
// the library links without -lcuda
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// error codes of a map that could not be encoded (negative, so they
// never read as a cudaError_t): ops/_lib.py::launch names them
constexpr int NO_ENCODER = -1, ENCODE_FAILED = -1000;

// a [C, H, W] f32 tensor's map with boxes of bw x bh x depth
int encode(CUtensorMap* map, const float* base, int C, int H, int W, int bw,
           int bh, int depth) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return NO_ENCODER;
  const cuuint64_t dims[3] = {(cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)C};
  const cuuint64_t strides[2] = {(cuuint64_t)W * 4, (cuuint64_t)H * W * 4};
  const cuuint32_t box[3] = {(cuuint32_t)bw, (cuuint32_t)bh,
                             (cuuint32_t)depth};
  const cuuint32_t step[3] = {1, 1, 1};
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                        const_cast<float*>(base), dims, strides, box, step,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ENCODE_FAILED - (int)r;
}

// the maps of a call, cached by its input addresses and size (the
// eager step would encode five a frame; streams drive one card from
// several host threads, hence the lock)
int tensor_maps(const Params& a, Maps* out) {
  struct Key {
    const void* p[4];
    int H, W;
    bool operator==(const Key& o) const {
      return p[0] == o.p[0] && p[1] == o.p[1] && p[2] == o.p[2] &&
             p[3] == o.p[3] && H == o.H && W == o.W;
    }
  };
  constexpr int SIZE = 32;
  static std::mutex mu;
  static Key keys[SIZE];
  static Maps maps[SIZE];
  static int used = 0, next = 0;
  const Key key{{a.filtered, a.planes, a.albedo, a.prev_pixels}, a.H, a.W};
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < used; ++k)
    if (keys[k] == key) {
      *out = maps[k];
      return 0;
    }
  // the encoder, a libcuda call, needs the CUDA context current on this
  // thread, which its first CUDA call may not have made yet
  int dev;
  cudaError_t ce = cudaGetDevice(&dev);
  if (ce == cudaSuccess) ce = cudaSetDevice(dev);
  if (ce != cudaSuccess) return (int)ce;
  Maps m;
  int e;
  if ((e = encode(&m.filtered, a.filtered, 3, a.H, a.W, BW, BH, 3)) ||
      (e = encode(&m.blend_tw, a.planes, 13, a.H, a.W, BW, BH, 1)) ||
      (e = encode(&m.blend_hist, a.planes, 13, a.H, a.W, BW, BH, 3)) ||
      (e = encode(&m.albedo, a.albedo, 3, a.H, a.W, BW, BH, 3)) ||
      (e = encode(&m.blend_k5, a.planes, 13, a.H, a.W, TX, TY, 4)) ||
      (e = encode(&m.prev_pixels, a.prev_pixels, 2, a.H, a.W, TX, TY, 2)))
    return e;
  keys[next] = key;
  maps[next] = m;
  next = (next + 1) % SIZE;
  used = used < SIZE ? used + 1 : SIZE;
  *out = m;
  return 0;
}

// SMs x resident CTAs of a ring kernel on the current card (its shared
// memory limit set on first use), cached per kernel and card
int persistent_ctas(const void* kernel, int smem, int* ctas) {
  struct Seen {
    const void* kernel;
    int device, ctas;
  };
  static std::mutex mu;
  static Seen seen[64];
  static int used = 0;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  std::lock_guard<std::mutex> lock(mu);
  for (int k = 0; k < used; ++k)
    if (seen[k].kernel == kernel && seen[k].device == dev) {
      *ctas = seen[k].ctas;
      return 0;
    }
  int sms = 0, per_sm = 0;
  if ((e = cudaFuncSetAttribute(kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                smem)) != cudaSuccess ||
      (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                  dev)) != cudaSuccess ||
      (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, THREADS, smem)) != cudaSuccess)
    return (int)e;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  if (used < 64) seen[used++] = Seen{kernel, dev, sms * per_sm};
  *ctas = sms * per_sm;
  return 0;
}

template <class Loads, typename Y>
int launch_ring(const Params& a, const Maps& m, cudaStream_t stream) {
  const auto kernel = filtered_tail_kernel<Loads, Y>;
  constexpr int smem = smem_bytes<Loads, Y>();
  int ctas;
  const int e = persistent_ctas(reinterpret_cast<const void*>(kernel), smem,
                                &ctas);
  if (e != 0) return e;
  const int tiles = ((a.W + TX - 1) / TX) * ((a.H + TY - 1) / TY);
  kernel<<<tiles < ctas ? tiles : ctas, THREADS, smem, stream>>>(a, m);
  return (int)cudaGetLastError();
}

}  // namespace

// variant: 0 K4 only (no TAA), 1 K4 + K5 fed by the threads' own loads,
// 2 K4 + K5 fed by TMA (ops/tail.py::filtered_tail_loader picks 1 or 2)
extern "C" int bmfr_filtered_tail(const float* filtered, const float* planes,
                                  const float* albedo, const uint8_t* spp,
                                  const float* prev_pixels, float* out,
                                  float* tone, float* result, int32_t* pack,
                                  int H, int W, float second_alpha,
                                  float taa_alpha, float taa_keep,
                                  int residual_bf16, int accum_prev,
                                  int variant, cudaStream_t stream) {
  const Params a{filtered, planes,   albedo,       spp,
                 prev_pixels, out,    tone,         result,
                 pack,     H,         W,            second_alpha,
                 taa_alpha, taa_keep, accum_prev};
  if (variant == 0) {
    const dim3 blocks((W + K4X - 1) / K4X, (H + K4Y - 1) / K4Y);
    filtered_tail_k4_kernel<<<blocks, dim3(K4X, K4Y), 0, stream>>>(a);
    return (int)cudaGetLastError();
  }
  Maps m{};
  if (variant == 2) {
    const int e = tensor_maps(a, &m);
    if (e != 0) return e;
    return residual_bf16 ? launch_ring<TmaLoads, __nv_bfloat16>(a, m, stream)
                         : launch_ring<TmaLoads, float>(a, m, stream);
  }
  return residual_bf16 ? launch_ring<ThreadLoads, __nv_bfloat16>(a, m, stream)
                       : launch_ring<ThreadLoads, float>(a, m, stream);
}

// A TMA launch's tensor maps again, for a captured launch whose Params
// the compiled step pointed at other tensors (csrc/graph_bind.cu): each
// map whose tensor's address differs between old_params and new_params
// is encoded for the new address, the others kept. 0, an encoder's code,
// or cudaErrorInvalidValue where the sizes are not Params' and Maps'.
extern "C" int bmfr_filtered_tail_remap(const void* old_params,
                                        const void* new_params,
                                        size_t params_size, void* maps,
                                        size_t maps_size) {
  if (params_size != sizeof(Params) || maps_size != sizeof(Maps))
    return (int)cudaErrorInvalidValue;
  Params o, a;
  Maps m;
  std::memcpy(&o, old_params, sizeof o);
  std::memcpy(&a, new_params, sizeof a);
  std::memcpy(&m, maps, sizeof m);
  int e = 0;
  if (a.filtered != o.filtered)
    e = encode(&m.filtered, a.filtered, 3, a.H, a.W, BW, BH, 3);
  if (!e && a.planes != o.planes &&
      !(e = encode(&m.blend_tw, a.planes, 13, a.H, a.W, BW, BH, 1)) &&
      !(e = encode(&m.blend_hist, a.planes, 13, a.H, a.W, BW, BH, 3)))
    e = encode(&m.blend_k5, a.planes, 13, a.H, a.W, TX, TY, 4);
  if (!e && a.albedo != o.albedo)
    e = encode(&m.albedo, a.albedo, 3, a.H, a.W, BW, BH, 3);
  if (!e && a.prev_pixels != o.prev_pixels)
    e = encode(&m.prev_pixels, a.prev_pixels, 2, a.H, a.W, TX, TY, 2);
  if (e != 0) return e;
  std::memcpy(maps, &m, sizeof m);
  return 0;
}
