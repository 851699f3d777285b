// The fused Cholesky fit + reconstruction (kernel B) on any feature
// basis, for Hopper (sm_90a).
//
// Replaces the TPU kernel _chol_kernel (bmfr_tpu/ops/fitter_direct.py,
// entry fit_reconstruct_cholesky) for a basis other than the default one:
// _chol_kernel evaluates whatever basis the config names
// (fitter_direct.py:180-181). The default basis keeps its own front and
// sums in registers (fitter_chol.cu).
//
// The kernel reads the raw normals, positions and accumulated colour and
// computes each feature from its plane (basis_front.cuh: the built-in ones
// from the raw planes, any other from the extra planes the wrapper
// evaluates), through the mirrored, jittered addressing of the default
// front. NB = F + 3 columns, 4 .. 16, a template parameter; the basis
// (each feature's plane and op) is a launch argument. One CTA of 256
// threads per 32x32 block of the jittered margins grid; thread t owns view
// cells t + 256 k (k < 4). Per block:
//   1. each view cell's features and colours through the K1 store
//      contract (NaN -> 0, f16 clamp, storage rounding) into shared memory
//      (NB rows of 1024 floats), and the block min/max of every stored
//      feature (a transpose reduction of 2 F maxima per warp, every warp
//      its own copy of the scale);
//   2. in place, the rescale with its storage rounding of the features
//      from lo on, and the hash noise on features 1..;
//   3. the Gram + rhs sums of rows < F in plain f32 (no TF32, no tensor
//      cores: the normal equations cancel catastrophically under rounded
//      operands), register-tiled: the sums fall into 4x4 tiles (rows 4i..,
//      columns 4j.., j >= i; indices past the last row or column are
//      clamped and their sums dropped), and warp w sums every tile over
//      its eighth of the block, lane l over pixels 2l, 2l + 1 of each run
//      of 64 (4 pixels, float2 loads: 8 shared loads feed 32 FMAs), then
//      one transpose reduction over the warp; the eighths are added in
//      warp order in the solve;
//   4. on warp 0 the factorization of [G; b^T] and the solves, in
//      _chol_kernel's order, as fitter_chol.cu (lane r holds row r, NB <=
//      16 lanes); the back solve takes one lane per (colour, row), as many
//      colours at a time as 32 lanes hold (3 up to F = 10, then 2);
//      NaN -> 0;
//   5. the reconstruction straight into the image: each in-image pixel's
//      features computed again from their planes (from L2), the
//      pre-rounding values rescaled from lo on, as fitter_direct.py:199-209
//      builds the basis.
//
// What bounds it on this card: the bytes are the accumulated colour, the
// raw planes the features read (all six from first order on) and the K
// extra planes in (none on a basis of built-in features), the image out;
// the instructions per view cell are the noise hashes (F - 1 of them), the
// features and their store, and the Gram sums (16 FMAs per tile and pixel,
// 4 shared-memory bytes per FMA). The staging, the rescale and the
// reconstruction wait on loads and divisions: 256 threads a CTA, at most
// 85 registers so that 3 CTAs (24 warps) share an SM at 16 columns (the
// staged rows, NB x 4 KB, allow 3), took 0.71x the time of 128 threads at
// 3 CTAs (PERF.md, Findings).

#include "basis_front.cuh"

namespace {

using namespace bmfr;

constexpr int T = 256, NW = T / 32, PP = BP / T;
constexpr int TE = 4;         // a Gram tile's edge
constexpr int QP = BP / NW;   // pixels a warp sums in phase 3
constexpr int RUN = 64;       // pixels a warp takes per step (2 a lane)

template <int NB>
struct Layout {
  static constexpr int F = NB - 3;
  static constexpr int RT = (F + TE - 1) / TE;   // row tiles: rows < F
  static constexpr int CT = (NB + TE - 1) / TE;  // column tiles
  static constexpr int NT = RT * CT - RT * (RT - 1) / 2;  // tiles, j >= i
  // dynamic shared memory, in floats: the staged rows; the warps' maxima
  // (phase 1), which the warps' tile sums reuse (phases 3-4); each warp's
  // scale; L and y; the weights
  static constexpr int RED_N = NW * NT * TE * TE;
  static constexpr int VAL = 0, RED = NB * BP,
                       SCALE = RED + (RED_N > NW * 32 ? RED_N : NW * 32),
                       SL = SCALE + NW * 2 * F, SW = SL + NB * F,
                       TOTAL = SW + 3 * F;
};

// the tile of rows 4i.., columns 4j.. (j >= i) in the tiles' order
template <int NB>
__host__ __device__ constexpr int tile_index(int i, int j) {
  return i * Layout<NB>::CT - i * (i - 1) / 2 + (j - i);
}

// mirror() with the in-range case first (a row of view cells is uniform
// over a warp, so the branch does not diverge)
__device__ __forceinline__ int mirror_row(int i, int size) {
  return (unsigned)i < (unsigned)size ? i : mirror(i, size);
}

template <int M, int NB>
__global__ void __launch_bounds__(T, 3)
fit_chol_basis_kernel(const float* __restrict__ accum,  // [3, H, W]
                      const Basis basis,  // each feature's plane and op
                      float* __restrict__ out, float* __restrict__ weights,
                      int H, int W, int lo, const int* __restrict__ frame_ptr,
                      float amp) {
  using L = Layout<NB>;
  constexpr int F = L::F;
  extern __shared__ __align__(16) float smem[];  // float2 loads in phase 3
  float* val = smem + L::VAL;
  float* red = smem + L::RED;
  float* sL = smem + L::SL;
  float* sw = smem + L::SW;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t n = (int64_t)H * W;
  const int frame = __ldg(frame_ptr);
  const int2 jit = jitter_offset(frame, BE);
  const Noise nz = frame_noise(frame, amp, BP, NB);
  // view cell tid + T k is image pixel (iy0 + NW k, ix) before the mirror
  const int iy0 = (int)blockIdx.y * BE - BE / 2 + jit.y + warp;
  const int ix = (int)blockIdx.x * BE - BE / 2 + jit.x + lane;
  const int sx = mirror(ix, W);

  // ---- 1. stage the stored values and the block min/max ----
  float mm[32];  // mm[c] = max(-v) = -min, mm[F + c] = max of feature c
#pragma unroll
  for (int j = 0; j < 32; ++j) mm[j] = -INFINITY;
#pragma unroll 2
  for (int k = 0; k < PP; ++k) {
    const int e = tid + T * k;
    const int64_t off = (int64_t)mirror_row(iy0 + NW * k, H) * W + sx;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float s = store<M>(feature_value(basis, c, off));
      val[c * BP + e] = s;
      mm[c] = fmaxf(mm[c], -s);
      mm[F + c] = fmaxf(mm[F + c], s);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c)
      val[(F + c) * BP + e] = store<M>(accum[c * n + off]);
  }
  // lane l ends with the warp's maximum of value l
  transpose_halves<MaxOp, 32, 5>(mm, lane);
  red[warp * 32 + lane] = mm[0];
  __syncthreads();
  // every warp combines the warps' maxima into its own copy of the
  // block's scale: smin, then sden
  float* scale = smem + L::SCALE + warp * 2 * F;
  {
    float t = red[lane];
    for (int w = 1; w < NW; ++w) t = fmaxf(t, red[w * 32 + lane]);
    const float hi = __shfl_down_sync(FULL, t, F);
    if (lane < F) {
      scale[lane] = -t;
      scale[F + lane] = scale_den(-t, hi);
    }
    __syncwarp();
  }
  const float* smin = scale;
  const float* sden = scale + F;

  // ---- 2. each view cell's row of the fit, in place ----
#pragma unroll 1
  for (int k = 0; k < PP; ++k) {
    const int e = tid + T * k;
#pragma unroll
    for (int c = 1; c < F; ++c) {
      float v = val[c * BP + e];
      if (c >= lo) v = quantize<M>((v - smin[c]) / sden[c]);
      val[c * BP + e] = v + noise_at(nz, c, e);
    }
  }
  __syncthreads();

  // ---- 3. the Gram + rhs sums, tile by tile over the warp's eighth ----
#pragma unroll 1
  for (int t = 0; t < L::NT; ++t) {
    int i = 0, r = t;
    while (r >= L::CT - i) {
      r -= L::CT - i;
      ++i;
    }
    const float* rows[TE];
    const float* cols[TE];
#pragma unroll
    for (int a = 0; a < TE; ++a) {
      const int base = warp * QP + 2 * lane;
      rows[a] = val + min(TE * i + a, NB - 1) * BP + base;
      cols[a] = val + min(TE * (i + r) + a, NB - 1) * BP + base;
    }
    float acc[TE * TE];
#pragma unroll
    for (int q = 0; q < TE * TE; ++q) acc[q] = 0.0f;
#pragma unroll
    for (int s = 0; s < QP; s += RUN) {
      float2 x[TE], y[TE];
#pragma unroll
      for (int a = 0; a < TE; ++a) {
        x[a] = *reinterpret_cast<const float2*>(rows[a] + s);
        y[a] = *reinterpret_cast<const float2*>(cols[a] + s);
      }
#pragma unroll
      for (int a = 0; a < TE; ++a) {
#pragma unroll
        for (int b = 0; b < TE; ++b) {
          acc[a * TE + b] += x[a].x * y[b].x;
          acc[a * TE + b] += x[a].y * y[b].y;
        }
      }
    }
    // lanes 2q and 2q + 1 end with the warp's total of sum q
    transpose_halves<SumOp, TE * TE, 4>(acc, lane);
    acc[0] += __shfl_xor_sync(FULL, acc[0], 1);
    if ((lane & 1) == 0)
      red[(warp * L::NT + t) * TE * TE + (lane >> 1)] = acc[0];
  }
  __syncthreads();

  // ---- 4. the solve on warp 0 ----
  if (warp == 0) {
    // lane r < NB: row r of [G; b^T], columns 0..F-1 (entries above the
    // diagonal of G are read and never used)
    const int r = min(lane, NB - 1);
    float a[F];
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const int f1 = min(r, c), f2 = max(r, c);
      const int idx = tile_index<NB>(f1 / TE, f2 / TE) * TE * TE +
                      (f1 % TE) * TE + f2 % TE;
      float s = red[idx];
      for (int w = 1; w < NW; ++w) s += red[w * L::NT * TE * TE + idx];
      a[c] = s;
    }
    // right-looking, each entry's subtractions in the order k = 0, 1, ..
    // (fitter_chol.cu)
#pragma unroll
    for (int j = 0; j < F; ++j) {
      const float ljj = sqrtf(__shfl_sync(FULL, a[j], j));
      a[j] = lane == j ? ljj : a[j] / ljj;
#pragma unroll
      for (int c = j + 1; c < F; ++c)
        a[c] = a[c] - a[j] * __shfl_sync(FULL, a[j], c);
    }
    if (lane < NB) {
#pragma unroll
      for (int c = 0; c < F; ++c) sL[lane * F + c] = a[c];
    }
    __syncwarp();
    // back solve L^T x = y: lane q * F + i computes x_i of colour
    // CPP p + q in pass p, in the order k = i + 1, .., F - 1
    constexpr int CPP = 32 / F < 3 ? 32 / F : 3;
    const int q = min(lane / F, CPP - 1), i = lane % F;
    float col[F];
#pragma unroll
    for (int k = 0; k < F; ++k) col[k] = sL[k * F + i];
#pragma unroll
    for (int p = 0; p * CPP < 3; ++p) {
      const int ch = min(p * CPP + q, 2);
      const bool live = lane < CPP * F && p * CPP + q < 3;
      const float y = sL[(F + ch) * F + i];
      float x[F];
      float xi = 0.0f;
#pragma unroll
      for (int s = F - 1; s >= 0; --s) {
        float v = y;
#pragma unroll
        for (int k = s + 1; k < F; ++k) v = v - col[k] * x[k];
        const float xs = v / col[s];
        if (i == s) xi = xs;
        x[s] = __shfl_sync(FULL, xs, q * F + s);
      }
      if (live) {
        const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
        const float wf = isnan(xi) ? 0.0f : xi;
        sw[ch * F + i] = wf;
        weights[(b * F + i) * 3 + ch] = wf;  // [n_blocks, F, 3]
      }
    }
  }
  __syncthreads();

  // ---- 5. reconstruction straight into the image ----
  const bool col_in = ix >= 0 && ix < W;
#pragma unroll 2
  for (int k = 0; k < PP; ++k) {
    const int iy = iy0 + NW * k;
    if (!col_in || iy < 0 || iy >= H) continue;
    const int64_t off = (int64_t)iy * W + ix;
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float v = feature_value(basis, f, off);
      if (f >= lo) v = (v - smin[f]) / sden[f];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[ch] = acc[ch] + v * sw[ch * F + f];
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch)
      out[ch * n + off] = isnan(acc[ch]) ? acc[ch] : fmaxf(acc[ch], 0.0f);
  }
}

template <int M, int NB>
int launch(const float* accum, const Basis& basis, float* out,
           float* weights, int H, int W, int blocks_x, int blocks_y, int lo,
           const int* frame, float amp, cudaStream_t stream) {
  auto kernel = fit_chol_basis_kernel<M, NB>;
  const int bytes = Layout<NB>::TOTAL * (int)sizeof(float);
  static int granted = 48 * 1024;
  const int err = allow_smem(kernel, bytes, &granted);
  if (err != 0) return err;
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  kernel<<<grid, T, bytes, stream>>>(accum, basis, out, weights, H, W, lo,
                                     frame, amp);
  return (int)cudaGetLastError();
}

}  // namespace

// accum: [3, H, W]; planes: a host array of F device addresses, feature
// i's plane ([H, W] f32: a raw normal or position plane, the colour plane
// for the constant, or an extra plane the wrapper evaluated); ops_lo,
// ops_hi: feature i's op (basis_front.cuh) in byte i % 8 of word i / 8;
// out: [3, H, W]; weights: [n_blocks, F, 3]; F: features (4 <= F + 3 <=
// 16); lo: features not scaled (>= 1); frame: the frame number, an int on
// the device (fitter_front.cuh); mode: the tmp dtype, 0 f32, 1 f16, 2
// bf16; noise_amp: the hash noise's amplitude
extern "C" int bmfr_fit_reconstruct_cholesky_basis(
    const float* accum, const unsigned long long* planes,
    unsigned long long ops_lo, unsigned long long ops_hi, float* out,
    float* weights, int H, int W, int blocks_x, int blocks_y, int F, int lo,
    const int* frame, int mode, float noise_amp, cudaStream_t stream) {
  if (lo < 1 || lo > F) return (int)cudaErrorInvalidValue;
  const Basis basis = make_basis(planes, F, ops_lo, ops_hi);
  return with_storage(mode, [&](auto, auto m) {
    constexpr int Mv = decltype(m)::value;
    return with_columns(F + 3, [&](auto nb) {
      return launch<Mv, decltype(nb)::value>(accum, basis, out, weights, H,
                                             W, blocks_x, blocks_y, lo, frame,
                                             noise_amp, stream);
    });
  });
}
