// The fused Cholesky fit + reconstruction (kernel B) on any feature
// basis, for Hopper (sm_90a).
//
// Replaces the TPU kernel _chol_kernel (bmfr_tpu/ops/fitter_direct.py,
// entry fit_reconstruct_cholesky) for a basis other than the default one:
// _chol_kernel evaluates whatever basis the config names
// (fitter_direct.py:180-181). The default basis keeps its own front and
// sums in registers (fitter_chol.cu).
//
// The wrapper (ops/fitter_direct.py) evaluates the basis with the feature
// registry into F f32 planes [F, H, W]; the kernel stages them with the
// accumulated colour through the same mirrored, jittered addressing as
// the raw planes (a feature is a per-pixel function, so evaluating before
// the mirror equals evaluating after it). NB = F + 3 columns, 4 .. 16, a
// template parameter. One CTA of 128 threads per 32x32 block of the
// jittered margins grid; thread t owns view cells t + 128 k (k < 8). Per
// block:
//   1. stage the NB planes in shared memory (rows of BP + 1 floats, so
//      the Gram loads below hit distinct banks), and take the block
//      min/max of every stored feature (a transpose reduction of 2 F
//      maxima per warp, every warp its own copy of the scale);
//   2. each view cell's row of the fit, in place: the K1 store contract
//      (NaN -> 0, f16 clamp, storage rounding), the rescale with its
//      storage rounding of the features from lo on, the hash noise on
//      features 1..;
//   3. the F (F + 1) / 2 Gram + 3 F rhs sums in plain f32 (no TF32, no
//      tensor cores: the normal equations cancel catastrophically under
//      rounded operands): warp w sums its quarter of the block, lane l
//      the sums l, l + 32, .., each as 8 chunk sums added as a tree; the
//      quarters are added in warp order in the solve. The row registers
//      of the default kernel's sums (96 a thread) would not fit 130 sums;
//   4. on warp 0 the factorization of [G; b^T] and the solves, in
//      _chol_kernel's order, as fitter_chol.cu (lane r holds row r, NB <=
//      16 lanes); the back solve takes one lane per (colour, row), as many
//      colours at a time as 32 lanes hold (3 up to F = 10, then 2);
//      NaN -> 0;
//   5. the reconstruction straight into the image: each in-image pixel's
//      F planes read again (from L2), the pre-rounding values rescaled
//      from lo on, as fitter_direct.py:199-209 builds the basis.
//
// What bounds it on this card: the shared-memory loads of phase 3, two a
// sum and pixel (130 sums x 1024 pixels a block at F = 13), and the
// dynamic shared memory (NB (BP + 1) floats, 66 KB at 16 columns), which
// holds 3 CTAs on an SM; the bytes are (F + 6) * 3.7 MB per 1280x720
// frame.

#include "householder.cuh"

namespace {

using namespace bmfr;

constexpr int T = 128, NW = T / 32, PP = BP / T;
constexpr int BPS = BP + 1;  // a staged plane's row in shared memory
constexpr int QP = BP / NW;  // pixels a warp sums in phase 3

// index of Gram/rhs entry (f1 <= f2, f1 < F) of NB columns
__host__ __device__ constexpr int gram_index(int NB, int f1, int f2) {
  return f1 * NB - f1 * (f1 - 1) / 2 + (f2 - f1);
}

template <int NB>
struct Layout {
  static constexpr int F = NB - 3;
  static constexpr int NG = gram_index(NB, F, F);  // the sums of rows < F
  static constexpr int GJ = (NG + 31) / 32;        // sums a lane takes
  static constexpr int NGW = GJ * 32;
  // dynamic shared memory, in floats: staged planes, the warps' maxima,
  // each warp's scale, the warps' partial sums, L and y, the weights
  static constexpr int RAW = 0, MMW = NB * BPS, SCALE = MMW + NW * 32,
                       RED = SCALE + NW * 2 * F, SL = RED + NW * NGW,
                       SW = SL + NB * F, TOTAL = SW + 3 * F;
};

// mirror() with the in-range case first (a row of view cells is uniform
// over a warp, so the branch does not diverge)
__device__ __forceinline__ int mirror_row(int i, int size) {
  return (unsigned)i < (unsigned)size ? i : mirror(i, size);
}

template <int M, int NB>
__global__ void __launch_bounds__(T, 3)
fit_chol_basis_kernel(const float* __restrict__ feats,  // [F, H, W]
                      const float* __restrict__ accum,  // [3, H, W]
                      float* __restrict__ out, float* __restrict__ weights,
                      int H, int W, int lo, const int* __restrict__ frame_ptr,
                      float amp) {
  using L = Layout<NB>;
  constexpr int F = L::F;
  extern __shared__ float smem[];
  float* raw = smem + L::RAW;
  float* mmw = smem + L::MMW;
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

  // ---- 1. stage the planes and the block min/max ----
  float mm[32];  // mm[c] = max(-v) = -min, mm[F + c] = max of feature c
#pragma unroll
  for (int j = 0; j < 32; ++j) mm[j] = -INFINITY;
#pragma unroll 2
  for (int k = 0; k < PP; ++k) {
    const int e = tid + T * k;
    const int64_t off = (int64_t)mirror_row(iy0 + NW * k, H) * W + sx;
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float v = feats[c * n + off];
      raw[c * BPS + e] = v;
      const float s = store<M>(v);
      mm[c] = fmaxf(mm[c], -s);
      mm[F + c] = fmaxf(mm[F + c], s);
    }
#pragma unroll
    for (int c = 0; c < 3; ++c) raw[(F + c) * BPS + e] = accum[c * n + off];
  }
  // lane l ends with the warp's maximum of value l
  transpose_halves<MaxOp, 32, 5>(mm, lane);
  mmw[warp * 32 + lane] = mm[0];
  __syncthreads();
  // every warp combines the warps' maxima into its own copy of the
  // block's scale: smin, then sden
  float* scale = smem + L::SCALE + warp * 2 * F;
  {
    float t = mmw[lane];
    for (int w = 1; w < NW; ++w) t = fmaxf(t, mmw[w * 32 + lane]);
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
    float v[NB];
#pragma unroll
    for (int c = 0; c < NB; ++c) v[c] = store<M>(raw[c * BPS + e]);
#pragma unroll
    for (int c = 1; c < F; ++c) {
      if (c >= lo) v[c] = quantize<M>((v[c] - smin[c]) / sden[c]);
      v[c] = v[c] + noise_at(nz, c, e);
    }
#pragma unroll
    for (int c = 0; c < NB; ++c) raw[c * BPS + e] = v[c];
  }
  __syncthreads();

  // ---- 3. the Gram + rhs sums: warp w over pixels [w QP, (w + 1) QP),
  // lane l the sums l + 32 j, each as NCH partial sums over the chunks of
  // 32 pixels added as a tree (one running sum over 256 pixels rounded
  // the f16 fits to 7 dB less exact than the plain version's) ----
  {
    constexpr int NCH = QP / 32;
    static_assert(NCH == 8, "the tree below adds 8 chunks");
    const float* p1[L::GJ];
    const float* p2[L::GJ];
    float acc[L::GJ][NCH];
#pragma unroll
    for (int j = 0; j < L::GJ; ++j) {
      int g = min(lane + 32 * j, L::NG - 1), f1 = 0;
      while (g >= NB - f1) {
        g -= NB - f1;
        ++f1;
      }
      p1[j] = raw + f1 * BPS + warp * QP;
      p2[j] = raw + (f1 + g) * BPS + warp * QP;
#pragma unroll
      for (int c = 0; c < NCH; ++c) acc[j][c] = 0.0f;
    }
#pragma unroll 2
    for (int e = 0; e < 32; ++e) {
#pragma unroll
      for (int c = 0; c < NCH; ++c) {
#pragma unroll
        for (int j = 0; j < L::GJ; ++j)
          acc[j][c] += p1[j][c * 32 + e] * p2[j][c * 32 + e];
      }
    }
#pragma unroll
    for (int j = 0; j < L::GJ; ++j) {
      const float(&a)[NCH] = acc[j];
      red[warp * L::NGW + lane + 32 * j] =
          ((a[0] + a[1]) + (a[2] + a[3])) + ((a[4] + a[5]) + (a[6] + a[7]));
    }
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
      const int idx = gram_index(NB, min(r, c), max(r, c));
      float s = red[idx];
      for (int w = 1; w < NW; ++w) s += red[w * L::NGW + idx];
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
#pragma unroll 1
  for (int k = 0; k < PP; ++k) {
    const int iy = iy0 + NW * k;
    if (!col_in || iy < 0 || iy >= H) continue;
    const int64_t off = (int64_t)iy * W + ix;
    float acc[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int f = 0; f < F; ++f) {
      float v = feats[f * n + off];
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
int launch(const float* feats, const float* accum, float* out, float* weights,
           int H, int W, int blocks_x, int blocks_y, int lo, const int* frame,
           float amp, cudaStream_t stream) {
  auto kernel = fit_chol_basis_kernel<M, NB>;
  const int bytes = Layout<NB>::TOTAL * (int)sizeof(float);
  static int granted = 48 * 1024;
  const int err = allow_smem(kernel, bytes, &granted);
  if (err != 0) return err;
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  kernel<<<grid, T, bytes, stream>>>(feats, accum, out, weights, H, W, lo,
                                     frame, amp);
  return (int)cudaGetLastError();
}

}  // namespace

// feats: the F feature planes [F, H, W]; accum: [3, H, W]; out: [3, H,
// W]; weights: [n_blocks, F, 3]; F: features (4 <= F + 3 <= 16); lo:
// features not scaled (>= 1); frame: the frame number, an int on the
// device (fitter_front.cuh); mode: the tmp dtype, 0 f32, 1 f16, 2 bf16;
// noise_amp: the hash noise's amplitude
extern "C" int bmfr_fit_reconstruct_cholesky_basis(
    const float* feats, const float* accum, float* out, float* weights, int H,
    int W, int blocks_x, int blocks_y, int F, int lo, const int* frame,
    int mode, float noise_amp, cudaStream_t stream) {
  if (lo < 1 || lo > F) return (int)cudaErrorInvalidValue;
  return with_storage(mode, [&](auto, auto m) {
    constexpr int Mv = decltype(m)::value;
    return with_columns(F + 3, [&](auto nb) {
      return launch<Mv, decltype(nb)::value>(
          feats, accum, out, weights, H, W, blocks_x, blocks_y, lo, frame,
          noise_amp, stream);
    });
  });
}
