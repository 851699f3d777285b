// The Householder direct fitter (kernel C) for Hopper (sm_90a).
//
// Replaces the TPU kernel _qr_kernel (bmfr_tpu/ops/fitter_direct.py,
// entries fit_blocks_direct and fit_reconstruct_direct): kernel B's front
// half (fitter_front.cuh: mirror loads of the raw planes, features, K1
// store contract, scale, hash noise), the Householder reflections and back
// substitution of kernel D (householder.cuh), then either the
// reconstruction straight into the image or the weights and mins/maxs.
//
// One CTA of 256 threads fits one 32x32 block of the jittered margins grid
// (984 at 1280x720). Thread t owns view cells 4t .. 4t + 3 (four
// neighbours in one row of the block): it loads their 9 raw values with
// the mirror addressing straight into registers, builds their 13 values of
// the fit there, and holds them through the reflections (52 floats); the
// block min/max, the fused reduction of each reflection and the hand-out
// of the pivot row are the only shared traffic (householder.cuh; the
// reflections unrolled by column, qr_unrolled). For the
// reconstruction it reads its in-image pixels' normals and positions again
// (from L2): keeping them in registers instead spilled 24-108 B a thread
// and was 1.6 % slower on the H100 (PERF.md, Findings).
//
// What bounds it on this card: the 10 barrier-separated reductions of each
// 256-thread block, as for kernel D. The bytes are 33 MB of raw planes in
// and 11 MB of image out per 1280x720 frame (13 us at 3.35 TB/s), the
// arithmetic ~0.4 GFLOP (6 us at the f32 peak).

#include "householder.cuh"

namespace {

using namespace bmfr;

template <int M>
__global__ void __launch_bounds__(THREADS, 2)
fit_direct_kernel(const float* __restrict__ normals,
                  const float* __restrict__ positions,
                  const float* __restrict__ accum,
                  float* __restrict__ out,        // [3, H, W] or null
                  float* __restrict__ weights,    // [n_blocks, NF, 3]
                  float* __restrict__ mins_maxs,  // [n_blocks, NSC, 2] or null
                  int H, int W, const int* __restrict__ frame_ptr,
                  float amp) {
  constexpr int RS = 2 * NBUF;
  __shared__ float red[2 * WARPS * RS];
  __shared__ float rows[2 * NBUF];
  __shared__ float rs[NBUF * 16];
  __shared__ float sw[3 * NF];
  // ---- 1. loads and features ----
  const Group g = make_group(THREADS);
  const int tid = threadIdx.x;
  const int64_t b = (int64_t)blockIdx.y * gridDim.x + blockIdx.x;
  const int64_t n = (int64_t)H * W;
  const int e0 = 4 * tid;
  const int frame = __ldg(frame_ptr);
  const int2 jit = jitter_offset(frame, BE);
  const Noise nz = frame_noise(frame, amp, BP, NBUF);
  const int gy = (int)blockIdx.y * BE + (e0 >> 5) - BE / 2 + jit.y;
  const int gx0 = (int)blockIdx.x * BE + (e0 & 31) - BE / 2 + jit.x;
  const int64_t row = (int64_t)mirror(gy, H) * W;

  // the stored rows of the fit straight from the loads
  float x[NBUF][4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float px[9], v[NBUF];
    load_pixel(px, normals, positions, accum, n, row + mirror(gx0 + k, W));
    stored_row<M>(px, v);
#pragma unroll
    for (int c = 0; c < NBUF; ++c) x[c][k] = v[c];
  }

  // ---- 2. block min/max and rescale ----
  // block min/max of the stored scaled features: mm[j] = -min, mm[NSC+j] = max
  float mm[2 * NSC];
#pragma unroll
  for (int j = 0; j < 2 * NSC; ++j) mm[j] = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      mm[j] = fmaxf(mm[j], -x[LO + j][k]);
      mm[NSC + j] = fmaxf(mm[NSC + j], x[LO + j][k]);
    }
  }
  group_reduce<MaxOp, 2 * NSC>(mm, g, red + WARPS * RS);
  float smin[NSC], sden[NSC];
#pragma unroll
  for (int j = 0; j < NSC; ++j) {
    smin[j] = -mm[j];
    sden[j] = scale_den(smin[j], mm[NSC + j]);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    float v[NBUF];
#pragma unroll
    for (int c = 0; c < NBUF; ++c) v[c] = x[c][k];
    finish_row<M>(v, e0 + k, smin, sden, nz);
#pragma unroll
    for (int c = 0; c < NBUF; ++c) x[c][k] = v[c];
  }

  // ---- 3. reflections ----
  qr_unrolled<M, NBUF>(x, g, red, rows, rs, WARPS, 1);
  __syncthreads();
  // ---- 4. back substitution ----
  if (tid < 3) {
    float w[NF];
    back_substitute<NF>(tid, [&](int c, int r) { return rs[c * 16 + r]; }, w);
#pragma unroll
    for (int f = 0; f < NF; ++f) {
      sw[tid * NF + f] = w[f];
      weights[(b * NF + f) * 3 + tid] = w[f];  // [n_blocks, F, 3]
    }
  }
  if (mins_maxs != nullptr) {
#pragma unroll
    for (int j = 0; j < NSC; ++j) {
      if (tid == j) {
        mins_maxs[(b * NSC + j) * 2] = smin[j];
        mins_maxs[(b * NSC + j) * 2 + 1] = mm[NSC + j];
      }
    }
  }
  if (out == nullptr) return;
  __syncthreads();
  // ---- 5. reconstruction ----
  if (gy < 0 || gy >= H) return;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int ix = gx0 + k;
    if (ix < 0 || ix >= W) continue;
    const int64_t off = (int64_t)gy * W + ix;
    // an in-image view cell reads its own pixel
    float q[6];
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      q[c] = normals[c * n + off];
      q[3 + c] = positions[c * n + off];
    }
    reconstruct_pixel(q, smin, sden, sw, out, n, off);
  }
}

template <int M>
int launch(const float* normals, const float* positions, const float* accum,
           float* out, float* weights, float* mins_maxs, int H, int W,
           int blocks_x, int blocks_y, const int* frame, float amp,
           cudaStream_t stream) {
  const dim3 grid((unsigned)blocks_x, (unsigned)blocks_y);
  fit_direct_kernel<M><<<grid, THREADS, 0, stream>>>(
      normals, positions, accum, out, weights, mins_maxs, H, W, frame, amp);
  return (int)cudaGetLastError();
}

}  // namespace

// frame: the frame number, an int on the device (fitter_front.cuh); mode:
// tmp dtype 0 f32, 1 f16, 2 bf16; noise_amp: the hash noise's amplitude.
extern "C" int bmfr_fit_direct_householder(
    const float* normals, const float* positions, const float* accum,
    float* out, float* weights, float* mins_maxs, int H, int W, int blocks_x,
    int blocks_y, const int* frame, int mode, float noise_amp,
    cudaStream_t stream) {
  return with_storage(mode, [&](auto, auto m) {
    return launch<decltype(m)::value>(normals, positions, accum, out, weights,
                                      mins_maxs, H, W, blocks_x, blocks_y,
                                      frame, noise_amp, stream);
  });
}
