// Fused temporal warp + per-stage blend (kernel A) for Hopper (sm_90a).
//
// Replaces the TPU kernel _blend_kernel3 (bmfr_tpu/ops/warp_pallas.py,
// entry warp_blend_pallas). One thread per pixel with a direct global
// gather, the reference's own design (opencl/bmfr.cl:374-419): the thread
// reads the 8 int32 channel-pair words of the previous state at each of
// the 4 clipped bilinear taps (clip(iy+dy), clip(ix+dx)), unpacks them to
// 16 bf16->f32 channels, and runs blend_from_taps
// (bmfr_tpu_torch/ops/warp_blend.py) to write the 13 blend planes.
// floor, the bilinear fractions and the mask bits are computed here from
// pfx/pfy, never transported.
//
// What bounds it on this card: bytes. Per pixel it gathers 32 words
// (128 B, mostly L2 hits: reprojection is coherent, so neighbouring
// threads read neighbouring words), reads 8 f32 (pfx, pfy, 6 current
// planes) and writes 13 f32 planes: with one read of the 8 state words,
// 116 B of compulsory DRAM traffic per pixel, 107 MB per 1280x720 frame
// (32 us at 3.35 TB/s). The design keeps every access
// coalesced along x (one thread per pixel, x fastest), reads each tap word
// once, and keeps the 16 channels of a tap in registers, so no
// intermediate tap plane is ever written.
//
// Arithmetic mirrors the plain PyTorch version operation by operation;
// the products and sums use __fmul_rn/__fadd_rn/__fsub_rn so that nvcc
// does not contract them into FMAs, which keeps the limit compares (and
// hence the accept bits) identical to the plain version's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float bf16_lo(uint32_t u) {
  return __uint_as_float(u << 16);
}

__device__ __forceinline__ float bf16_hi(uint32_t u) {
  return __uint_as_float(u & 0xFFFF0000u);
}

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

__device__ __forceinline__ float sq3(float a, float b, float c) {
  return add(add(mul(a, a), mul(b, b)), mul(c, c));
}

__global__ void warp_blend_kernel(const int32_t* __restrict__ src8,
                                  const float* __restrict__ positions,
                                  const float* __restrict__ normals,
                                  const float* __restrict__ pfx,
                                  const float* __restrict__ pfy,
                                  float* __restrict__ out, int H, int W,
                                  float pos_lim, float nrm_lim) {
  const int64_t n = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  const float px = pfx[p];
  const float py = pfy[p];
  // floor toward -inf with int32 saturation (NaN -> 0), as XLA and
  // torch's CUDA cast do; the fractions use the integer, as in JAX
  const int ix = __float2int_rd(px);
  const int iy = __float2int_rd(py);
  const float fx = sub(px, (float)ix);
  const float fy = sub(py, (float)iy);

  // mask bits (warp_blend.mask_bits), written without ix+1 / iy+1 so no
  // int32 overflow can occur at saturated coordinates
  const bool x0_in = ix >= 0 && ix < W;
  const bool x1_in = ix >= -1 && ix < W - 1;
  const bool y0_in = iy >= 0 && iy < H;
  const bool y1_in = iy >= -1 && iy < H - 1;
  const bool inb[4] = {y0_in && x0_in, y0_in && x1_in, y1_in && x0_in,
                       y1_in && x1_in};
  const bool x_lo = ix >= 0, x_hi = ix < W - 1;
  const bool y_lo = iy >= 0, y_hi = iy < H - 1;
  const bool k5m[4] = {y_lo && x_lo, y_lo && x_hi, y_hi && x_lo,
                       y_hi && x_hi};

  // clipped tap coordinates clip(i) and clip(i + 1), the latter clamped
  // before the + 1 so a saturated coordinate cannot overflow into a
  // negative address; at ix = -1 both x taps are column 0 (bit 8)
  const int cx0 = min(max(ix, 0), W - 1);
  const int cx1 = min(max(ix, -1), W - 2) + 1;
  const int cy0 = min(max(iy, 0), H - 1);
  const int cy1 = min(max(iy, -1), H - 2) + 1;
  const int64_t tap_off[4] = {(int64_t)cy0 * W + cx0, (int64_t)cy0 * W + cx1,
                              (int64_t)cy1 * W + cx0, (int64_t)cy1 * W + cx1};

  const float omfx = sub(1.0f, fx), omfy = sub(1.0f, fy);
  const float w[4] = {mul(omfx, omfy), mul(fx, omfy), mul(omfx, fy),
                      mul(fx, fy)};

  float cur[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    cur[c] = positions[c * n + p];
    cur[3 + c] = normals[c * n + p];
  }

  float pc[3] = {0.f, 0.f, 0.f}, k4[3] = {0.f, 0.f, 0.f},
        k5[3] = {0.f, 0.f, 0.f};
  float spp_sum = 0.f, tw = 0.f, k5w = 0.f;
  int accept = 0;

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float t[16];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t u = (uint32_t)__ldg(src8 + k * n + tap_off[i]);
      t[2 * k] = bf16_lo(u);
      t[2 * k + 1] = bf16_hi(u);
    }
    const float pd = sq3(sub(t[0], cur[0]), sub(t[1], cur[1]),
                         sub(t[2], cur[2]));
    const float nd = sq3(sub(t[3], cur[3]), sub(t[4], cur[4]),
                         sub(t[5], cur[5]));
    const bool ok = inb[i] && (pd < pos_lim) && (nd < nrm_lim);
    const float wgt = ok ? w[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      pc[c] = add(pc[c], mul(wgt, t[6 + c]));
      k4[c] = add(k4[c], mul(wgt, t[10 + c]));
    }
    spp_sum = add(spp_sum, mul(wgt, t[9]));
    tw = add(tw, wgt);
    accept |= ok ? (1 << i) : 0;
    const float wm = k5m[i] ? w[i] : 0.0f;
#pragma unroll
    for (int c = 0; c < 3; ++c) k5[c] = add(k5[c], mul(wm, t[13 + c]));
    k5w = add(k5w, wm);
  }

  out[0 * n + p] = pc[0];
  out[1 * n + p] = pc[1];
  out[2 * n + p] = pc[2];
  out[3 * n + p] = spp_sum;
  out[4 * n + p] = tw;
  out[5 * n + p] = (float)accept;
  out[6 * n + p] = k4[0];
  out[7 * n + p] = k4[1];
  out[8 * n + p] = k4[2];
  out[9 * n + p] = k5[0];
  out[10 * n + p] = k5[1];
  out[11 * n + p] = k5[2];
  out[12 * n + p] = k5w;
}

}  // namespace

extern "C" int bmfr_warp_blend(const int32_t* src8, const float* positions,
                               const float* normals, const float* pfx,
                               const float* pfy, float* out, int H, int W,
                               float pos_lim, float nrm_lim,
                               cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  warp_blend_kernel<<<blocks, threads, 0, stream>>>(
      src8, positions, normals, pfx, pfy, out, H, W, pos_lim, nrm_lim);
  return (int)cudaGetLastError();
}
