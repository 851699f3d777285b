// The K1 tail with the geometry and accum/spp packs (kernel G) for Hopper
// (sm_90a).
//
// Replaces what XLA fuses on the TPU out of the pre-blended tail of
// bmfr_tpu/ops/reproject.py:40 (accumulate_noisy_data, opencl/bmfr.cl:
// 421-442) and the next state's words 0:5 (w_geo and w_acc,
// bmfr_tpu/pipeline/denoise.py:267-276) or, on a TemporalState, its
// normals, positions, noisy and spp (:279-287, donated outputs that XLA
// writes in place). Per pixel, from the warp's blend
// planes 0:6 (accept-gated colour and spp sums, total weight, accept bits)
// and the noisy colour: the blend factor max(1/(spp+1), blend_alpha), the
// new spp (round half even, saturating at 255), the accumulated colour,
// the accept byte and, with a PackedState carry, the bf16 channel pairs
// (positions 0:3, normals 3:6, accum 6:9, spp 9) as words 0:5 of the state
// buffer. With a TemporalState carry it stores the same values raw
// instead: the accumulated colour and spp go into the carry's noisy and
// spp (the wrapper passes them as accum and spp), and this frame's
// positions and normals, f32 as they were read, into the carry's
// positions and normals. Frame 0 (history flag off) has no history: spp
// 1, accept 0, the noisy colour. The next frame's warp (kernel A on the
// words, kernel I on the raw carry) reads what this launch stores; this
// frame's warp read the previous values before this launch, in stream
// order, so one buffer set carries the state.
//
// What bounds it on this card: bytes. Per pixel it reads 6 plane values
// and the 3 noisy ones (36 B) plus, with a carry, positions and normals
// (24 B), and writes the accumulated colour (12 B), spp and accept (2 B)
// and, with a PackedState, 5 words (20 B): 94 B, 87 MB per 1280x720 frame
// (26 us at 3.35 TB/s); with a TemporalState the positions and normals
// instead of the words (24 B): 98 B, 90 MB (27 us). One thread per pixel,
// every plane read and written once, coalesced along x.
//
// Every operation runs in the plain version's order with its own rounding
// (torch_ops.cuh), bit-equal to ops/reproject.py::noisy_tail_reference.

#include "torch_ops.cuh"

namespace {

using namespace torch_ops;

__global__ void noisy_tail_kernel(const float* __restrict__ planes,
                                  const float* __restrict__ noisy,
                                  const float* __restrict__ positions,
                                  const float* __restrict__ normals,
                                  float* __restrict__ accum,
                                  uint8_t* __restrict__ spp,
                                  uint8_t* __restrict__ accept,
                                  int32_t* __restrict__ pack,
                                  float* __restrict__ carry_positions,
                                  float* __restrict__ carry_normals, int H,
                                  int W, float blend_alpha, int history) {
  const int64_t n = (int64_t)H * W;
  const int64_t p = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= n) return;

  const float tw = planes[4 * n + p];
  const bool has_prev = history && tw > 0.0f;
  const float safe_tw = tw > 0.0f ? tw : 1.0f;
  float prev[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) prev[c] = quot(planes[c * n + p], safe_tw);
  const float s = quot(planes[3 * n + p], safe_tw);

  // max(1 / (spp + 1), blend_alpha); 1 / x is torch's reciprocal
  const float alpha =
      has_prev ? clamp_min(quot(1.0f, add(s, 1.0f)), blend_alpha) : 1.0f;
  // clamp(round(s), 0, 254) + 1 (NaN converts to 0), 255 above 254
  const int rounded = (int)clamp(rintf(s), 0.0f, 254.0f) + 1;
  const int new_spp = has_prev ? (s > 254.0f ? 255 : rounded) : 1;

  const float keep = sub(1.0f, alpha);
  float acc[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    acc[c] = add(mul(alpha, noisy[c * n + p]), mul(keep, prev[c]));
    accum[c * n + p] = acc[c];
  }
  spp[p] = (uint8_t)new_spp;
  // the accept bits as torch casts f32 to u8 (through int64)
  accept[p] = history ? (uint8_t)(long long)planes[5 * n + p] : (uint8_t)0;

  if (pack == nullptr && carry_positions == nullptr) return;
  float pos[3], nrm[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    pos[c] = positions[c * n + p];
    nrm[c] = normals[c * n + p];
  }
  if (carry_positions != nullptr) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      carry_positions[c * n + p] = pos[c];
      carry_normals[c * n + p] = nrm[c];
    }
  }
  if (pack != nullptr) {
    pack[p] = pack_pair(pos[0], pos[1]);
    pack[n + p] = pack_pair(pos[2], nrm[0]);
    pack[2 * n + p] = pack_pair(nrm[1], nrm[2]);
    pack[3 * n + p] = pack_pair(acc[0], acc[1]);
    pack[4 * n + p] = pack_pair(acc[2], (float)new_spp);
  }
}

}  // namespace

// pack: a PackedState's words, or null; carry_positions / carry_normals:
// a TemporalState carry's planes, or null (never both with pack)
extern "C" int bmfr_noisy_tail(const float* planes, const float* noisy,
                               const float* positions, const float* normals,
                               float* accum, uint8_t* spp, uint8_t* accept,
                               int32_t* pack, float* carry_positions,
                               float* carry_normals, int H, int W,
                               float blend_alpha, int history,
                               cudaStream_t stream) {
  const int threads = 256;
  const int64_t n = (int64_t)H * W;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  noisy_tail_kernel<<<blocks, threads, 0, stream>>>(
      planes, noisy, positions, normals, accum, spp, accept, pack,
      carry_positions, carry_normals, H, W, blend_alpha, history);
  return (int)cudaGetLastError();
}
