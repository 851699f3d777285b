// The block fitter (kernel D) for Hopper (sm_90a), shared-memory route:
// block_edge 40..64 (1600..4096 pixels a block), where a group of 256
// threads with 4 rows each cannot hold the block and a 1024-thread group
// would spill. Same function as householder_blocks.cu (the TPU kernel
// _fitter_kernel, bmfr_tpu/ops/fitter_pallas.py).
//
// One CTA of 256 threads fits one block. The columns live in shared
// memory (dynamic, column c at data + c * bp, loaded with 16-byte
// vectors); thread t owns rows t + 256 k and reads and writes only those,
// so the only shared value a reflection needs besides its one fused
// reduction (householder.cuh) is the pivot row, which its owner writes to
// a double-buffered slot before the reduction's barrier. At block_edge 64
// with 15 or 16 columns the block exceeds the 227 KB a CTA may use; there
// the last 1 or 2 colour columns (never pivots) stay in registers, 16 rows
// a thread (launch_geometry's reg_columns).
//
// What bounds it on this card: the 10 barrier-separated reductions of a
// 256-thread CTA and the shared-memory traffic of the trailing columns
// (each reflection reads them twice and writes them once); at 213 KB a
// block one CTA fits an SM.

#include "householder.cuh"

namespace {

using namespace bmfr;

// 16-byte loads of n (a multiple of 8) stored values into f32 dst
__device__ __forceinline__ void load_columns(const float* src, float* dst,
                                             int n) {
  for (int i = threadIdx.x; i < n / 4; i += THREADS)
    reinterpret_cast<float4*>(dst)[i] = reinterpret_cast<const float4*>(src)[i];
}
__device__ __forceinline__ float from_bits(__half, unsigned short b) {
  return __half2float(__ushort_as_half(b));
}
__device__ __forceinline__ float from_bits(__nv_bfloat16, unsigned short b) {
  return __bfloat162float(__ushort_as_bfloat16(b));
}
template <typename T>
__device__ __forceinline__ void load_columns(const T* src, float* dst, int n) {
  for (int i = threadIdx.x; i < n / 8; i += THREADS) {
    const uint4 q = reinterpret_cast<const uint4*>(src)[i];
    const unsigned w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      dst[8 * i + 2 * j] = from_bits(T(), (unsigned short)(w[j] & 0xffffu));
      dst[8 * i + 2 * j + 1] = from_bits(T(), (unsigned short)(w[j] >> 16));
    }
  }
}

// Shared layout (dynamic, sized by launch_geometry): data [NB - NREG][bp],
// red [2][WARPS][2 NB], rows [2][NB], rhs [2][16].
template <int M, int NB, int NREG>
struct SmemQR {
  static constexpr int NS = NB - NREG;  // columns in shared memory
  static constexpr int RS = 2 * NB;
  static constexpr int NR = NREG > 0 ? NREG : 1;
  float* data;
  float* red;
  float* rows;
  int bp;
  float (&xr)[NR][16];  // register columns NS.., row tid + 256 k

  // body(e, k) for each of this thread's rows
  template <class Body>
  __device__ __forceinline__ void each_row(Body&& body) {
    if constexpr (NREG == 0) {
      for (int e = threadIdx.x; e < bp; e += THREADS) body(e, 0);
    } else {  // bp == 4096
#pragma unroll
      for (int k = 0; k < 16; ++k) body((int)threadIdx.x + THREADS * k, k);
    }
  }

  __device__ __forceinline__ float get(int c, int e, int k) {
    return c < NS ? data[c * bp + e] : xr[c >= NS ? c - NS : 0][k];
  }

  // The F reflections as a loop. Sums run over every column (those of
  // columns <= col are not used); updates touch only columns > col.
  __device__ __forceinline__ void qr(const Group& g) {
    constexpr int F = NB - 3;
#pragma unroll 1
    for (int col = 0; col < F; ++col) {
      float s[NB], pr[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c) s[c] = 0.0f;
      each_row([&](int e, int k) {
        const float v = e > col ? data[col * bp + e] : 0.0f;
#pragma unroll
        for (int c = 0; c < NB; ++c) s[c] += v * get(c, e, k);
      });
      const int buf = col & 1;
      float* wb = rows + buf * NB;
      group_sum<NB, false>(s, g, red + buf * WARPS * RS, RS, [&] {
        if ((int)threadIdx.x == col) {  // row col is this thread's row k = 0
#pragma unroll
          for (int c = 0; c < NB; ++c) wb[c] = get(c, col, 0);
        }
      });
#pragma unroll
      for (int c = 0; c < NB; ++c) pr[c] = wb[c];
      // s[c] at c == col is sigma: the pivot column's own sum of squares
      float sigma = 0.0f;
#pragma unroll
      for (int c = 0; c < F; ++c) sigma = c == col ? s[c] : sigma;
      float pivot = 0.0f;
#pragma unroll
      for (int c = 0; c < F; ++c) pivot = c == col ? pr[c] : pivot;
      const Reflection q = reflection(sigma, pivot);
      float kc[NB];
#pragma unroll
      for (int c = 0; c < NB; ++c)
        kc[c] = __fmul_rn(q.coef, q.head * pr[c] + s[c]);
      each_row([&](int e, int k) {
        const float ve = data[col * bp + e];
        const float u = e > col ? ve : (e == col ? q.head : 0.0f);
#pragma unroll
        for (int c = 0; c < NB; ++c) {
          if (c < NS) {
            if (c > col) {
              float* p = data + c * bp + e;
              *p = reflect_value<M>(*p, kc[c], u);
            }
          } else {  // a colour column: always past col
            float& r = xr[c >= NS ? c - NS : 0][k];
            r = reflect_value<M>(r, kc[c], u);
          }
        }
      });
      if ((int)threadIdx.x == col) data[col * bp + col] = q.vec_len;
    }
  }
};

template <typename T, int M, int NB, int NREG>
__global__ void __launch_bounds__(THREADS)
fit_blocks_smem_kernel(const T* __restrict__ tmp, float* __restrict__ weights,
                       float* __restrict__ mins_maxs, int lo, int bp,
                       const int* __restrict__ frame, float amp) {
  using QR = SmemQR<M, NB, NREG>;
  constexpr int F = NB - 3, NS = QR::NS, RS = QR::RS;
  const Noise nz = frame_noise(__ldg(frame), amp, bp, NB);
  extern __shared__ float smem[];
  float* data = smem;
  float* red = data + NS * bp;
  float* rows = red + 2 * WARPS * RS;
  float* rhs = rows + 2 * NB;
  const Group g = make_group(THREADS);
  const int tid = threadIdx.x;
  const int64_t b = blockIdx.x;
  const T* src = tmp + b * NB * bp;

  float xr[QR::NR][16];
  load_columns(src, data, NS * bp);
  if constexpr (NREG > 0) {
#pragma unroll
    for (int j = 0; j < NREG; ++j) {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        xr[j][k] = to_float(src[(NS + j) * bp + tid + THREADS * k]);
    }
  }
  __syncthreads();

  // block min/max of the scaled features: mm[c] = -min, mm[F + c] = max
  float mm[2 * F];
#pragma unroll
  for (int c = 0; c < 2 * F; ++c) mm[c] = -INFINITY;
  for (int e = tid; e < bp; e += THREADS) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      const float v = data[c * bp + e];
      mm[c] = fmaxf(mm[c], -v);
      mm[F + c] = fmaxf(mm[F + c], v);
    }
  }
  group_reduce<MaxOp, 2 * F>(mm, g, red + WARPS * RS);
  if (tid == 0) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      if (c >= lo) {
        mins_maxs[(b * (F - lo) + c - lo) * 2] = -mm[c];
        mins_maxs[(b * (F - lo) + c - lo) * 2 + 1] = mm[F + c];
      }
    }
  }

  // rescale + storage rounding, then the noise (own rows only)
  for (int e = tid; e < bp; e += THREADS) {
#pragma unroll
    for (int c = 0; c < F; ++c) {
      float v = data[c * bp + e];
      if (c >= lo) v = quantize<M>((v + mm[c]) / scale_den(-mm[c], mm[F + c]));
      if (c > 0) v = v + noise_at(nz, c, e);
      data[c * bp + e] = v;
    }
  }

  QR solver{data, red, rows, bp, xr};
  solver.qr(g);

  if constexpr (NREG > 0) {
    if (tid < F) {
#pragma unroll
      for (int j = 0; j < NREG; ++j) rhs[j * 16 + tid] = xr[j][0];
    }
  }
  __syncthreads();
  if (tid < 3) {
    float w[F];
    back_substitute<F>(
        tid,
        [&](int c, int r) {
          return c < NS ? data[c * bp + r] : rhs[(c - NS) * 16 + r];
        },
        w);
#pragma unroll
    for (int f = 0; f < F; ++f) weights[(b * F + f) * 3 + tid] = w[f];
  }
}

template <typename T, int M, int NB, int NREG>
int launch(const void* tmp, float* weights, float* mins_maxs, int nb, int lo,
           int bp, int smem, const int* frame, float amp,
           cudaStream_t stream) {
  static int granted = 48 * 1024;
  auto kernel = fit_blocks_smem_kernel<T, M, NB, NREG>;
  const int err = allow_smem(kernel, smem, &granted);
  if (err != 0) return err;
  kernel<<<(unsigned)nb, THREADS, smem, stream>>>(
      (const T*)tmp, weights, mins_maxs, lo, bp, frame, amp);
  return (int)cudaGetLastError();
}

}  // namespace

// Shared-memory route of kernel D. reg_columns: trailing columns kept in
// registers (0; 1 or 2 only at bp = 4096 with 15 or 16 columns); smem:
// the launch geometry's dynamic shared bytes. Other arguments as
// bmfr_fit_blocks_registers.
extern "C" int bmfr_fit_blocks_shared(const void* tmp, float* weights,
                                      float* mins_maxs, int nb, int B, int lo,
                                      int bp, int mode, int reg_columns,
                                      int smem, const int* frame,
                                      float noise_amp, cudaStream_t stream) {
  if (reg_columns != 0 && (bp != 4096 || B - reg_columns < 14))
    return (int)cudaErrorInvalidValue;
  return with_storage(mode, [&](auto tag, auto m) {
    using T = typename decltype(tag)::type;
    constexpr int Mv = decltype(m)::value;
    if (reg_columns == 1 && B == 15)
      return launch<T, Mv, 15, 1>(tmp, weights, mins_maxs, nb, lo, bp, smem,
                                  frame, noise_amp, stream);
    if (reg_columns == 2 && B == 16)
      return launch<T, Mv, 16, 2>(tmp, weights, mins_maxs, nb, lo, bp, smem,
                                  frame, noise_amp, stream);
    if (reg_columns != 0) return (int)cudaErrorInvalidValue;
    return with_columns(B, [&](auto cols) {
      return launch<T, Mv, decltype(cols)::value, 0>(
          tmp, weights, mins_maxs, nb, lo, bp, smem, frame, noise_amp,
          stream);
    });
  });
}
