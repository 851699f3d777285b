// The Householder QR core of kernels C and D for Hopper (sm_90a).
//
// Per reflection col (bmfr_tpu/ops/fitter.py:90-115, opencl/bmfr.cl:
// 549-656), with v column col of the block: sigma = sum_{e > col} v_e^2,
// vec_len = sqrt(sigma + pivot^2), head = pivot - vec_len, u_len_sq =
// sigma + head^2, u = (0.., head at col, v_e for e > col); every trailing
// column c gets x_c -= (2 / u_len_sq)(u . x_c) u, unfused as the plain
// version evaluates it, and the storage rounding; column col keeps rows
// < col and gets vec_len on the diagonal (rows below are never read). The
// reference's cross-colour reflections only touch rows the solve never
// reads and are skipped, as in the JAX package.
//
// One reduction per reflection: u . x_c = head * x_{col,c} +
// sum_{e > col} v_e x_{e,c}, so sigma and the partial dots are summed
// together, and the pivot row x_{col,*} is handed out beside them (a
// shuffle from its owner in a group of <= 32 threads, else a write to
// shared memory before the same barrier); the dots are completed once
// head is known. Shared scratch is double-buffered by reflection parity,
// so one barrier per reflection suffices and none follows the update.
//
// The column count NB is a template parameter, so every loop over columns
// is static and the columns' registers are indexed statically. Two forms
// of the chain: qr_registers (kernel D, the basis kernel C) runs the
// reflections as a loop, which keeps each of their many instances small;
// qr_unrolled (kernel C) unrolls them by column, so reflection col sums,
// hands out and updates only its NB - col live columns where they lie.
// Unrolled, kernel C took 0.0817 ms a call against the loop's 0.0931, and
// kernel D 0.0756 against 0.0831; but D's code grew from 56 to 101 KB, and
// after another kernel's code had filled the SMs' instruction caches, as
// the frame's other kernels do, it took 0.0856 against the loop's 0.0834
// (C: 0.0843 against 0.0934), and the basis kernel C at 16 columns took
// 0.1839 against 0.1658 even alone (H100; PERF.md, Findings).

#pragma once

#include <type_traits>

#include "fitter_front.cuh"

namespace bmfr {

constexpr int MAXB = 16;  // columns (features + colours) a block may have

// A group of G threads fits one block: G = 16 (half a warp) or a multiple
// of 32. Groups sit side by side in the CTA.
struct Group {
  int G, grp, gt, lane, wcta, w0, nw;
};

__device__ __forceinline__ Group make_group(int G) {
  Group g;
  g.G = G;
  g.grp = threadIdx.x / G;
  g.gt = threadIdx.x % G;
  g.lane = threadIdx.x & 31;
  g.wcta = threadIdx.x >> 5;
  g.nw = G >= 32 ? G / 32 : 1;
  g.w0 = g.grp * g.nw;
  return g;
}

// The block min/max: Op-totals of v[0..N) over the group, left in every
// lane's v (a butterfly over the warp or half warp, whose lanes all end
// with the same totals since Op commutes; above 32 threads one barrier and
// every lane combines the warps' totals in warp order). red: [warps][N].
template <class Op, int N>
__device__ __forceinline__ void group_reduce(float (&v)[N], const Group& g,
                                             float* red) {
  for (int o = (g.G < 32 ? g.G : 32) >> 1; o > 0; o >>= 1) {
#pragma unroll
    for (int c = 0; c < N; ++c)
      v[c] = Op::f(v[c], __shfl_xor_sync(FULL, v[c], o));
  }
  if (g.G <= 32) return;
  if (g.lane == 0) {
#pragma unroll
    for (int c = 0; c < N; ++c) red[g.wcta * N + c] = v[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = red[g.w0 * N + c];
  for (int w = 1; w < g.nw; ++w) {
#pragma unroll
    for (int c = 0; c < N; ++c) v[c] = Op::f(v[c], red[(g.w0 + w) * N + c]);
  }
}

// The reflection's scalars from sigma and the pivot.
struct Reflection {
  float vec_len, head, coef;
};

__device__ __forceinline__ Reflection reflection(float sigma, float pivot) {
  Reflection r;
  r.vec_len = sqrtf(sigma + pivot * pivot);
  r.head = pivot - r.vec_len;
  r.coef = 2.0f / (sigma + r.head * r.head);
  return r;
}

// x - (coef * dot) * u, unfused, then the storage rounding
template <int M>
__device__ __forceinline__ float reflect_value(float x, float k, float u) {
  return quantize<M>(__fsub_rn(x, __fmul_rn(k, u)));
}

// The one reduction of a reflection: the sums of v[0..N) (N <= 16) over
// the group, left in every lane's v. A group of 16 (half a warp) takes a
// butterfly, whose lanes all end with the same totals (the adds commute;
// measured faster there than the transpose below). A larger group takes a
// transpose reduction per warp over P values, P the power of two from N
// up (fitter_front.cuh: log2 P steps at offsets 16, 8, .., P/2 + P/4 + ..
// shuffles, not 5 N), then a butterfly over the offsets left down to 1:
// whatever N, each value's warp total is summed over the offsets 16, 8, 4,
// 2, 1 in that order, and lanes 32 c / P .. 32 (c + 1) / P - 1 end with
// value c's. The first of them writes it to red [warps][stride] (red_buf,
// this reflection's buffer), and after the one barrier lane c sums value
// c over the group's warps, in warp order, and hands it out by shuffles.
// sync: the caller's shared writes before the barrier (the pivot row).
template <int N, bool HALF, class Sync>
__device__ __forceinline__ void group_sum(float (&v)[N], const Group& g,
                                          float* red_buf, int stride,
                                          Sync&& sync) {
  static_assert(N <= 16, "group_sum carries at most 16 values");
  if constexpr (HALF) {
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
      for (int c = 0; c < N; ++c) v[c] += __shfl_xor_sync(FULL, v[c], o);
    }
    sync();
    return;
  }
  constexpr int STEPS = N > 8 ? 4 : (N > 4 ? 3 : (N > 2 ? 2 : (N > 1)));
  constexpr int P = 1 << STEPS, SPAN = 32 / P;  // SPAN lanes hold a total
  float a[P];
#pragma unroll
  for (int i = 0; i < P; ++i) a[i] = i < N ? v[i] : 0.0f;
  transpose_halves<SumOp, P, STEPS>(a, g.lane);
#pragma unroll
  for (int o = SPAN / 2; o > 0; o >>= 1)
    a[0] += __shfl_xor_sync(FULL, a[0], o);
  const int idx = g.lane / SPAN;
  if (g.lane % SPAN == 0 && idx < N) red_buf[g.wcta * stride + idx] = a[0];
  sync();
  __syncthreads();
  float t = 0.0f;
  if (g.lane < N) {
    t = red_buf[g.w0 * stride + g.lane];
    for (int w = 1; w < g.nw; ++w) t += red_buf[(g.w0 + w) * stride + g.lane];
  }
#pragma unroll
  for (int c = 0; c < N; ++c) v[c] = __shfl_sync(FULL, t, c);
}

// x[r] for a row r (0..3) known only at run time, without indexing the
// registers dynamically
__device__ __forceinline__ float pick(const float (&x)[4], int r) {
  return r == 0 ? x[0] : (r == 1 ? x[1] : (r == 2 ? x[2] : x[3]));
}

// ---- the register-resident QR: a thread holds rows 4 gt .. 4 gt + 3 of
// the block in x[slot][row]; rows past the block are zero. HALF: the
// group is half a warp (16 threads), else whole warps. Before
// reflection col, slot j holds column col + j (zeros past the last
// column): the pivot is always slot 0, so the reflections run as a loop
// while every register index stays static, and the columns shift down one
// slot after each. Row col is final once reflection col has updated it:
// its owner writes it to rs[c * 16 + col] (columns col.., vec_len on the
// diagonal) for the back substitution. Scratch: red [2][warps][2 NB],
// rows [2][groups][NB] (groups of > 32 threads only). ----
template <int M, int NB, bool HALF>
__device__ __forceinline__ void qr_registers(float (&x)[NB][4],
                                             const Group& g, float* red,
                                             float* rows, float* rs,
                                             int warps, int groups) {
  constexpr int F = NB - 3, RS = 2 * NB;
  const int e0 = 4 * g.gt;
#pragma unroll 1
  for (int col = 0; col < F; ++col) {
    const int owner = col >> 2, slot = col & 3, buf = col & 1;
    float s[NB];
#pragma unroll
    for (int j = 0; j < NB; ++j) s[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = e0 + r > col ? x[0][r] : 0.0f;
      s[0] += v * v;
#pragma unroll
      for (int j = 1; j < NB; ++j) s[j] += v * x[j][r];
    }
    // the pivot row: shuffled from its owner in a half warp, else read
    // from shared memory where it is used (fewer live registers)
    float* wb = rows + (buf * groups + g.grp) * NB;
    group_sum<NB, HALF>(s, g, red + buf * warps * RS, RS, [&] {
      if (!HALF && g.gt == owner) {
#pragma unroll
        for (int j = 0; j < NB; ++j) wb[j] = pick(x[j], slot);
      }
    });
    float pr[HALF ? NB : 1];
    if constexpr (HALF) {
      const int src = (g.lane & ~15) + owner;
#pragma unroll
      for (int j = 0; j < NB; ++j)
        pr[j] = __shfl_sync(FULL, pick(x[j], slot), src);
    }
    const Reflection q = reflection(s[0], HALF ? pr[0] : wb[0]);
    float u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = e0 + r;
      u[r] = e > col ? x[0][r] : (e == col ? q.head : 0.0f);
    }
#pragma unroll
    for (int j = 1; j < NB; ++j) {
      const float k =
          __fmul_rn(q.coef, q.head * (HALF ? pr[HALF ? j : 0] : wb[j]) + s[j]);
#pragma unroll
      for (int r = 0; r < 4; ++r) x[j][r] = reflect_value<M>(x[j][r], k, u[r]);
    }
    if (g.gt == owner) {
      rs[col * 16 + col] = q.vec_len;
#pragma unroll
      for (int j = 1; j < NB; ++j)
        if (col + j < NB) rs[(col + j) * 16 + col] = pick(x[j], slot);
    }
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int j = 0; j + 1 < NB; ++j) x[j][r] = x[j + 1][r];
      x[NB - 1][r] = 0.0f;
    }
  }
}

// ---- the same QR unrolled by column, for a group of whole warps: a
// thread holds rows 4 gt .. 4 gt + 3 of the block in x[column][row].
// Reflection COL reads its pivot column x[COL] where it lies, and the
// sums, the pivot row's hand-out and the updates cover the L = NB - COL
// columns from COL on; then it runs reflection COL + 1. The pivot row's
// owner (thread COL / 4) and its row slot (COL % 4) are compile-time
// values. Each value goes through the same operations, in the same order,
// as in qr_registers. Scratch as qr_registers'. ----
template <int M, int NB, int COL = 0>
__device__ __forceinline__ void qr_unrolled(float (&x)[NB][4], const Group& g,
                                            float* red, float* rows,
                                            float* rs, int warps,
                                            int groups) {
  constexpr int F = NB - 3, RS = 2 * NB;
  if constexpr (COL < F) {
    constexpr int L = NB - COL, owner = COL >> 2, slot = COL & 3;
    constexpr int buf = COL & 1;
    const int e0 = 4 * g.gt;
    // s[0] = sigma, s[j] the partial dot of column COL + j
    float s[L];
#pragma unroll
    for (int j = 0; j < L; ++j) s[j] = 0.0f;
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float v = e0 + r > COL ? x[COL][r] : 0.0f;
      s[0] += v * v;
#pragma unroll
      for (int j = 1; j < L; ++j) s[j] += v * x[COL + j][r];
    }
    // the pivot row, read from shared memory where it is used
    float* wb = rows + (buf * groups + g.grp) * NB;
    group_sum<L, false>(s, g, red + buf * warps * RS, RS, [&] {
      if (g.gt == owner) {
#pragma unroll
        for (int j = 0; j < L; ++j) wb[j] = x[COL + j][slot];
      }
    });
    const Reflection q = reflection(s[0], wb[0]);
    float u[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int e = e0 + r;
      u[r] = e > COL ? x[COL][r] : (e == COL ? q.head : 0.0f);
    }
#pragma unroll
    for (int j = 1; j < L; ++j) {
      const float k = __fmul_rn(q.coef, q.head * wb[j] + s[j]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        x[COL + j][r] = reflect_value<M>(x[COL + j][r], k, u[r]);
    }
    if (g.gt == owner) {
      rs[COL * 16 + COL] = q.vec_len;
#pragma unroll
      for (int j = 1; j < L; ++j) rs[(COL + j) * 16 + COL] = x[COL + j][slot];
    }
    qr_unrolled<M, NB, COL + 1>(x, g, red, rows, rs, warps, groups);
  }
}

// Back substitution R w = Q^T b (opencl/bmfr.cl:657-699) for colour ch,
// with at(c, r) the value of column c at row r after the reflections.
template <int F, class At>
__device__ __forceinline__ void back_substitute(int ch, At at, float (&w)[F]) {
#pragma unroll
  for (int r = F - 1; r >= 0; --r) {
    float acc = at(F + ch, r);
#pragma unroll
    for (int c = r + 1; c < F; ++c) acc = acc - at(c, r) * w[c];
    w[r] = acc / at(r, r);
  }
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// ---- host side ----

template <class T>
struct Tag {
  using type = T;
};

// fn(Tag<storage type>, integral_constant<mode>) for tmp-dtype code mode
template <class Fn>
int with_storage(int mode, Fn&& fn) {
  if (mode == kF16) return fn(Tag<__half>(), std::integral_constant<int, kF16>());
  if (mode == kBF16)
    return fn(Tag<__nv_bfloat16>(), std::integral_constant<int, kBF16>());
  return fn(Tag<float>(), std::integral_constant<int, kF32>());
}

// fn(integral_constant<NB>) for a column count 4 <= B <= MAXB
template <int NB = 4, class Fn>
int with_columns(int B, Fn&& fn) {
  if constexpr (NB > MAXB) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (B == NB) return fn(std::integral_constant<int, NB>());
    return with_columns<NB + 1>(B, fn);
  }
}

// Opt a kernel in to more than 48 KB of dynamic shared memory (once per
// size it grows to).
template <typename K>
int allow_smem(K kernel, int bytes, int* granted) {
  if (bytes <= *granted) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) *granted = bytes;
  return (int)err;
}

}  // namespace bmfr
