// The front of the basis kernels B and C (fitter_chol_basis.cu,
// householder_direct_basis.cu) for Hopper (sm_90a): the features of any
// basis, computed per pixel from the raw planes as the TPU kernels do
// (_build_block_data evaluates FEATURE_REGISTRY[name](n3, p3) inside
// _chol_kernel and _qr_kernel, bmfr_tpu/ops/fitter_direct.py:180-181).
//
// The wrapper (ops/fitter_direct.py::basis_plan, plane_table) gives each
// feature a plane and an op: a built-in feature whose name still holds its
// built-in function reads a raw plane and is computed here bit for bit as
// the registry's torch expression evaluates it (const 1, normal_{x,y,z},
// world_position_{x,y,z}, world_position_{x,y,z}2 = p * p unfused); any
// other feature reads its plane of the extra planes [K, H, W] that the
// wrapper evaluates with the registry (a feature is a per-pixel function,
// so it is addressed as the raw planes are). The table is a launch
// argument, not a template axis. Every feature is one load (two features
// of one position plane load it twice, from L1) and one multiply; the
// constant loads the first colour plane, which the kernel reads anyway,
// and takes 1.

#pragma once

#include "householder.cuh"

namespace bmfr {

// what a kernel does with a feature's plane
enum FeatureOp { kValue = 0, kSquare = 1, kOne = 2 };

// The basis as the kernels take it, by value: per feature the device
// address of the plane it reads and its op (at most MAXB - 3 features).
struct Basis {
  const float* plane[MAXB - 3];
  unsigned char op[MAXB];
};

// the basis from the wrapper's host table of F plane addresses and the
// op of feature i in byte i % 8 of word i / 8
inline Basis make_basis(const unsigned long long* planes, int F,
                        unsigned long long ops_lo, unsigned long long ops_hi) {
  Basis b{};
  for (int i = 0; i < F && i < MAXB - 3; ++i)
    b.plane[i] = reinterpret_cast<const float*>(planes[i]);
  for (int i = 0; i < MAXB; ++i)
    b.op[i] = (unsigned char)(((i < 8 ? ops_lo : ops_hi) >> (8 * (i % 8))) &
                              0xffu);
  return b;
}

// feature f of image pixel off, before the store contract: the plane's
// value (v * 1 is v, bit for bit), its square (unfused, as p * p
// evaluates), or 1. f is a static index, so the plane's address and the op
// are kernel parameters read from the constant bank. The load is never
// skipped and the op selects rather than branches: a branch between a
// pixel's loads keeps them from being in flight together (a version that
// branched around the constant's load took 1.2-1.4x as long, PERF.md).
// Table: Basis, or any table of plane[] and op[] (feature_table.cuh).
template <class Table>
__device__ __forceinline__ float feature_value(const Table& b, int f,
                                               int64_t off) {
  const int op = b.op[f];
  const float v = __ldg(b.plane[f] + off);
  const float p = __fmul_rn(v, op == kSquare ? v : 1.0f);
  return op == kOne ? 1.0f : p;
}

}  // namespace bmfr
