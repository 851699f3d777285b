// The feature basis as kernels J and K take it (feature_blocks.cu,
// block_reconstruct.cu): per feature the device address of the plane it
// reads and its op, from the wrapper's ops/fitter_direct.py::plane_table,
// the same table the basis kernels B and C take (basis_front.cuh) with
// room for any basis the block path runs (up to kMaxFeatures features).
// A built-in feature reads its raw plane (its square, or 1, computed bit
// for bit as the registry's torch expression evaluates it: basis_front.cuh
// ::feature_value); any other reads the plane the wrapper evaluated with
// the registry.

#pragma once

#include "basis_front.cuh"

namespace bmfr {

constexpr int kMaxFeatures = 64;

// passed by value as a kernel argument (576 bytes)
struct FeatureTable {
  const float* plane[kMaxFeatures];
  unsigned char op[kMaxFeatures];
};

// the table from the wrapper's host arrays: F plane addresses, and the op
// of feature i in byte i % 8 of word i / 8
inline FeatureTable make_feature_table(const unsigned long long* planes,
                                       const unsigned long long* ops, int F) {
  FeatureTable t{};
  for (int i = 0; i < F && i < kMaxFeatures; ++i) {
    t.plane[i] = reinterpret_cast<const float*>(planes[i]);
    t.op[i] = (unsigned char)((ops[i / 8] >> (8 * (i % 8))) & 0xffu);
  }
  return t;
}

}  // namespace bmfr
