// 128-bit decimal helpers shared by the decimal kernels (K9's and K3's
// decimal128 sum kinds, the decimal avg finish): a decimal128 value is an
// int64 (hi, lo) pair in a [rows, 2] plane (the JAX package's layout,
// spark_rapids_tpu/expressions/decimal_math.py:104), read and written here
// as a two's-complement __int128.  Sums wrap mod 2^128 as the JAX
// package's limb sums do (ops/agg_ops.py:62-77).
#pragma once

#include <stdint.h>

namespace srt {

using i128 = __int128;
using u128 = unsigned __int128;

__device__ __forceinline__ i128 load_i128(const int64_t* plane, int64_t row) {
  const u128 hi = static_cast<u128>(static_cast<uint64_t>(plane[2 * row]));
  const u128 lo = static_cast<u128>(static_cast<uint64_t>(plane[2 * row + 1]));
  return static_cast<i128>((hi << 64) | lo);
}

__device__ __forceinline__ void store_i128(int64_t* plane, int64_t row,
                                           i128 v) {
  const u128 u = static_cast<u128>(v);
  plane[2 * row] = static_cast<int64_t>(static_cast<uint64_t>(u >> 64));
  plane[2 * row + 1] = static_cast<int64_t>(static_cast<uint64_t>(u));
}

// 10^k for 0 <= k <= 38 (10^38 < 2^128)
__device__ __forceinline__ u128 pow10_u128(int k) {
  u128 p = 1;
  for (int j = 0; j < k; ++j) p *= 10;
  return p;
}

}  // namespace srt
