// Key columns shared by the keyed aggregation (keyed_agg.cu, K9), the
// window (window.cu, K14) and the hash join (hash_join.cu, K10): up to 8
// columns of int32 (int, date), int64, double or string (offsets int32 or
// int64 and chars), each with an optional validity plane.
//
// Equality follows the JAX package's _masked_group_words
// (spark_rapids_tpu/ops/agg_ops.py:38) over sortable_words
// (ops/sort_ops.py:92): a null equals a null and nothing else (the data
// under it is not read); doubles compare by their normalised bits, so -0.0
// equals 0.0 and every NaN equals every NaN; strings compare byte for byte.
// A join compares keys only where all_present holds: a null in a key
// column drops the row unless bit c of null_safe marks column c null-safe
// (SQL's <=>, the JAX package's _expand_verify null_safe,
// spark_rapids_tpu/ops/join_ops.py:192, :234), where it is a value that
// equals a null alone.  K9 and K14 group nulls together and leave
// null_safe 0.
// row_hash hashes the same normalised words (murmur3's fmix64 chained over
// the columns, a string's bytes folded by FNV-1a first), so equal keys hash
// alike.
#pragma once

#include "common.cuh"

namespace srt {

constexpr int kMaxKeys = 8;
constexpr uint64_t kKeySeed = 0x9e3779b97f4a7c15ULL;
constexpr uint64_t kNullWord = 0x5bd1e9955bd1e995ULL;

enum KeyType : int32_t { kKeyInt32 = 0, kKeyInt64 = 1, kKeyFloat64 = 2,
                         kKeyString = 3 };

struct Keys {
  int32_t n;
  uint32_t null_safe;  // bit c: a null in column c is a join key value
  int32_t type[kMaxKeys];
  int32_t off64[kMaxKeys];
  const void* data[kMaxKeys];
  const uint8_t* valid[kMaxKeys];
  const void* offsets[kMaxKeys];
};

inline bool valid_key_type(int32_t t) {
  return t >= kKeyInt32 && t <= kKeyString;
}

inline Keys make_keys(int32_t n_keys, const int32_t* type,
                      const int32_t* off64, const void* const* data,
                      const void* const* valid, const void* const* offsets) {
  Keys k;
  k.n = n_keys;
  k.null_safe = 0;
  for (int c = 0; c < n_keys; ++c) {
    k.type[c] = type[c];
    k.off64[c] = off64[c];
    k.data[c] = data[c];
    k.valid[c] = static_cast<const uint8_t*>(valid[c]);
    k.offsets[c] = offsets[c];
  }
  return k;
}

__device__ __forceinline__ bool key_present(const Keys& k, int c, int64_t i) {
  return k.valid[c] == nullptr || k.valid[c][i] != 0;
}

__device__ __forceinline__ void string_bounds(const Keys& k, int c,
                                              int64_t i, int64_t* start,
                                              int64_t* end) {
  if (k.off64[c]) {
    const int64_t* o = static_cast<const int64_t*>(k.offsets[c]);
    *start = o[i];
    *end = o[i + 1];
  } else {
    const int32_t* o = static_cast<const int32_t*>(k.offsets[c]);
    *start = o[i];
    *end = o[i + 1];
  }
}

// The 64-bit word of a fixed-width key: an int32 sign-extended, an int64
// as is, a double's bits with -0.0 as 0.0 and every NaN as one quiet NaN.
__device__ __forceinline__ uint64_t key_word(const Keys& k, int c,
                                             int64_t i) {
  if (k.type[c] == kKeyInt32)
    return static_cast<uint64_t>(static_cast<long long>(
        static_cast<const int32_t*>(k.data[c])[i]));
  if (k.type[c] == kKeyInt64)
    return static_cast<uint64_t>(static_cast<const long long*>(k.data[c])[i]);
  const double x = static_cast<const double*>(k.data[c])[i];
  if (x == 0.0) return 0;
  if (isnan(x)) return 0x7ff8000000000000ULL;
  return static_cast<uint64_t>(__double_as_longlong(x));
}

__device__ uint64_t row_hash(const Keys& k, int64_t i) {
  uint64_t h = kKeySeed;
  for (int c = 0; c < k.n; ++c) {
    uint64_t x;
    if (!key_present(k, c, i)) {
      x = kNullWord;
    } else if (k.type[c] == kKeyString) {
      int64_t s, e;
      string_bounds(k, c, i, &s, &e);
      const uint8_t* chars = static_cast<const uint8_t*>(k.data[c]);
      x = 0xcbf29ce484222325ULL;
      for (int64_t b = s; b < e; ++b)
        x = (x ^ chars[b]) * 0x100000001b3ULL;
    } else {
      x = key_word(k, c, i);
    }
    h = fmix64(h ^ x);
  }
  return h;
}

// Row a of key columns ka has the keys of row b of kb: the two may be
// different column sets of the same arity (a join's build and probe
// sides), so an int key equals a long one of the same value (key_word
// widens both) and two strings compare across their chars buffers.
__device__ bool keys_equal(const Keys& ka, int64_t a, const Keys& kb,
                           int64_t b) {
  for (int c = 0; c < ka.n; ++c) {
    const bool pa = key_present(ka, c, a);
    if (pa != key_present(kb, c, b)) return false;
    if (!pa) continue;
    if (ka.type[c] == kKeyString) {
      int64_t sa, ea, sb, eb;
      string_bounds(ka, c, a, &sa, &ea);
      string_bounds(kb, c, b, &sb, &eb);
      if (ea - sa != eb - sb) return false;
      const uint8_t* ca = static_cast<const uint8_t*>(ka.data[c]);
      const uint8_t* cb = static_cast<const uint8_t*>(kb.data[c]);
      for (int64_t j = 0; j < ea - sa; ++j)
        if (ca[sa + j] != cb[sb + j]) return false;
    } else if (key_word(ka, c, a) != key_word(kb, c, b)) {
      return false;
    }
  }
  return true;
}

__device__ __forceinline__ bool keys_equal(const Keys& k, int64_t a,
                                           int64_t b) {
  return keys_equal(k, a, k, b);
}

// every key column of row i is present, or null in a null-safe column
// (a join key with any other null never matches)
__device__ __forceinline__ bool all_present(const Keys& k, int64_t i) {
  for (int c = 0; c < k.n; ++c)
    if (!key_present(k, c, i) && !((k.null_safe >> c) & 1u)) return false;
  return true;
}

}  // namespace srt
