// Spark's Murmur3Hash on the card: murmur3_x86_32, seed 42, chained over
// the key columns, a null leaving the running hash as it was.
//
// The device form of the JAX package's expressions/hashing.py:128
// murmur3_col with _hash_int :67, _hash_long :73, _normalize_float_bits
// :82 and _hash_string_murmur :99 (its scalar twin _murmur_bytes_py :191):
//   int, date, bool  hashInt of the value (bool as 0 or 1), length 4;
//   long             hashInt steps over the low, then the high word, 8;
//                    an int widened to long hashes so too (kHashInt32Long:
//                    a join key hashed as its wider partner's type);
//   float            hashInt of the bits after -0.0 -> 0.0 and every NaN
//                    -> the canonical quiet NaN (Java's floatToIntBits);
//   double           hashLong of the bits, normalised the same way;
//   string           Spark's hashUnsafeBytes: the aligned 4-byte blocks
//                    little-endian, then each tail byte mixed on its own
//                    as a SIGNED int, then fmix with the byte length.
#pragma once

#include "common.cuh"

namespace srt {

constexpr int kMaxHashCols = 8;
constexpr uint32_t kMurmurSeed = 42;

// 0 to 3 as keys.cuh's KeyType
enum HashType : int32_t { kHashInt32 = 0, kHashInt64 = 1, kHashFloat64 = 2,
                          kHashString = 3, kHashFloat32 = 4, kHashBool = 5,
                          kHashInt32Long = 6 };

struct HashCols {
  int32_t n;
  int32_t type[kMaxHashCols];
  int32_t off64[kMaxHashCols];
  const void* data[kMaxHashCols];
  const uint8_t* valid[kMaxHashCols];
  const void* offsets[kMaxHashCols];
};

inline bool valid_hash_type(int32_t t) {
  return t >= kHashInt32 && t <= kHashInt32Long;
}

__device__ __forceinline__ uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ uint32_t mix_k1(uint32_t k1) {
  k1 *= 0xcc9e2d51u;
  k1 = rotl32(k1, 15);
  return k1 * 0x1b873593u;
}

__device__ __forceinline__ uint32_t mix_h1(uint32_t h1, uint32_t k1) {
  h1 ^= k1;
  h1 = rotl32(h1, 13);
  return h1 * 5u + 0xe6546b64u;
}

__device__ __forceinline__ uint32_t fmix32(uint32_t h1, uint32_t length) {
  h1 ^= length;
  h1 ^= h1 >> 16;
  h1 *= 0x85ebca6bu;
  h1 ^= h1 >> 13;
  h1 *= 0xc2b2ae35u;
  return h1 ^ (h1 >> 16);
}

__device__ __forceinline__ uint32_t murmur_int(uint32_t v, uint32_t seed) {
  return fmix32(mix_h1(seed, mix_k1(v)), 4u);
}

__device__ __forceinline__ uint32_t murmur_long(uint64_t v, uint32_t seed) {
  uint32_t h1 = mix_h1(seed, mix_k1(static_cast<uint32_t>(v)));
  h1 = mix_h1(h1, mix_k1(static_cast<uint32_t>(v >> 32)));
  return fmix32(h1, 8u);
}

__device__ __forceinline__ uint32_t murmur_bytes(const uint8_t* p,
                                                 int64_t len,
                                                 uint32_t seed) {
  uint32_t h1 = seed;
  const int64_t aligned = len & ~int64_t{3};
  for (int64_t b = 0; b < aligned; b += 4) {
    const uint32_t k = static_cast<uint32_t>(p[b]) |
                       (static_cast<uint32_t>(p[b + 1]) << 8) |
                       (static_cast<uint32_t>(p[b + 2]) << 16) |
                       (static_cast<uint32_t>(p[b + 3]) << 24);
    h1 = mix_h1(h1, mix_k1(k));
  }
  for (int64_t t = aligned; t < len; ++t) {
    const int32_t signed_byte = static_cast<int8_t>(p[t]);
    h1 = mix_h1(h1, mix_k1(static_cast<uint32_t>(signed_byte)));
  }
  return fmix32(h1, static_cast<uint32_t>(len));
}

// column c's running hash update for row i (the caller skips a null)
__device__ __forceinline__ uint32_t murmur_value(const HashCols& k, int c,
                                                 int64_t i, uint32_t h) {
  switch (k.type[c]) {
    case kHashInt32:
      return murmur_int(static_cast<uint32_t>(
                            static_cast<const int32_t*>(k.data[c])[i]),
                        h);
    case kHashBool:
      return murmur_int(static_cast<const uint8_t*>(k.data[c])[i] ? 1u : 0u,
                        h);
    case kHashInt64:
      return murmur_long(static_cast<uint64_t>(
                             static_cast<const long long*>(k.data[c])[i]),
                         h);
    case kHashInt32Long:
      return murmur_long(static_cast<uint64_t>(static_cast<long long>(
                             static_cast<const int32_t*>(k.data[c])[i])),
                         h);
    case kHashFloat32: {
      const float x = static_cast<const float*>(k.data[c])[i];
      const uint32_t bits =
          x == 0.0f ? 0u
          : isnan(x) ? 0x7fc00000u
                     : static_cast<uint32_t>(__float_as_int(x));
      return murmur_int(bits, h);
    }
    case kHashFloat64: {
      const double x = static_cast<const double*>(k.data[c])[i];
      const uint64_t bits =
          x == 0.0 ? 0ULL
          : isnan(x) ? 0x7ff8000000000000ULL
                     : static_cast<uint64_t>(__double_as_longlong(x));
      return murmur_long(bits, h);
    }
    default: {
      int64_t s, e;
      if (k.off64[c]) {
        const int64_t* o = static_cast<const int64_t*>(k.offsets[c]);
        s = o[i];
        e = o[i + 1];
      } else {
        const int32_t* o = static_cast<const int32_t*>(k.offsets[c]);
        s = o[i];
        e = o[i + 1];
      }
      return murmur_bytes(static_cast<const uint8_t*>(k.data[c]) + s, e - s,
                          h);
    }
  }
}

// Spark's hash(k1, ..., kn) of row i: seed 42, a null passes it on
__device__ __forceinline__ uint32_t row_murmur3(const HashCols& k,
                                                int64_t i) {
  uint32_t h = kMurmurSeed;
  for (int c = 0; c < k.n; ++c)
    if (k.valid[c] == nullptr || k.valid[c][i] != 0)
      h = murmur_value(k, c, i, h);
  return h;
}

}  // namespace srt
