// Kernel K8: multi-key stable sort of a batch's rows.
//
// Replaces the JAX package's `sort.fused` program
// (spark_rapids_tpu/ops/sort_ops.py:237 sort_gather_batch, built :298)
// with its key normalizers _float_sortable :61, sortable_words :92 and
// _order_words :115.  The JAX package sorts all key words at once with
// jax.lax.sort; here each key becomes unsigned 64-bit words whose integer
// order is the SQL order, and a stable LSD radix sort (radix.cuh) orders
// the row indices by them.  The caller then gathers the columns through
// the permutation (K7).
//
// Words of one key (sort_words):
//   - a null-rank word (1 bit), only for a key that may hold nulls:
//     nulls first -> null 0, value 1; nulls last -> null 1, value 0;
//   - the value word, 0 under a null (the JAX package's host twin
//     host_order_words masks the same way):
//       int    (uint32)v ^ 0x80000000 (32 bits, 4 passes);
//       long   (uint64)v ^ 2^63;
//       double -0.0 becomes 0.0, every NaN the positive quiet NaN (so NaN
//              sorts after +inf); then bits ^ 2^63 when the sign is clear
//              and ~bits when it is set;
//       decimal64 as its unscaled int64 (a long);
//       decimal128 (a [rows, 2] (hi, lo) plane) as two words, the hi word
//              as a long, then the lo word's bits as they are
//              (ops/sort_ops.py:101-111 of the JAX package);
//     descending flips the value words' bits (not the rank word's).
//   - a string key (string_words) has ceil(longest / 7) value words (at
//     least one), the JAX package's _string_words (:71) bit for bit: 7
//     bytes a word, big-endian, each byte stored as byte + 1 in a 9-bit
//     field, 0 past the end, so "ab" sorts before "ab\0" and "abc", and
//     bytes >= 0x80 above ASCII; 0 under a null; descending flips all 64
//     bits.  Its longest length comes first from string_max_len (the host
//     reads it: the sort's one sync, only for a string key).
//
// Bound: at q3's size (a few thousand rows, a 64-bit word per key) launch
// latency: three launches per 8-bit digit.  At scale each pass reads a
// word and an index and writes an index per row; a 16-byte string key
// takes three words, 24 passes.
#include "radix.cuh"

namespace {

using srt::kThreads;

enum KeyType : int32_t { kInt32 = 0, kInt64 = 1, kFloat64 = 2,
                         kDec128Hi = 3, kDec128Lo = 4 };

__global__ void __launch_bounds__(kThreads)
    sort_words(const void* __restrict__ data, int32_t type,
               const uint8_t* __restrict__ valid, int64_t n,
               int32_t ascending, int32_t nulls_first,
               uint64_t* __restrict__ rank_word,
               uint64_t* __restrict__ value_word) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const bool ok = valid == nullptr || valid[i] != 0;
    if (rank_word != nullptr)
      rank_word[i] = ok == static_cast<bool>(nulls_first) ? 1ULL : 0ULL;
    uint64_t w = 0;
    if (ok) {
      if (type == kInt32) {
        w = static_cast<uint64_t>(static_cast<uint32_t>(
                static_cast<const int32_t*>(data)[i])) ^ 0x80000000ULL;
      } else if (type == kInt64) {
        w = static_cast<uint64_t>(static_cast<const int64_t*>(data)[i]) ^
            0x8000000000000000ULL;
      } else if (type == kDec128Hi) {
        w = static_cast<uint64_t>(static_cast<const int64_t*>(data)[2 * i]) ^
            0x8000000000000000ULL;
      } else if (type == kDec128Lo) {
        w = static_cast<uint64_t>(
            static_cast<const int64_t*>(data)[2 * i + 1]);
      } else {
        double x = static_cast<const double*>(data)[i];
        if (x == 0.0) x = 0.0;
        const uint64_t u =
            isnan(x) ? 0x7ff8000000000000ULL
                     : static_cast<uint64_t>(__double_as_longlong(x));
        w = (u & 0x8000000000000000ULL) ? ~u : (u | 0x8000000000000000ULL);
      }
    }
    if (!ascending) w = type == kInt32 ? (~w & 0xffffffffULL) : ~w;
    value_word[i] = w;
  }
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    string_max_len(const Off* __restrict__ off, int64_t n,
                   unsigned long long* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  long long m = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const long long len =
        static_cast<long long>(off[i + 1]) - static_cast<long long>(off[i]);
    m = len > m ? len : m;
  }
  for (int d = 16; d > 0; d >>= 1) {
    const long long o = __shfl_down_sync(0xffffffffu, m, d);
    m = o > m ? o : m;
  }
  if ((threadIdx.x & 31) == 0 && m > 0)
    atomicMax(out, static_cast<unsigned long long>(m));
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    string_words(const Off* __restrict__ off,
                 const uint8_t* __restrict__ chars,
                 const uint8_t* __restrict__ valid, int64_t n,
                 int32_t n_words, int32_t ascending, int32_t nulls_first,
                 uint64_t* __restrict__ rank_word,
                 uint64_t* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const bool ok = valid == nullptr || valid[i] != 0;
    if (rank_word != nullptr)
      rank_word[i] = ok == static_cast<bool>(nulls_first) ? 1ULL : 0ULL;
    const int64_t s = static_cast<int64_t>(off[i]);
    const int64_t len = ok ? static_cast<int64_t>(off[i + 1]) - s : 0;
    for (int32_t w = 0; w < n_words; ++w) {
      uint64_t word = 0;
      for (int j = 0; j < 7; ++j) {
        const int64_t b = static_cast<int64_t>(w) * 7 + j;
        if (b < len)
          word |= static_cast<uint64_t>(chars[s + b] + 1) << (9 * (6 - j));
      }
      words[static_cast<int64_t>(w) * n + i] = ascending ? word : ~word;
    }
  }
}

}  // namespace

// *out = the longest string of the column (out: one int64 on the device).
extern "C" int srt_string_max_len(const void* offsets, int32_t off64,
                                  int64_t n, void* out, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* o = static_cast<unsigned long long*>(out);
  cudaError_t err = cudaMemsetAsync(o, 0, sizeof(unsigned long long), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  if (off64)
    string_max_len<int64_t><<<srt::grid_for(n), kThreads, 0, s>>>(
        static_cast<const int64_t*>(offsets), n, o);
  else
    string_max_len<int32_t><<<srt::grid_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(offsets), n, o);
  return static_cast<int>(cudaGetLastError());
}

// words: n_words * n uint64, word w of row i at words[w * n + i];
// rank_word and valid may be null.
extern "C" int srt_string_words(const void* offsets, int32_t off64,
                                const void* chars, const void* valid,
                                int64_t n, int32_t n_words,
                                int32_t ascending, int32_t nulls_first,
                                void* rank_word, void* words, void* stream) {
  if (n_words < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* c = static_cast<const uint8_t*>(chars);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  uint64_t* r = static_cast<uint64_t*>(rank_word);
  uint64_t* w = static_cast<uint64_t*>(words);
  if (off64)
    string_words<int64_t><<<srt::grid_for(n), kThreads, 0, s>>>(
        static_cast<const int64_t*>(offsets), c, v, n, n_words, ascending,
        nulls_first, r, w);
  else
    string_words<int32_t><<<srt::grid_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(offsets), c, v, n, n_words, ascending,
        nulls_first, r, w);
  return static_cast<int>(cudaGetLastError());
}

// rank_word may be null (the key holds no null); valid may be null.
extern "C" int srt_sort_words(const void* data, int32_t type,
                              const void* valid, int64_t n,
                              int32_t ascending, int32_t nulls_first,
                              void* rank_word, void* value_word,
                              void* stream) {
  if (type < kInt32 || type > kDec128Lo)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  sort_words<<<srt::grid_for(n), kThreads, 0,
               static_cast<cudaStream_t>(stream)>>>(
      data, type, static_cast<const uint8_t*>(valid), n, ascending,
      nulls_first, static_cast<uint64_t*>(rank_word),
      static_cast<uint64_t*>(value_word));
  return static_cast<int>(cudaGetLastError());
}

// words: n_words device pointers (most significant first); bits: the
// significant low bits of each.  Scratch as srt::radix_sort says.
extern "C" int srt_sort_perm(const void* const* words, const int32_t* bits,
                             int32_t n_words, int64_t n, void* perm_out,
                             void* perm_tmp, void* hist, void* digit_total,
                             void* stream) {
  if (n_words < 0 || n_words > 64 || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const uint64_t* w[64];
  int b[64];
  for (int j = 0; j < n_words; ++j) {
    w[j] = static_cast<const uint64_t*>(words[j]);
    b[j] = bits[j];
  }
  return static_cast<int>(srt::radix_sort(
      w, b, n_words, n, static_cast<long long*>(perm_out),
      static_cast<long long*>(perm_tmp), static_cast<int32_t*>(hist),
      static_cast<int64_t*>(digit_total),
      static_cast<cudaStream_t>(stream)));
}
