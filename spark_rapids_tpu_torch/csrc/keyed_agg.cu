// Kernel K9: keyed (GROUP BY) aggregation through a hash table.
//
// Replaces the keyed form of the JAX package's `fused.agg_update`
// (spark_rapids_tpu/exec/fused.py:337 _fused_update, built :410, through
// ops/agg_ops.py:390 keyed_agg_trace with _segment_reduce :52 and
// _masked_group_words :38), which sorts rows by their key words and
// reduces segments because XLA has no hash tables.
//
// Keys: up to 8 columns of int, date, long, double or string (keys.cuh);
// a null is a value of its own, so nulls form their own group, and a
// double key groups -0.0 with 0.0 and every NaN together.
// Aggregates: up to 32 of min, max, first, last (below), long sum (int or
// long input, wrapping; a decimal64 sum is this kind over its unscaled
// int64 values, as _segment_reduce sums them), decimal128 sum (a
// decimal64 or decimal128 input summed as __int128, wrapping mod 2^128 as
// the JAX package's limb sums do, ops/agg_ops.py:62-77; [groups, 2]
// (hi, lo) out), double
// sum (of a double input, or of an int or long one converted row by row:
// an average's sum), count of valid inputs, count of rows, and m2 (the
// variance family's sum of squared deviations from the group's mean over
// its present values converted to double, ops/agg_ops.py:490-502: the
// mean first, then the squares, two passes over the group's rows, so a
// large mean costs no precision as a one-pass form would; 0 for a group
// with no present value, valid as the JAX package's buffer is).
// Merge kinds (a FINAL aggregate over partial buffers, the JAX package's
// merge specs, ops/agg_ops.py:340, and fused.agg_merge_final,
// exec/fused.py:468): sums of sums and of counts are the sum kinds over
// buffer columns; the joint Chan merge of (n, mean, m2) triples
// (ops/agg_ops.py:466-487) is two kinds over the triple's columns (aux_n
// and aux_mean beside the kind's own): over the rows whose n is present,
// n = sum n_i, mean = sum n_i mean_i / n (0 when n is 0), m2 = sum (m2_i +
// n_i (mean_i - mean)^2), the mean first and then the sum, in row order;
// both always valid, as the JAX package writes them.
// Min and max (ops/agg_ops.py:82-109 _segment_reduce) of an int, date,
// long or double input, written in the input's type: a double is
// compared by its bits mapped to an int64 that orders as the double does
// (f64_order: -0.0 below 0.0, as the JAX device path's segment_min and
// segment_max give them), NaN kept apart as a flag (Spark: NaN is greater
// than every value; min is NaN only when every present value is).
// First and last (:110-125) take the group's first or last row in row
// order (step 4 keeps each group's rows in row order), the _valid kinds
// its first or last present row; a fixed-width input's value is copied
// bit for bit, and for a string input (:134 _lengths_reduce) the kernel
// writes the row, or -1 for a null, which the caller gathers (K7).  The
// same kinds merge a FINAL aggregate's buffer rows in the order the
// exchange gave them.  A group with no present value of a min or max, or
// no row of a _valid kind, is null and holds 0.
//
// Steps (srt_agg_groups, then the host reads the group count -- the one
// sync -- then srt_agg_reduce):
//   1. hash each row's keys (keys.cuh row_hash);
//   2. insert every row into an open-addressing table (a power of two >=
//      2 * rows slots): a row claims an empty slot by atomicCAS or stops at
//      the slot of a row with equal keys -- equal hashes, then keys.cuh
//      keys_equal, so two keys whose hashes collide stay two groups;
//      atomicMin leaves each group's first row in rep[slot];
//   3. a group's id is the exclusive scan of "row is its group's first
//      row", so groups are numbered in order of first appearance whatever
//      order the rows won their slots in;
//   4. rows are ordered by group id with the stable radix sort
//      (radix.cuh), so each group's rows lie together in row order;
//   5. one thread per group folds its rows in row order: the double sums
//      and m2 do not depend on timing, and equal those of a sequential
//      sum in row order.
// The caller gathers the key columns through group_rep (K7), and a string
// first/last through its rows; gid, each row's group id, is there for
// K15d (distinct.cu) over the same groups.
//
// Bound: at the main path's size (about ten thousand rows into a few
// thousand groups) launch latency; at scale each row is read a few times
// (hash, insert, assign, sort passes, fold).
#include "decimal.cuh"
#include "keys.cuh"
#include "radix.cuh"

namespace {

using srt::f64_order;
using srt::Keys;
using srt::kThreads;

constexpr int kMaxAggs = 32;
constexpr long long kEmpty = -1;

enum AggKind : int32_t { kSumI64 = 0, kSumF64 = 1, kCount = 2,
                         kCountAll = 3, kM2 = 4, kChanMean = 5,
                         kChanM2 = 6, kMin = 7, kMax = 8, kFirst = 9,
                         kLast = 10, kFirstValid = 11, kLastValid = 12,
                         kSumDec128 = 13 };
enum InType : int32_t { kInInt32 = 0, kInInt64 = 1, kInFloat64 = 2,
                        kInString = 3, kInDec128 = 4 };
constexpr long long kNanBits = 0x7ff8000000000000LL;

struct Aggs {
  int32_t n;
  int32_t kind[kMaxAggs];
  int32_t in_type[kMaxAggs];
  const void* data[kMaxAggs];
  const uint8_t* valid[kMaxAggs];
  void* out[kMaxAggs];
  uint8_t* out_valid[kMaxAggs];
  // a Chan merge kind's n and mean columns (doubles)
  const double* aux_n[kMaxAggs];
  const uint8_t* aux_n_valid[kMaxAggs];
  const double* aux_mean[kMaxAggs];
  const uint8_t* aux_mean_valid[kMaxAggs];
};

__global__ void __launch_bounds__(kThreads)
    agg_hash(Keys k, int64_t n, uint64_t* __restrict__ h) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    h[i] = srt::row_hash(k, i);
}

__global__ void __launch_bounds__(kThreads)
    agg_clear(long long* slots, long long* rep, int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += stride) {
    slots[i] = kEmpty;
    rep[i] = 0x7fffffffffffffffLL;
  }
}

__global__ void __launch_bounds__(kThreads)
    agg_insert(Keys k, int64_t n, const uint64_t* __restrict__ h,
               long long* slots, uint64_t mask, long long* slot_of,
               long long* rep) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const uint64_t hi = h[i];
    uint64_t s = hi & mask;
    while (true) {
      long long cur = *reinterpret_cast<volatile long long*>(&slots[s]);
      if (cur == kEmpty) {
        const unsigned long long prev = atomicCAS(
            reinterpret_cast<unsigned long long*>(&slots[s]),
            static_cast<unsigned long long>(kEmpty),
            static_cast<unsigned long long>(i));
        if (prev == static_cast<unsigned long long>(kEmpty)) break;
        cur = static_cast<long long>(prev);
      }
      if (h[cur] == hi && srt::keys_equal(k, cur, i)) break;
      s = (s + 1) & mask;
    }
    slot_of[i] = static_cast<long long>(s);
    atomicMin(&rep[s], static_cast<long long>(i));
  }
}

// 1 where a row is its group's first row
struct FirstOfGroup {
  const long long* slot_of;
  const long long* rep;
  __device__ __forceinline__ long long operator()(int64_t i) const {
    return rep[slot_of[i]] == i ? 1 : 0;
  }
};

__global__ void __launch_bounds__(kThreads)
    agg_assign(int64_t n, const long long* __restrict__ slot_of,
               const long long* __restrict__ rep,
               const int64_t* __restrict__ rank, uint64_t* __restrict__ gid,
               long long* __restrict__ group_rep,
               int64_t* __restrict__ group_count) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const long long first = rep[slot_of[i]];
    const int64_t g = rank[first];
    gid[i] = static_cast<uint64_t>(g);
    if (first == i) group_rep[g] = i;
    atomicAdd(reinterpret_cast<unsigned long long*>(&group_count[g]), 1ULL);
  }
}

__device__ __forceinline__ bool agg_present(const Aggs& a, int j,
                                            int64_t r) {
  return a.valid[j] == nullptr || a.valid[j][r] != 0;
}

// input j of row r as a double (an int or long converts)
__device__ __forceinline__ double agg_double(const Aggs& a, int j,
                                            int64_t r) {
  return a.in_type[j] == kInFloat64
             ? static_cast<const double*>(a.data[j])[r]
         : a.in_type[j] == kInInt32
             ? static_cast<double>(static_cast<const int32_t*>(a.data[j])[r])
             : static_cast<double>(
                   static_cast<const long long*>(a.data[j])[r]);
}

// m2 of aggregate j over the group's rows perm[lo..hi): the mean, then the
// sum of squared deviations from it
__device__ double agg_m2(const Aggs& a, int j, int64_t lo, int64_t hi,
                         const long long* __restrict__ perm) {
  double s = 0.0;
  long long cnt = 0;
  for (int64_t p = lo; p < hi; ++p) {
    const long long r = perm[p];
    if (!agg_present(a, j, r)) continue;
    s += agg_double(a, j, r);
    ++cnt;
  }
  if (cnt == 0) return 0.0;
  const double mean = s / static_cast<double>(cnt);
  double m2 = 0.0;
  for (int64_t p = lo; p < hi; ++p) {
    const long long r = perm[p];
    if (!agg_present(a, j, r)) continue;
    const double d = agg_double(a, j, r) - mean;
    m2 += d * d;
  }
  return m2;
}

// the Chan merge of aggregate j over the group's rows perm[lo..hi): its
// mean, or its m2
__device__ double agg_chan(const Aggs& a, int j, int64_t lo, int64_t hi,
                           const long long* __restrict__ perm) {
  double tot = 0.0, wsum = 0.0;
  for (int64_t p = lo; p < hi; ++p) {
    const long long r = perm[p];
    if (a.aux_n_valid[j] != nullptr && a.aux_n_valid[j][r] == 0) continue;
    const double ni = a.aux_n[j][r];
    const double mi = a.aux_mean_valid[j] == nullptr ||
                              a.aux_mean_valid[j][r] != 0
                          ? a.aux_mean[j][r]
                          : 0.0;
    tot += ni;
    wsum += ni * mi;
  }
  const double mean = tot > 0.0 ? wsum / tot : 0.0;
  if (a.kind[j] == kChanMean) return mean;
  double m2 = 0.0;
  for (int64_t p = lo; p < hi; ++p) {
    const long long r = perm[p];
    if (a.aux_n_valid[j] != nullptr && a.aux_n_valid[j][r] == 0) continue;
    const double ni = a.aux_n[j][r];
    const double mi = a.aux_mean_valid[j] == nullptr ||
                              a.aux_mean_valid[j][r] != 0
                          ? a.aux_mean[j][r]
                          : 0.0;
    const double m2i = agg_present(a, j, r)
                           ? static_cast<const double*>(a.data[j])[r]
                           : 0.0;
    const double d = mi - mean;
    m2 += m2i + ni * d * d;
  }
  return m2;
}

// input j of row r as an int64 word: an int widened, a long as it is, a
// double's bits
__device__ __forceinline__ long long agg_word(const Aggs& a, int j,
                                              int64_t r) {
  return a.in_type[j] == kInInt32
             ? static_cast<long long>(
                   static_cast<const int32_t*>(a.data[j])[r])
             : static_cast<const long long*>(a.data[j])[r];
}

// writes word w (in the input's type) as group g's output of aggregate j
__device__ __forceinline__ void agg_store(const Aggs& a, int j, int64_t g,
                                          long long w) {
  if (a.in_type[j] == kInInt32)
    static_cast<int32_t*>(a.out[j])[g] = static_cast<int32_t>(w);
  else
    static_cast<long long*>(a.out[j])[g] = w;
}

// min or max of aggregate j over the group's rows perm[lo..hi)
__device__ void agg_min_max(const Aggs& a, int j, int64_t g, int64_t lo,
                            int64_t hi, const long long* __restrict__ perm) {
  const bool is_min = a.kind[j] == kMin;
  const bool dbl = a.in_type[j] == kInFloat64;
  long long best = is_min ? 0x7fffffffffffffffLL : (-0x7fffffffffffffffLL - 1);
  bool any = false, nan = false, num = false;
  for (int64_t p = lo; p < hi; ++p) {
    const long long r = perm[p];
    if (!agg_present(a, j, r)) continue;
    any = true;
    long long w = agg_word(a, j, r);
    if (dbl) {
      if (isnan(__longlong_as_double(w))) {
        nan = true;
        continue;
      }
      num = true;
      w = f64_order(w);
    }
    best = is_min ? (w < best ? w : best) : (w > best ? w : best);
  }
  long long out = 0;
  if (any) {
    if (!dbl)
      out = best;
    else if (is_min ? !num : nan)
      out = kNanBits;
    else
      out = f64_order(best);
  }
  agg_store(a, j, g, out);
  a.out_valid[j][g] = any ? 1 : 0;
}

// first or last (present) row of aggregate j over the group's rows
// perm[lo..hi), in row order
__device__ void agg_pick(const Aggs& a, int j, int64_t g, int64_t lo,
                         int64_t hi, const long long* __restrict__ perm) {
  const int kind = a.kind[j];
  const bool valid_only = kind == kFirstValid || kind == kLastValid;
  long long row = -1;
  if (kind == kFirst || kind == kFirstValid) {
    for (int64_t p = lo; p < hi; ++p)
      if (!valid_only || agg_present(a, j, perm[p])) {
        row = perm[p];
        break;
      }
  } else {
    for (int64_t p = hi - 1; p >= lo; --p)
      if (!valid_only || agg_present(a, j, perm[p])) {
        row = perm[p];
        break;
      }
  }
  const bool ok = row >= 0 && agg_present(a, j, row);
  if (a.in_type[j] == kInString)
    static_cast<long long*>(a.out[j])[g] = ok ? row : -1;
  else
    agg_store(a, j, g, row >= 0 ? agg_word(a, j, row) : 0);
  a.out_valid[j][g] = ok ? 1 : 0;
}

// decimal128 sum of aggregate j over the group's rows perm[lo..hi), in
// row order (wrapping); null for a group with no present value
__device__ void agg_sum_dec128(const Aggs& a, int j, int64_t g, int64_t lo,
                               int64_t hi, const long long* __restrict__ perm) {
  srt::u128 acc = 0;
  bool any = false;
  const int64_t* data = static_cast<const int64_t*>(a.data[j]);
  for (int64_t p = lo; p < hi; ++p) {
    const long long r = perm[p];
    if (!agg_present(a, j, r)) continue;
    any = true;
    acc += static_cast<srt::u128>(a.in_type[j] == kInDec128
                                      ? srt::load_i128(data, r)
                                      : static_cast<srt::i128>(data[r]));
  }
  srt::store_i128(static_cast<int64_t*>(a.out[j]), g,
                  static_cast<srt::i128>(acc));
  a.out_valid[j][g] = any ? 1 : 0;
}

__global__ void __launch_bounds__(kThreads)
    agg_fold(Aggs a, int64_t n_groups, const int64_t* __restrict__ seg,
             const long long* __restrict__ perm) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       g < n_groups; g += stride) {
    const int64_t lo = seg[g];
    const int64_t hi = seg[g + 1];
    for (int j = 0; j < a.n; ++j) {
      const int kind = a.kind[j];
      if (kind == kM2) {
        static_cast<double*>(a.out[j])[g] = agg_m2(a, j, lo, hi, perm);
        a.out_valid[j][g] = 1;
        continue;
      }
      if (kind == kChanMean || kind == kChanM2) {
        static_cast<double*>(a.out[j])[g] = agg_chan(a, j, lo, hi, perm);
        a.out_valid[j][g] = 1;
        continue;
      }
      if (kind == kMin || kind == kMax) {
        agg_min_max(a, j, g, lo, hi, perm);
        continue;
      }
      if (kind == kSumDec128) {
        agg_sum_dec128(a, j, g, lo, hi, perm);
        continue;
      }
      if (kind >= kFirst) {
        agg_pick(a, j, g, lo, hi, perm);
        continue;
      }
      unsigned long long u = 0;
      double f = 0.0;
      long long cnt = 0;
      for (int64_t p = lo; p < hi; ++p) {
        const long long r = perm[p];
        if (kind == kCountAll) {
          ++cnt;
          continue;
        }
        if (!agg_present(a, j, r)) continue;
        ++cnt;
        if (kind == kSumF64) {
          f += agg_double(a, j, r);  // an int or long converts row by row
        } else if (kind == kSumI64) {
          u += a.in_type[j] == kInInt32
                   ? static_cast<unsigned long long>(static_cast<long long>(
                         static_cast<const int32_t*>(a.data[j])[r]))
                   : static_cast<unsigned long long>(
                         static_cast<const long long*>(a.data[j])[r]);
        }
      }
      if (kind == kSumF64) {
        static_cast<double*>(a.out[j])[g] = f;
      } else if (kind == kSumI64) {
        static_cast<long long*>(a.out[j])[g] = static_cast<long long>(u);
      } else {
        static_cast<long long*>(a.out[j])[g] = cnt;
      }
      a.out_valid[j][g] =
          (kind == kCount || kind == kCountAll || cnt > 0) ? 1 : 0;
    }
  }
}

}  // namespace

// Scratch and outputs, n = rows, T = table_size (a power of two >= 2n):
// hashes (n u64), slots (T), rep (T), slot_of (n), rank (n + 1 int64),
// tile_scratch (srt::tiles_for(n)).  After the call rank[n] holds the
// number of groups.
extern "C" int srt_agg_groups(int32_t n_keys, const int32_t* type,
                              const int32_t* off64, const void* const* data,
                              const void* const* valid,
                              const void* const* offsets, int64_t n,
                              void* hashes, void* slots, void* rep,
                              int64_t table_size, void* slot_of, void* rank,
                              void* tile_scratch, void* stream) {
  if (n_keys < 1 || n_keys > srt::kMaxKeys || n < 0 || table_size <= 0 ||
      (table_size & (table_size - 1)) != 0 || table_size < 2 * n)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_keys; ++c)
    if (!srt::valid_key_type(type[c]))
      return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0)
    return static_cast<int>(
        cudaMemsetAsync(rank, 0, sizeof(int64_t), s));
  const Keys k = srt::make_keys(n_keys, type, off64, data, valid, offsets);
  long long* sl = static_cast<long long*>(slots);
  long long* rp = static_cast<long long*>(rep);
  long long* so = static_cast<long long*>(slot_of);
  uint64_t* h = static_cast<uint64_t*>(hashes);
  agg_hash<<<srt::grid_for(n), kThreads, 0, s>>>(k, n, h);
  agg_clear<<<srt::grid_for(table_size), kThreads, 0, s>>>(sl, rp,
                                                           table_size);
  agg_insert<<<srt::grid_for(n), kThreads, 0, s>>>(
      k, n, h, sl, static_cast<uint64_t>(table_size - 1), so, rp);
  return static_cast<int>(srt::exclusive_scan(
      FirstOfGroup{so, rp}, n, static_cast<int64_t*>(rank),
      static_cast<int64_t*>(tile_scratch), s));
}

// Outputs: group_rep (n_groups int64), gid (n u64: each row's group), each
// aggregate's out (n_groups words) and out_valid (n_groups bytes).  A Chan
// merge kind reads aux_n[j] and aux_mean[j] (doubles, with their validity:
// null for none) beside data[j]; other kinds leave them null.
// Scratch:
// group_count (n_groups int64), seg (n_groups + 1), perm and perm_tmp (n),
// hist (256 * ceil(n / 256) int32), digit_total (256), tile_scratch
// (srt::tiles_for(n_groups)).
extern "C" int srt_agg_reduce(int32_t n_aggs, const int32_t* kind,
                              const int32_t* in_type, const void* const* data,
                              const void* const* valid, void* const* out,
                              void* const* out_valid,
                              const void* const* aux_n,
                              const void* const* aux_n_valid,
                              const void* const* aux_mean,
                              const void* const* aux_mean_valid, int64_t n,
                              int64_t n_groups, const void* slot_of,
                              const void* rep, const void* rank, void* gid,
                              void* group_rep, void* group_count, void* seg,
                              void* perm, void* perm_tmp, void* hist,
                              void* digit_total, void* tile_scratch,
                              void* stream) {
  if (n_aggs < 0 || n_aggs > kMaxAggs || n_groups < 0 || n_groups > n)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_groups == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  Aggs a;
  a.n = n_aggs;
  for (int j = 0; j < n_aggs; ++j) {
    // a decimal128 input is the decimal128 sum's alone, which also takes
    // a decimal64 (int64) input
    const bool wide_in = in_type[j] == kInDec128;
    if (kind[j] < kSumI64 || kind[j] > kSumDec128 ||
        in_type[j] < kInInt32 || in_type[j] > kInDec128 ||
        (in_type[j] == kInString && kind[j] < kFirst) ||
        (wide_in && kind[j] != kSumDec128) ||
        (kind[j] == kSumDec128 && !wide_in && in_type[j] != kInInt64))
      return static_cast<int>(cudaErrorInvalidValue);
    const bool chan = kind[j] == kChanMean || kind[j] == kChanM2;
    if (chan && (aux_n[j] == nullptr || aux_mean[j] == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    a.aux_n[j] = chan ? static_cast<const double*>(aux_n[j]) : nullptr;
    a.aux_n_valid[j] =
        chan ? static_cast<const uint8_t*>(aux_n_valid[j]) : nullptr;
    a.aux_mean[j] = chan ? static_cast<const double*>(aux_mean[j]) : nullptr;
    a.aux_mean_valid[j] =
        chan ? static_cast<const uint8_t*>(aux_mean_valid[j]) : nullptr;
    a.kind[j] = kind[j];
    a.in_type[j] = in_type[j];
    a.data[j] = data[j];
    a.valid[j] = static_cast<const uint8_t*>(valid[j]);
    a.out[j] = out[j];
    a.out_valid[j] = static_cast<uint8_t*>(out_valid[j]);
  }
  int64_t* counts = static_cast<int64_t*>(group_count);
  cudaError_t err = cudaMemsetAsync(counts, 0, n_groups * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  agg_assign<<<srt::grid_for(n), kThreads, 0, s>>>(
      n, static_cast<const long long*>(slot_of),
      static_cast<const long long*>(rep), static_cast<const int64_t*>(rank),
      static_cast<uint64_t*>(gid), static_cast<long long*>(group_rep),
      counts);
  // no aggregate to fold (a group-by of count(DISTINCT) alone): the group
  // ids and first rows are all the caller needs
  if (n_aggs == 0) return static_cast<int>(cudaGetLastError());
  int64_t* sg = static_cast<int64_t*>(seg);
  err = srt::exclusive_scan(srt::ArrayValues{counts}, n_groups, sg,
                            static_cast<int64_t*>(tile_scratch), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  int bits = 1;
  while (bits < 63 && (int64_t{1} << bits) < n_groups) ++bits;
  const uint64_t* words[1] = {static_cast<const uint64_t*>(gid)};
  err = srt::radix_sort(words, &bits, 1, n, static_cast<long long*>(perm),
                        static_cast<long long*>(perm_tmp),
                        static_cast<int32_t*>(hist),
                        static_cast<int64_t*>(digit_total), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  agg_fold<<<srt::grid_for(n_groups), kThreads, 0, s>>>(
      a, n_groups, sg, static_cast<const long long*>(perm));
  return static_cast<int>(cudaGetLastError());
}
