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
// Aggregates: up to 16 of long sum (int or long input, wrapping), double
// sum (of a double input, or of an int or long one converted row by row:
// an average's sum), count of valid inputs, count of rows, and m2 (the
// variance family's sum of squared deviations from the group's mean over
// its present values converted to double, ops/agg_ops.py:490-502: the
// mean first, then the squares, two passes over the group's rows, so a
// large mean costs no precision as a one-pass form would; 0 for a group
// with no present value, valid as the JAX package's buffer is).
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
// The caller gathers the key columns through group_rep (K7); gid, each
// row's group id, is there for K15d (distinct.cu) over the same groups.
//
// Bound: at the main path's size (about ten thousand rows into a few
// thousand groups) launch latency; at scale each row is read a few times
// (hash, insert, assign, sort passes, fold).
#include "keys.cuh"
#include "radix.cuh"

namespace {

using srt::Keys;
using srt::kThreads;

constexpr int kMaxAggs = 16;
constexpr long long kEmpty = -1;

enum AggKind : int32_t { kSumI64 = 0, kSumF64 = 1, kCount = 2,
                         kCountAll = 3, kM2 = 4 };
enum InType : int32_t { kInInt32 = 0, kInInt64 = 1, kInFloat64 = 2 };

struct Aggs {
  int32_t n;
  int32_t kind[kMaxAggs];
  int32_t in_type[kMaxAggs];
  const void* data[kMaxAggs];
  const uint8_t* valid[kMaxAggs];
  void* out[kMaxAggs];
  uint8_t* out_valid[kMaxAggs];
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
// aggregate's out (n_groups words) and out_valid (n_groups bytes).
// Scratch:
// group_count (n_groups int64), seg (n_groups + 1), perm and perm_tmp (n),
// hist (256 * ceil(n / 256) int32), digit_total (256), tile_scratch
// (srt::tiles_for(n_groups)).
extern "C" int srt_agg_reduce(int32_t n_aggs, const int32_t* kind,
                              const int32_t* in_type, const void* const* data,
                              const void* const* valid, void* const* out,
                              void* const* out_valid, int64_t n,
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
    if (kind[j] < kSumI64 || kind[j] > kM2)
      return static_cast<int>(cudaErrorInvalidValue);
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
