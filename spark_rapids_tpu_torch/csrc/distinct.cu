// Kernel K15d: count(DISTINCT value) per group through a hash set.
//
// Replaces the distinct form of the JAX package's collect programs
// `agg.collect_phase1` and `agg.collect_phase2` (spark_rapids_tpu/ops/
// agg_ops.py:550 and :646, through segmented_collect_many :530), which sort
// the rows by (group key words, value words), flag the first row of each
// run of equal values and size each group's set, and `agg.segmented`
// (:340) beside them for the scalar slots; the JAX plan runs them behind
// count(DISTINCT ...) in exec/aggregate.py:510 _complete_collect.  On the
// card the distinct set is an open-addressing hash set over
// (group id, value): no sort, and the set's members are never written out,
// since only their number is wanted.
//
// Value: one column of int, date, long, double or string (keys.cuh), with
// its validity plane; a null value is not counted.  Equality and hashing
// are keys.cuh's, so -0.0 equals 0.0, every NaN is one value and strings
// compare byte for byte.  Group ids: int64 per row in [0, n_groups), from
// K9's grouping (groups in first-appearance order), or none: one group.
//
// Steps: 1. each row with a present value hashes (group id, value);
// 2. each such row inserts itself into a table of a power of two >= 2 *
// rows slots: it claims an empty slot by atomicCAS, or stops at the slot of
// a row with the same hash, group and value; 3. a row that claimed a slot
// is its (group, value)'s first insertion and counts one for its group:
// the lanes of a warp that share a group add their first insertions with
// one atomicAdd of an integer, so the count is exact and the same on every
// run, whichever row wins.  Every row is its own thread: a group of 2^20
// rows spreads over the whole card, and no group is folded on one thread.
//
// Bound: device memory bytes.  The value (and the group id) is read twice,
// the hash written and read once, and the table touched about twice per
// row; the counts are n_groups words.
#include "keys.cuh"

namespace {

using srt::Keys;
using srt::kThreads;

constexpr long long kEmpty = -1;
constexpr uint64_t kGroupMul = 0x9e3779b97f4a7c15ULL;

__device__ __forceinline__ long long group_of(const long long* gid,
                                              int64_t i) {
  return gid == nullptr ? 0 : gid[i];
}

__global__ void __launch_bounds__(kThreads)
    distinct_hash(Keys k, const long long* __restrict__ gid, int64_t n,
                  uint64_t* __restrict__ h) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (!srt::key_present(k, 0, i)) continue;
    const uint64_t g = static_cast<uint64_t>(group_of(gid, i));
    h[i] = srt::fmix64(srt::row_hash(k, i) ^ (g * kGroupMul));
  }
}

__global__ void __launch_bounds__(kThreads)
    distinct_clear(long long* slots, int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += stride)
    slots[i] = kEmpty;
}

// Rows are taken a warp at a time (32 consecutive rows), so the warp's
// first insertions can be counted together: the lanes of one group add
// their number with one atomic, which keeps a one-group count (the global
// case) from serialising every row on one address.
__global__ void __launch_bounds__(kThreads)
    distinct_insert(Keys k, const long long* __restrict__ gid, int64_t n,
                    const uint64_t* __restrict__ h, long long* slots,
                    uint64_t mask, unsigned long long* counts) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       base < n; base += stride) {
    const int64_t i = base + lane;
    bool first = false;
    long long g = -1;
    if (i < n && srt::key_present(k, 0, i)) {
      const uint64_t hi = h[i];
      g = group_of(gid, i);
      uint64_t s = hi & mask;
      while (true) {
        long long cur = *reinterpret_cast<volatile long long*>(&slots[s]);
        if (cur == kEmpty) {
          const unsigned long long prev = atomicCAS(
              reinterpret_cast<unsigned long long*>(&slots[s]),
              static_cast<unsigned long long>(kEmpty),
              static_cast<unsigned long long>(i));
          if (prev == static_cast<unsigned long long>(kEmpty)) {
            first = true;   // the first insertion of (g, value)
            break;
          }
          cur = static_cast<long long>(prev);
        }
        if (h[cur] == hi && group_of(gid, cur) == g &&
            srt::keys_equal(k, cur, i))
          break;
        s = (s + 1) & mask;
      }
    }
    __syncwarp();
    // lanes of one group, and those of them that inserted first
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    const unsigned firsts = __ballot_sync(0xffffffffu, first) & peers;
    if (firsts != 0 && lane == __ffs(peers) - 1)
      atomicAdd(&counts[g], static_cast<unsigned long long>(__popc(firsts)));
  }
}

}  // namespace

// value: type (keys.cuh KeyType), off64 (a string's offsets are int64),
// data, valid (null: every value present), offsets (strings).  gid: n
// int64 group ids, or null for one group.  Scratch: hashes (n u64), slots
// (table_size int64, a power of two >= 2n).  Output: counts (n_groups
// int64), zeroed here.
extern "C" int srt_count_distinct(int32_t type, int32_t off64,
                                  const void* data, const void* valid,
                                  const void* offsets, const void* gid,
                                  int64_t n, int64_t n_groups, void* hashes,
                                  void* slots, int64_t table_size,
                                  void* counts, void* stream) {
  if (!srt::valid_key_type(type) || n < 0 || n_groups < 1 ||
      table_size <= 0 || (table_size & (table_size - 1)) != 0 ||
      table_size < 2 * n || (gid == nullptr && n_groups != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(counts, 0, n_groups * sizeof(int64_t), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  const void* datas[1] = {data};
  const void* valids[1] = {valid};
  const void* offs[1] = {offsets};
  const Keys k = srt::make_keys(1, &type, &off64, datas, valids, offs);
  const long long* g = static_cast<const long long*>(gid);
  uint64_t* h = static_cast<uint64_t*>(hashes);
  long long* sl = static_cast<long long*>(slots);
  distinct_hash<<<srt::grid_for(n), kThreads, 0, s>>>(k, g, n, h);
  distinct_clear<<<srt::grid_for(table_size), kThreads, 0, s>>>(sl,
                                                                table_size);
  distinct_insert<<<srt::grid_for(n), kThreads, 0, s>>>(
      k, g, n, h, sl, static_cast<uint64_t>(table_size - 1),
      static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}
