// Kernel K15: collect_list and collect_set per group, into an array
// column (int64 offsets of n_groups + 1 entries and an element plane).
//
// Replaces the JAX package's collect programs `agg.collect_phase1` and
// `agg.collect_phase2` (spark_rapids_tpu/ops/agg_ops.py:550 and :646,
// through segmented_collect_many :530), which sort the rows by (group key
// words, value words), flag the first row of each run of equal values for
// a set, and scatter each group's values into a padded [groups, max width]
// plane sized by one read of the widest group: a static-shape form for the
// TPU.  Here the output is sized exactly.
//
// Inputs: one value column of 1, 4 or 8-byte values (bool; int or date;
// long, decimal64 or double) with its validity, and the int64 group id of
// each row in [0, n_groups) (K9's grouping), or none: one group.  A null
// value is skipped.  Each present value becomes a 64-bit word that equal
// values share: a bool or int widened, a double's bits with -0.0 as 0.0
// and every NaN as one NaN (keys.cuh's equality).
//
// Steps (srt_collect_count, then srt_collect_write):
//   1. set mode: the distinct (group, word) pairs through an open-
//      addressing hash set of a power of two >= 2n slots, as K15d's
//      (distinct.cu): a row claims an empty slot by atomicCAS or finds the
//      slot of its pair, and lowers the slot to its own row by atomicMin,
//      so each pair ends with its least row; a row is kept when it is its
//      pair's slot row.  List mode keeps every present row.
//   2. one count per group of its kept rows (the lanes of a warp that
//      share a group add with one integer atomic: exact), then the tiled
//      scan of the counts into offsets, the total after them; the host
//      reads the total (one counted read) to size the element plane;
//   3. a stable LSD radix sort (radix.cuh) of the rows by group id, the
//      rows not kept after every group, so each group's elements come out
//      in row order, then one gather of the kept rows' values (their own
//      bits: a set keeps its least row's -0.0 or 0.0, NaN payload).
// So collect_list keeps row order, as both JAX engines do, and collect_set
// gives first-seen order, as the JAX CPU engine's Arrow hash_distinct does
// (the JAX device path sorts a set by value; Spark leaves it unspecified).
//
// Bound: device memory bytes.  The values, validity and group ids are read
// about twice (the words, then the counts and the sort), the table touched
// about twice a row in set mode, each radix pass reads a word and an index
// and writes an index a row, and the elements are written once.
#include "radix.cuh"

namespace {

using srt::kThreads;

constexpr long long kEmpty = -1;
constexpr uint64_t kGroupMul = 0x9e3779b97f4a7c15ULL;

__device__ __forceinline__ long long group_of(const long long* gid,
                                              int64_t i) {
  return gid == nullptr ? 0 : gid[i];
}

__device__ __forceinline__ bool present_at(const uint8_t* valid,
                                           int64_t i) {
  return valid == nullptr || valid[i] != 0;
}

// the word equal values share
__global__ void __launch_bounds__(kThreads)
    collect_words(const void* __restrict__ data, int32_t width,
                  int32_t is_double, int64_t n,
                  uint64_t* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    uint64_t w;
    if (width == 1) {
      w = static_cast<const uint8_t*>(data)[i] != 0;
    } else if (width == 4) {
      w = static_cast<uint64_t>(static_cast<long long>(
          static_cast<const int32_t*>(data)[i]));
    } else if (is_double) {
      const double x = static_cast<const double*>(data)[i];
      w = x == 0.0 ? 0ULL
                   : isnan(x) ? 0x7ff8000000000000ULL
                              : static_cast<uint64_t>(__double_as_longlong(x));
    } else {
      w = static_cast<const uint64_t*>(data)[i];
    }
    words[i] = w;
  }
}

__global__ void __launch_bounds__(kThreads)
    collect_clear(long long* slots, int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += stride)
    slots[i] = kEmpty;
}

__global__ void __launch_bounds__(kThreads)
    collect_insert(const uint64_t* __restrict__ words,
                   const uint8_t* __restrict__ valid,
                   const long long* __restrict__ gid, int64_t n,
                   long long* slots, uint64_t mask,
                   long long* __restrict__ slot_of) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (!present_at(valid, i)) continue;
    const uint64_t w = words[i];
    const long long g = group_of(gid, i);
    uint64_t s = srt::fmix64(w ^ (static_cast<uint64_t>(g) * kGroupMul)) &
                 mask;
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
      // every row a slot ever holds has the slot's (group, word)
      if (words[cur] == w && group_of(gid, cur) == g) {
        if (i < cur) atomicMin(&slots[s], static_cast<long long>(i));
        break;
      }
      s = (s + 1) & mask;
    }
    slot_of[i] = static_cast<long long>(s);
  }
}

// kept rows: present, and in set mode their pair's least row; each adds
// one to its group's count (warp peers of one group with one atomic)
__global__ void __launch_bounds__(kThreads)
    collect_keep_count(const uint8_t* __restrict__ valid,
                       const long long* __restrict__ gid, int64_t n,
                       const long long* __restrict__ slots,
                       const long long* __restrict__ slot_of,
                       uint8_t* __restrict__ keep,
                       unsigned long long* counts) {
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                      (threadIdx.x & ~31);
       base < n; base += stride) {
    const int64_t i = base + lane;
    bool kept = false;
    long long g = -1;
    if (i < n) {
      kept = present_at(valid, i) &&
             (slots == nullptr || slots[slot_of[i]] == i);
      keep[i] = kept ? 1 : 0;
      if (kept) g = group_of(gid, i);
    }
    __syncwarp();
    const unsigned peers = __match_any_sync(0xffffffffu, g);
    if (g >= 0 && lane == __ffs(peers) - 1)
      atomicAdd(&counts[g], static_cast<unsigned long long>(__popc(peers)));
  }
}

// the radix word: the group id of a kept row, n_groups for any other
__global__ void __launch_bounds__(kThreads)
    collect_sort_words(const uint8_t* __restrict__ keep,
                       const long long* __restrict__ gid, int64_t n,
                       int64_t n_groups, uint64_t* __restrict__ words) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    words[i] = static_cast<uint64_t>(keep[i] ? group_of(gid, i) : n_groups);
}

template <class W>
__global__ void __launch_bounds__(kThreads)
    collect_gather(const W* __restrict__ data,
                   const long long* __restrict__ perm, int64_t total,
                   W* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       k < total; k += stride)
    out[k] = data[perm[k]];
}

bool valid_width(int32_t width) {
  return width == 1 || width == 4 || width == 8;
}

}  // namespace

// Steps 1 and 2.  data: n values of width bytes (is_double: doubles),
// valid: n bytes or null (every value present), gid: n int64 group ids or
// null (one group).  distinct: set mode.  Scratch: words (n u64), and in
// set mode slots (table_size int64, a power of two >= 2n) and slot_of (n
// int64).  Output: keep (n bytes), offsets (n_groups + 1 int64: the
// exclusive offsets, then the total), tile_scratch srt::tiles_for(
// n_groups) int64.
extern "C" int srt_collect_count(int32_t width, int32_t is_double,
                                 const void* data, const void* valid,
                                 const void* gid, int64_t n,
                                 int64_t n_groups, int32_t distinct,
                                 void* words, void* slots,
                                 int64_t table_size, void* slot_of,
                                 void* keep, void* offsets,
                                 void* tile_scratch, void* stream) {
  if (!valid_width(width) || n < 0 || n_groups < 1 ||
      (gid == nullptr && n_groups != 1) ||
      (distinct && (table_size <= 0 ||
                    (table_size & (table_size - 1)) != 0 ||
                    table_size < 2 * n || slots == nullptr ||
                    slot_of == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* offs = static_cast<int64_t*>(offsets);
  cudaError_t err =
      cudaMemsetAsync(offs, 0, (n_groups + 1) * sizeof(int64_t), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const long long* g = static_cast<const long long*>(gid);
  long long* sl = distinct ? static_cast<long long*>(slots) : nullptr;
  long long* so = static_cast<long long*>(slot_of);
  if (n > 0) {
    if (distinct) {
      uint64_t* w = static_cast<uint64_t*>(words);
      collect_words<<<srt::grid_for(n), kThreads, 0, s>>>(data, width,
                                                          is_double, n, w);
      collect_clear<<<srt::grid_for(table_size), kThreads, 0, s>>>(
          sl, table_size);
      collect_insert<<<srt::grid_for(n), kThreads, 0, s>>>(
          w, v, g, n, sl, static_cast<uint64_t>(table_size - 1), so);
    }
    collect_keep_count<<<srt::grid_for(n), kThreads, 0, s>>>(
        v, g, n, sl, so, static_cast<uint8_t*>(keep),
        reinterpret_cast<unsigned long long*>(offs));
  }
  // counts -> exclusive offsets in place, the total at offs[n_groups]
  return static_cast<int>(srt::exclusive_scan(
      srt::ArrayValues{offs}, n_groups, offs,
      static_cast<int64_t*>(tile_scratch), s));
}

// Step 3, after the host has read the total and sized out (total values
// of width bytes).  keep, gid, n, n_groups as srt_collect_count's.
// Scratch: words (n u64), perm and perm_tmp (n int64 each), hist (256 *
// radix tiles of n int32), digit_total (256 int64).
extern "C" int srt_collect_write(int32_t width, const void* data,
                                 const void* gid, const void* keep,
                                 int64_t n, int64_t n_groups, int64_t total,
                                 void* words, void* perm, void* perm_tmp,
                                 void* hist, void* digit_total, void* out,
                                 void* stream) {
  if (!valid_width(width) || n < 0 || n_groups < 1 || total < 0 ||
      total > n || (gid == nullptr && n_groups != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint64_t* w = static_cast<uint64_t*>(words);
  collect_sort_words<<<srt::grid_for(n), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(keep), static_cast<const long long*>(gid),
      n, n_groups, w);
  int bits = 1;
  while (bits < 63 && (static_cast<uint64_t>(n_groups) >> bits) != 0) ++bits;
  const uint64_t* ws[1] = {w};
  const int bs[1] = {bits};
  long long* p = static_cast<long long*>(perm);
  cudaError_t err = srt::radix_sort(
      ws, bs, 1, n, p, static_cast<long long*>(perm_tmp),
      static_cast<int32_t*>(hist), static_cast<int64_t*>(digit_total), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned grid = srt::grid_for(total);
  if (width == 1)
    collect_gather<uint8_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint8_t*>(data), p, total,
        static_cast<uint8_t*>(out));
  else if (width == 4)
    collect_gather<uint32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const uint32_t*>(data), p, total,
        static_cast<uint32_t*>(out));
  else
    collect_gather<unsigned long long><<<grid, kThreads, 0, s>>>(
        static_cast<const unsigned long long*>(data), p, total,
        static_cast<unsigned long long*>(out));
  return static_cast<int>(cudaGetLastError());
}
