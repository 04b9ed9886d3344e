// Kernel K10: inner and left outer equi-join of one int or long key through
// a hash table.
//
// Replaces the JAX package's sort-based join programs `join.build`,
// `join.probe`, `join.pair` and `join.compact_pairs`
// (spark_rapids_tpu/ops/join_ops.py: build_side :125, built :150;
// _probe_ranges :157, :183; _expand_verify :191, :242; compact_pairs :290,
// :308).  XLA has no hash tables, so the JAX package sorts the build side
// by key hash and binary-searches it; on the card an open-addressing table
// is the direct form, as in the plugin this repository models (cuDF hash
// joins).
//
// Build: a table of a power of two >= 2 * build rows slots; each build row
// with a non-null key takes its own slot (atomicCAS, linear probing), so
// duplicate keys stay apart, and its key is stored beside the row index.
// Probe, in tiles of 1024 rows: the count pass walks each probe row's
// chain and writes one match count per tile; common.cuh scans the tile
// counts and writes the total, which the host reads (the join's one sync)
// to size the output; the write pass walks again, scans the counts inside
// the tile, and writes (probe row, build row) pairs in probe-row order.
// Within one probe row the build rows are put in ascending order (an
// insertion sort of that row's run), so the output does not depend on the
// order in which build rows won their slots.  Null keys never match.
//
// Bound: device memory bytes.  The probe side is read twice (count and
// write passes) where the function needs it once; the table (a few
// thousand slots on the main path) stays in L2.
#include "common.cuh"

namespace {

using srt::kScanItems;
using srt::kScanTile;
using srt::kThreads;

constexpr long long kEmpty = -1;

struct Side {
  const void* keys;
  int key64;
  const uint8_t* valid;  // null: every key is present
  int64_t n;
};

__device__ __forceinline__ bool present(const Side& s, int64_t i) {
  return s.valid == nullptr || s.valid[i] != 0;
}

__device__ __forceinline__ long long key_at(const Side& s, int64_t i) {
  return s.key64 ? static_cast<const long long*>(s.keys)[i]
                 : static_cast<long long>(static_cast<const int32_t*>(
                       s.keys)[i]);
}

__device__ __forceinline__ uint64_t home(long long key, uint64_t mask) {
  return srt::fmix64(static_cast<uint64_t>(key)) & mask;
}

__global__ void __launch_bounds__(kThreads)
    table_clear(long long* slots, int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += stride)
    slots[i] = kEmpty;
}

__global__ void __launch_bounds__(kThreads)
    table_build(Side b, long long* slots, long long* slot_keys,
                uint64_t mask) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < b.n; r += stride) {
    if (!present(b, r)) continue;
    const long long k = key_at(b, r);
    uint64_t s = home(k, mask);
    while (true) {
      const unsigned long long prev = atomicCAS(
          reinterpret_cast<unsigned long long*>(&slots[s]),
          static_cast<unsigned long long>(kEmpty),
          static_cast<unsigned long long>(r));
      if (prev == static_cast<unsigned long long>(kEmpty)) {
        slot_keys[s] = k;
        break;
      }
      s = (s + 1) & mask;
    }
  }
}

__device__ __forceinline__ long long match_count(
    const Side& p, int64_t i, const long long* __restrict__ slots,
    const long long* __restrict__ slot_keys, uint64_t mask) {
  if (i >= p.n || !present(p, i)) return 0;
  const long long k = key_at(p, i);
  long long c = 0;
  for (uint64_t s = home(k, mask); slots[s] != kEmpty; s = (s + 1) & mask)
    c += slot_keys[s] == k;
  return c;
}

// pairs a probe row gives: its matches, and in outer mode at least one
__device__ __forceinline__ long long pair_count(long long matches,
                                                const Side& p, int64_t i,
                                                int outer) {
  return (outer && i < p.n && matches == 0) ? 1 : matches;
}

__global__ void __launch_bounds__(kThreads)
    probe_count(Side p, const long long* __restrict__ slots,
                const long long* __restrict__ slot_keys, uint64_t mask,
                int outer, int64_t* tile_counts) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long c = 0;
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    c += pair_count(match_count(p, i, slots, slot_keys, mask), p, i, outer);
  }
  long long total;
  srt::block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    probe_write(Side p, const long long* __restrict__ slots,
                const long long* __restrict__ slot_keys, uint64_t mask,
                int outer, const int64_t* __restrict__ tile_offsets,
                long long* __restrict__ out_probe,
                long long* __restrict__ out_build) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long carry = tile_offsets[blockIdx.x];
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    const long long m = match_count(p, i, slots, slot_keys, mask);
    const long long c = pair_count(m, p, i, outer);
    long long t;
    const long long start = carry + srt::block_exclusive_scan(c, &t);
    carry += t;
    if (c == 0) continue;
    if (m == 0) {  // outer mode: the row with no match, null-extended
      out_probe[start] = i;
      out_build[start] = -1;
      continue;
    }
    const long long key = key_at(p, i);
    long long o = start;
    for (uint64_t s = home(key, mask); slots[s] != kEmpty;
         s = (s + 1) & mask) {
      if (slot_keys[s] != key) continue;
      out_probe[o] = i;
      out_build[o] = slots[s];
      ++o;
    }
    // build rows of this probe row in ascending order
    for (long long a = start + 1; a < o; ++a) {
      const long long v = out_build[a];
      long long j = a - 1;
      while (j >= start && out_build[j] > v) {
        out_build[j + 1] = out_build[j];
        --j;
      }
      out_build[j + 1] = v;
    }
  }
}

Side side(const void* keys, int32_t key64, const void* valid, int64_t n) {
  return Side{keys, key64, static_cast<const uint8_t*>(valid), n};
}

}  // namespace

// slots, slot_keys: table_size int64 each (a power of two).
extern "C" int srt_join_build(const void* keys, int32_t key64,
                              const void* valid, int64_t n, void* slots,
                              void* slot_keys, int64_t table_size,
                              void* stream) {
  if (table_size <= 0 || (table_size & (table_size - 1)) != 0 ||
      table_size < 2 * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* sl = static_cast<long long*>(slots);
  table_clear<<<srt::grid_for(table_size), kThreads, 0, s>>>(sl, table_size);
  if (n > 0)
    table_build<<<srt::grid_for(n), kThreads, 0, s>>>(
        side(keys, key64, valid, n), sl, static_cast<long long*>(slot_keys),
        static_cast<uint64_t>(table_size - 1));
  return static_cast<int>(cudaGetLastError());
}

// tile_offsets: srt::tiles_for(n) + 1 int64; after the call
// tile_offsets[tiles] holds the number of pairs.
extern "C" int srt_join_count(const void* keys, int32_t key64,
                              const void* valid, int64_t n, const void* slots,
                              const void* slot_keys, int64_t table_size,
                              int32_t outer, void* tile_offsets,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* offs = static_cast<int64_t*>(tile_offsets);
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(offs, 0, sizeof(int64_t), s));
  const unsigned tiles = srt::tiles_for(n);
  probe_count<<<tiles, kThreads, 0, s>>>(
      side(keys, key64, valid, n), static_cast<const long long*>(slots),
      static_cast<const long long*>(slot_keys),
      static_cast<uint64_t>(table_size - 1), outer, offs);
  srt::scan_tile_offsets<<<1, kThreads, 0, s>>>(offs, tiles, offs + tiles);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int srt_join_write(const void* keys, int32_t key64,
                              const void* valid, int64_t n, const void* slots,
                              const void* slot_keys, int64_t table_size,
                              int32_t outer, const void* tile_offsets,
                              void* out_probe, void* out_build,
                              void* stream) {
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_write<<<srt::tiles_for(n), kThreads, 0, s>>>(
      side(keys, key64, valid, n), static_cast<const long long*>(slots),
      static_cast<const long long*>(slot_keys),
      static_cast<uint64_t>(table_size - 1), outer,
      static_cast<const int64_t*>(tile_offsets),
      static_cast<long long*>(out_probe), static_cast<long long*>(out_build));
  return static_cast<int>(cudaGetLastError());
}
