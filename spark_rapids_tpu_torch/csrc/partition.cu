// Kernels K11h, K11r and K7s: a shuffle exchange's partition ids, their
// histogram, and the split of a batch into one contiguous segment per
// partition.
//
// K11h replaces the JAX package's HashPartitioning.partition_ids_tpu
// (spark_rapids_tpu/plan/partitioning.py:77, eager jnp): each row's pid is
// pmod(murmur3(keys, 42), n) (murmur3.cuh), bit for bit Spark's placement;
// pmod of the signed hash is ((h % n) + n) % n, C's remainder taking the
// dividend's sign.
//
// K11r replaces RangePartitioning.partition_ids_tpu (:186): a row's pid is
// the number of the n - 1 sorted bounds it is strictly greater than, by a
// binary search over them; rows equal to a bound stay at that bound's
// partition.  Rows and bounds compare key by key in the order K8's words
// give them (sort.cu): the null rank first (nulls first or last, never
// flipped), then the value, flipped for a descending key; a double with
// -0.0 as 0.0 and NaN after +inf, a string byte by byte (unsigned), a
// prefix first.  Unlike the JAX device form, which compares the data
// under a null (ROADMAP queue 3), a null's value is never read.
//
// Both end in the histogram (the JAX exchange's bincount,
// exec/exchange.py:658): rows per partition and, for each string column
// the exchange moves, chars per partition, so the exchange's one read
// sizes every plane of the split.  Counts are integers added with atomics
// (exact, whatever the order): a warp adds each of its partitions' rows
// once, a block keeps the sums in shared memory and flushes them once.
//
// K7s replaces the JAX map side's n compactions, ops/batch_ops.py:71
// compact_batch(b, pids == p) for each p (exec/exchange.py:623-627), by
// one stable scatter: rows of partition p land contiguous and in input
// order.  Steps (srt_split_rows):
//   1. per tile of kSplitTile rows, its rows of each partition (hist
//      [p * tiles + t], shared-memory counts);
//   2. an exclusive scan of hist in partition-major order: the first
//      output row of each (partition, tile);
//   3. per tile, each row's rank among its tile's rows of its partition,
//      kept stable as the radix sort ranks digits (radix.cuh): warp peers
//      by __match_any_sync, the counts of the warps before, and the
//      running counts of the chunks before; dest[i] is its output row.
// Then every plane moves through dest: fixed-width values and validity
// (srt_split_fixed), a string's lengths, whose scan gives global char
// positions, its offsets written per segment, each starting at 0
// (srt_split_string_offsets: segment p holds rows + 1 offsets from
// row_base[p] + p), and its chars (srt_split_string_chars, a warp a
// row).  A segment is then a view of the output with offsets from 0.
//
// Bound: device memory bytes.  K11 reads the key columns once and writes
// a 4-byte pid per row; K7s reads the pids twice, the planes once and
// writes them once (scattered writes: each row of a narrow plane costs a
// sector).
#include "keys.cuh"
#include "murmur3.cuh"

namespace {

using srt::HashCols;
using srt::Keys;
using srt::kThreads;

constexpr int kMaxParts = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kSplitChunks = 16;
constexpr int64_t kSplitTile = static_cast<int64_t>(kThreads) * kSplitChunks;
constexpr int kMaxPlanes = 32;
constexpr int kMaxStrings = 32;

__global__ void __launch_bounds__(kThreads)
    hash_ids(HashCols k, int64_t n, int32_t n_parts,
             int32_t* __restrict__ pids) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int32_t h = static_cast<int32_t>(srt::row_murmur3(k, i));
    pids[i] = ((h % n_parts) + n_parts) % n_parts;
  }
}

// the order word of a double: -0.0 as 0.0, every NaN one NaN above +inf
__device__ __forceinline__ uint64_t double_order(double x) {
  if (x == 0.0) x = 0.0;
  uint64_t b = isnan(x) ? 0x7ff8000000000000ULL
                        : static_cast<uint64_t>(__double_as_longlong(x));
  return (b >> 63) ? ~b : (b | 0x8000000000000000ULL);
}

template <class T>
__device__ __forceinline__ int three_way(T a, T b) {
  return a < b ? -1 : (a > b ? 1 : 0);
}

struct Orders {
  int32_t ascending[srt::kMaxKeys];
  int32_t nulls_first[srt::kMaxKeys];
};

// sign of (row i of r) - (bound j of b) in the sort order
__device__ int compare_to_bound(const Keys& r, int64_t i, const Keys& b,
                                int64_t j, const Orders& o) {
  for (int c = 0; c < r.n; ++c) {
    const bool pr = srt::key_present(r, c, i);
    const bool pb = srt::key_present(b, c, j);
    if (pr != pb) {
      // the null one comes first when nulls come first
      const int null_first = o.nulls_first[c] ? -1 : 1;
      return pr ? -null_first : null_first;
    }
    if (!pr) continue;
    int cmp;
    switch (r.type[c]) {
      case srt::kKeyInt32:
        cmp = three_way(static_cast<const int32_t*>(r.data[c])[i],
                        static_cast<const int32_t*>(b.data[c])[j]);
        break;
      case srt::kKeyInt64:
        cmp = three_way(static_cast<const long long*>(r.data[c])[i],
                        static_cast<const long long*>(b.data[c])[j]);
        break;
      case srt::kKeyFloat64:
        cmp = three_way(
            double_order(static_cast<const double*>(r.data[c])[i]),
            double_order(static_cast<const double*>(b.data[c])[j]));
        break;
      default: {
        int64_t sr, er, sb, eb;
        srt::string_bounds(r, c, i, &sr, &er);
        srt::string_bounds(b, c, j, &sb, &eb);
        const uint8_t* cr = static_cast<const uint8_t*>(r.data[c]) + sr;
        const uint8_t* cb = static_cast<const uint8_t*>(b.data[c]) + sb;
        const int64_t lr = er - sr, lb = eb - sb;
        const int64_t m = lr < lb ? lr : lb;
        cmp = 0;
        for (int64_t q = 0; q < m && cmp == 0; ++q)
          cmp = three_way(cr[q], cb[q]);
        if (cmp == 0) cmp = three_way(lr, lb);
      }
    }
    if (cmp != 0) return o.ascending[c] ? cmp : -cmp;
  }
  return 0;
}

__global__ void __launch_bounds__(kThreads)
    range_ids(Keys r, int64_t n, Keys b, int64_t n_bounds, Orders o,
              int32_t* __restrict__ pids) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    // the first bound the row is not greater than
    int64_t lo = 0, hi = n_bounds;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (compare_to_bound(r, i, b, mid, o) > 0)
        lo = mid + 1;
      else
        hi = mid;
    }
    pids[i] = static_cast<int32_t>(lo);
  }
}

struct StringCols {
  int32_t n;
  int32_t off64[kMaxStrings];
  const void* offsets[kMaxStrings];
};

__device__ __forceinline__ int64_t string_length(const StringCols& s, int c,
                                                 int64_t i) {
  if (s.off64[c]) {
    const int64_t* o = static_cast<const int64_t*>(s.offsets[c]);
    return o[i + 1] - o[i];
  }
  const int32_t* o = static_cast<const int32_t*>(s.offsets[c]);
  return static_cast<int64_t>(o[i + 1]) - o[i];
}

// counts[0 * n_parts + p]: rows of partition p; counts[(1 + c) * n_parts +
// p]: chars of string column c in partition p
__global__ void __launch_bounds__(kThreads)
    histogram(const int32_t* __restrict__ pids, int64_t n, int32_t n_parts,
              StringCols s, unsigned long long* __restrict__ counts) {
  __shared__ unsigned long long h[kMaxParts];
  const int lane = threadIdx.x & 31;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int w = 0; w <= s.n; ++w) {
    for (int p = threadIdx.x; p < n_parts; p += kThreads) h[p] = 0;
    __syncthreads();
    for (int64_t base = static_cast<int64_t>(blockIdx.x) * blockDim.x;
         base < n; base += stride) {
      const int64_t i = base + threadIdx.x;
      const bool active = i < n;
      const int32_t d = active ? pids[i] : 0;
      if (w == 0) {
        const unsigned mask = __ballot_sync(0xffffffffu, active);
        if (active) {
          const unsigned peers = __match_any_sync(mask, d);
          if (lane == __ffs(peers) - 1)
            atomicAdd(&h[d], static_cast<unsigned long long>(__popc(peers)));
        }
      } else if (active) {
        const int64_t len = string_length(s, w - 1, i);
        if (len) atomicAdd(&h[d], static_cast<unsigned long long>(len));
      }
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n_parts; p += kThreads)
      if (h[p]) atomicAdd(&counts[static_cast<int64_t>(w) * n_parts + p],
                          h[p]);
    __syncthreads();
  }
}

// hist[p * tiles + t]: rows of partition p in tile t
__global__ void __launch_bounds__(kThreads)
    split_tile_hist(const int32_t* __restrict__ pids, int64_t n,
                    int32_t n_parts, int64_t tiles,
                    int32_t* __restrict__ hist) {
  __shared__ int32_t h[kMaxParts];
  for (int p = threadIdx.x; p < n_parts; p += kThreads) h[p] = 0;
  __syncthreads();
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kSplitTile;
  for (int k = 0; k < kSplitChunks; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    if (i < n) atomicAdd(&h[pids[i]], 1);
  }
  __syncthreads();
  for (int p = threadIdx.x; p < n_parts; p += kThreads)
    hist[static_cast<int64_t>(p) * tiles + blockIdx.x] = h[p];
}

struct HistValues {
  const int32_t* p;
  __device__ __forceinline__ long long operator()(int64_t i) const {
    return p[i];
  }
};

__global__ void __launch_bounds__(kThreads)
    split_rank(const int32_t* __restrict__ pids, int64_t n, int64_t tiles,
               int32_t n_parts, const int64_t* __restrict__ base,
               long long* __restrict__ dest) {
  __shared__ int32_t running[kMaxParts];
  __shared__ int32_t warp_counts[kWarps][kMaxParts];
  for (int p = threadIdx.x; p < n_parts; p += kThreads) {
    running[p] = 0;
    for (int w = 0; w < kWarps; ++w) warp_counts[w][p] = 0;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t tile = blockIdx.x;
  for (int k = 0; k < kSplitChunks; ++k) {
    const int64_t i = tile * kSplitTile + k * kThreads + threadIdx.x;
    const bool active = i < n;
    const int32_t d = active ? pids[i] : 0;
    const unsigned mask = __ballot_sync(0xffffffffu, active);
    unsigned peers = 0;
    int rank = 0;
    if (active) {
      peers = __match_any_sync(mask, d);
      rank = __popc(peers & ((1u << lane) - 1u));
      if (lane == __ffs(peers) - 1) warp_counts[warp][d] = __popc(peers);
    }
    __syncthreads();
    if (active) {
      int before = 0;
      for (int w = 0; w < warp; ++w) before += warp_counts[w][d];
      dest[i] = base[static_cast<int64_t>(d) * tiles + tile] + running[d] +
                before + rank;
    }
    __syncthreads();
    if (active && lane == __ffs(peers) - 1) {
      atomicAdd(&running[d], warp_counts[warp][d]);
      warp_counts[warp][d] = 0;
    }
    __syncthreads();
  }
}

struct Planes {
  const void* src[kMaxPlanes];
  void* dst[kMaxPlanes];
  int32_t width[kMaxPlanes];
};

__global__ void __launch_bounds__(kThreads)
    split_fixed(const long long* __restrict__ dest, int64_t n, Planes p) {
  const int plane = blockIdx.y;
  const int w = p.width[plane];
  const void* src = p.src[plane];
  void* dst = p.dst[plane];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const long long j = dest[i];
    switch (w) {
      case 8:
        static_cast<int64_t*>(dst)[j] = static_cast<const int64_t*>(src)[i];
        break;
      case 4:
        static_cast<int32_t*>(dst)[j] = static_cast<const int32_t*>(src)[i];
        break;
      case 2:
        static_cast<int16_t*>(dst)[j] = static_cast<const int16_t*>(src)[i];
        break;
      default:
        static_cast<uint8_t*>(dst)[j] = static_cast<const uint8_t*>(src)[i];
    }
  }
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    split_lengths(const long long* __restrict__ dest, int64_t n,
                  const Off* __restrict__ off, int64_t* __restrict__ len) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    len[dest[i]] = static_cast<int64_t>(off[i + 1]) - off[i];
}

// out_off[q] for q in [0, n + n_parts): segment p holds the rows + 1
// offsets from row_base[p] + p, each its row's char position less the
// segment's first (gpos: the output rows' global char positions, n + 1)
__global__ void __launch_bounds__(kThreads)
    split_offsets(const int64_t* __restrict__ gpos, int64_t n,
                  const int64_t* __restrict__ row_base, int32_t n_parts,
                  int64_t* __restrict__ out_off) {
  const int64_t total = n + n_parts;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t q = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       q < total; q += stride) {
    // the last segment whose first offset is at or before q
    int32_t lo = 0, hi = n_parts - 1;
    while (lo < hi) {
      const int32_t mid = (lo + hi + 1) >> 1;
      if (row_base[mid] + mid <= q)
        lo = mid;
      else
        hi = mid - 1;
    }
    out_off[q] = gpos[q - lo] - gpos[row_base[lo]];
  }
}

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    split_chars(const long long* __restrict__ dest, int64_t n,
                const Off* __restrict__ src_off,
                const uint8_t* __restrict__ src,
                const int64_t* __restrict__ gpos,
                uint8_t* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
       i < n; i += warps) {
    const int64_t s = src_off[i];
    const int64_t len = static_cast<int64_t>(src_off[i + 1]) - s;
    const int64_t d = gpos[dest[i]];
    for (int64_t b = lane; b < len; b += 32) dst[d + b] = src[s + b];
  }
}

unsigned histogram_grid(int64_t n) {
  // enough blocks to fill the card; each flushes its counts once
  int64_t blocks = (n + kThreads * 16 - 1) / (kThreads * 16);
  if (blocks < 1) blocks = 1;
  if (blocks > 528) blocks = 528;
  return static_cast<unsigned>(blocks);
}

int run_histogram(const int32_t* pids, int64_t n, int32_t n_parts,
                  int32_t n_strings, const int32_t* str_off64,
                  const void* const* str_offsets, void* counts,
                  cudaStream_t s) {
  if (n_strings < 0 || n_strings > kMaxStrings)
    return static_cast<int>(cudaErrorInvalidValue);
  StringCols sc;
  sc.n = n_strings;
  for (int c = 0; c < n_strings; ++c) {
    sc.off64[c] = str_off64[c];
    sc.offsets[c] = str_offsets[c];
  }
  cudaError_t err = cudaMemsetAsync(
      counts, 0, sizeof(int64_t) * n_parts * (1 + n_strings), s);
  if (err != cudaSuccess || n == 0) return static_cast<int>(err);
  histogram<<<histogram_grid(n), kThreads, 0, s>>>(
      pids, n, n_parts, sc, static_cast<unsigned long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

bool bad_parts(int32_t n_parts) {
  return n_parts < 1 || n_parts > kMaxParts;
}

}  // namespace

// K11h: pids (n int32) of the rows by their n_keys hash columns (types:
// murmur3.cuh HashType), then the histogram into counts ((1 + n_strings)
// * n_parts int64) over the string columns the split moves.
extern "C" int srt_hash_partition(int32_t n_keys, const int32_t* type,
                                  const int32_t* off64,
                                  const void* const* data,
                                  const void* const* valid,
                                  const void* const* offsets, int64_t n,
                                  int32_t n_parts, void* pids,
                                  int32_t n_strings,
                                  const int32_t* str_off64,
                                  const void* const* str_offsets,
                                  void* counts, void* stream) {
  if (n_keys < 1 || n_keys > srt::kMaxHashCols || n < 0 ||
      bad_parts(n_parts))
    return static_cast<int>(cudaErrorInvalidValue);
  HashCols k;
  k.n = n_keys;
  for (int c = 0; c < n_keys; ++c) {
    if (!srt::valid_hash_type(type[c]))
      return static_cast<int>(cudaErrorInvalidValue);
    k.type[c] = type[c];
    k.off64[c] = off64[c];
    k.data[c] = data[c];
    k.valid[c] = static_cast<const uint8_t*>(valid[c]);
    k.offsets[c] = offsets[c];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* p = static_cast<int32_t*>(pids);
  if (n > 0) hash_ids<<<srt::grid_for(n), kThreads, 0, s>>>(k, n, n_parts, p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return run_histogram(p, n, n_parts, n_strings, str_off64, str_offsets,
                       counts, s);
}

// K11r: pids of the rows (n_keys key columns, keys.cuh KeyType) against
// n_bounds sorted bound rows of the same types, in the order of
// ascending[] and nulls_first[]; then the histogram as K11h's.
extern "C" int srt_range_partition(
    int32_t n_keys, const int32_t* type, const int32_t* off64,
    const void* const* data, const void* const* valid,
    const void* const* offsets, int64_t n, const int32_t* bound_off64,
    const void* const* bound_data, const void* const* bound_valid,
    const void* const* bound_offsets, int64_t n_bounds,
    const int32_t* ascending, const int32_t* nulls_first, int32_t n_parts,
    void* pids, int32_t n_strings, const int32_t* str_off64,
    const void* const* str_offsets, void* counts, void* stream) {
  if (n_keys < 1 || n_keys > srt::kMaxKeys || n < 0 || n_bounds < 0 ||
      bad_parts(n_parts) || n_bounds >= n_parts)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_keys; ++c)
    if (!srt::valid_key_type(type[c]))
      return static_cast<int>(cudaErrorInvalidValue);
  const Keys r = srt::make_keys(n_keys, type, off64, data, valid, offsets);
  const Keys b = srt::make_keys(n_keys, type, bound_off64, bound_data,
                                bound_valid, bound_offsets);
  Orders o;
  for (int c = 0; c < n_keys; ++c) {
    o.ascending[c] = ascending[c];
    o.nulls_first[c] = nulls_first[c];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int32_t* p = static_cast<int32_t*>(pids);
  if (n > 0)
    range_ids<<<srt::grid_for(n), kThreads, 0, s>>>(r, n, b, n_bounds, o,
                                                    p);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return run_histogram(p, n, n_parts, n_strings, str_off64, str_offsets,
                       counts, s);
}

// K7s, step 1: dest (n int64), each row's output row.  Scratch: hist
// (n_parts * split_tiles(n) int32), base (n_parts * split_tiles(n) + 1
// int64), tile_scratch (srt::tiles_for(n_parts * split_tiles(n))).
extern "C" int srt_split_rows(const void* pids, int64_t n, int32_t n_parts,
                              void* hist, void* base, void* tile_scratch,
                              void* dest, void* stream) {
  if (n < 0 || bad_parts(n_parts))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (n + kSplitTile - 1) / kSplitTile;
  const int32_t* p = static_cast<const int32_t*>(pids);
  int32_t* h = static_cast<int32_t*>(hist);
  split_tile_hist<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      p, n, n_parts, tiles, h);
  cudaError_t err = srt::exclusive_scan(
      HistValues{h}, tiles * n_parts, static_cast<int64_t*>(base),
      static_cast<int64_t*>(tile_scratch), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_rank<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      p, n, tiles, n_parts, static_cast<const int64_t*>(base),
      static_cast<long long*>(dest));
  return static_cast<int>(cudaGetLastError());
}

// K7s, step 2: n_planes fixed-width planes (width 1, 2, 4 or 8 bytes)
// scattered through dest.
extern "C" int srt_split_fixed(const void* dest, int64_t n, int32_t n_planes,
                               const void* const* src, void* const* dst,
                               const int32_t* width, void* stream) {
  if (n_planes < 0 || n_planes > kMaxPlanes || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || n_planes == 0) return 0;
  Planes p;
  for (int j = 0; j < n_planes; ++j) {
    p.src[j] = src[j];
    p.dst[j] = dst[j];
    p.width[j] = width[j];
  }
  const dim3 grid(srt::grid_for(n), static_cast<unsigned>(n_planes));
  split_fixed<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(dest), n, p);
  return static_cast<int>(cudaGetLastError());
}

// K7s, step 3 for a string column: gpos (n + 1 int64), the output rows'
// global char positions, and out_off (n + n_parts int64), each segment's
// offsets from 0; row_base (n_parts + 1 int64, on the device): each
// segment's first output row.  Scratch: len (n int64), tile_scratch
// (srt::tiles_for(n)).
extern "C" int srt_split_string_offsets(const void* dest, int64_t n,
                                        const void* src_off, int32_t off64,
                                        const void* row_base,
                                        int32_t n_parts, void* len,
                                        void* tile_scratch, void* gpos,
                                        void* out_off, void* stream) {
  if (n < 0 || bad_parts(n_parts))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long* d = static_cast<const long long*>(dest);
  int64_t* l = static_cast<int64_t*>(len);
  if (n > 0) {
    if (off64)
      split_lengths<int64_t><<<srt::grid_for(n), kThreads, 0, s>>>(
          d, n, static_cast<const int64_t*>(src_off), l);
    else
      split_lengths<int32_t><<<srt::grid_for(n), kThreads, 0, s>>>(
          d, n, static_cast<const int32_t*>(src_off), l);
  }
  cudaError_t err = srt::exclusive_scan(
      srt::ArrayValues{l}, n, static_cast<int64_t*>(gpos),
      static_cast<int64_t*>(tile_scratch), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  split_offsets<<<srt::grid_for(n + n_parts), kThreads, 0, s>>>(
      static_cast<const int64_t*>(gpos), n,
      static_cast<const int64_t*>(row_base), n_parts,
      static_cast<int64_t*>(out_off));
  return static_cast<int>(cudaGetLastError());
}

// K7s, step 4 for a string column: each row's chars to its global char
// position (gpos from step 3).
extern "C" int srt_split_string_chars(const void* dest, int64_t n,
                                      const void* src_off, int32_t off64,
                                      const void* src_chars,
                                      const void* gpos, void* dst_chars,
                                      void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = srt::grid_for(n * 32);
  const long long* d = static_cast<const long long*>(dest);
  if (off64)
    split_chars<int64_t><<<grid, kThreads, 0, s>>>(
        d, n, static_cast<const int64_t*>(src_off),
        static_cast<const uint8_t*>(src_chars),
        static_cast<const int64_t*>(gpos), static_cast<uint8_t*>(dst_chars));
  else
    split_chars<int32_t><<<grid, kThreads, 0, s>>>(
        d, n, static_cast<const int32_t*>(src_off),
        static_cast<const uint8_t*>(src_chars),
        static_cast<const int64_t*>(gpos), static_cast<uint8_t*>(dst_chars));
  return static_cast<int>(cudaGetLastError());
}
