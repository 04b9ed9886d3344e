// Kernel K14: whole-partition window aggregates -- sum, count and avg over
// PARTITION BY with no ORDER BY -- and the ranking functions row_number,
// rank and dense_rank over PARTITION BY ... ORDER BY.
//
// Replaces the JAX package's `window.frame` program
// (spark_rapids_tpu/ops/window_ops.py:79 compute_windows, built :157, with
// _one_func :173 in its whole-partition `agg` kind).  The JAX program sorts
// by the partition keys, finds partition boundaries from
// _masked_group_words, and takes prefix-sum differences between each
// row's partition ends.  Here the sort is K8 and the gather K7
// (ops/window_ops.py compute_windows); this file takes the rows in that
// order, each partition's rows together, and reduces each partition
// directly.
//
// srt_window_segments: rank[i + 1] = the number of partition starts in
//   rows 0..i, an exclusive scan (common.cuh) of start(i) = (i == 0 or row
//   i's keys differ from row i - 1's, keys.cuh keys_equal: a null equals a
//   null, doubles by their normalised bits, strings byte by byte).  Row i
//   starts a partition when rank[i + 1] > rank[i]; its partition id is
//   rank[i + 1] - 1.  With no key there is one partition.
// srt_window_agg, per function, three passes:
//   1. win_tiles: one block per tile of 1024 rows, 4 consecutive rows a
//      thread.  Each thread folds its rows, a block-wide segmented scan in
//      thread order gives each thread the sum and count of its partition's
//      rows before it in the tile, and each row then holds its partition's
//      running total within the tile.  A partition that starts and ends in
//      the tile is written whole.  Otherwise the tile keeps a head piece
//      (the rows of a partition that began in an earlier tile) and a tail
//      piece (the rows of a partition that goes on past the tile).
//   2. win_join: for each tile whose tail piece begins a partition that
//      spans tiles, one thread adds the head pieces of the tiles after it,
//      in tile order, up to the tile where the partition ends.
//   3. win_write: each row takes its partition's result: the sum (null
//      where no value is present), the count, or the mean = sum / count.
// A partition of many rows is summed by as many blocks as it has tiles;
// pass 2 walks a thousandth as many pieces.  No atomics: for a given row
// count every addition happens in a fixed order, so a rerun gives the
// same bits.  A direct sum gives IEEE's NaN, +-inf and inf - inf = NaN,
// which the JAX package rebuilds from counts beside its prefix
// differences; the finite parts round otherwise, in the last bits.  Long
// sums wrap mod 2^64, as there.
//
// Bound: device memory bytes.  Each key is read twice (the scan's two
// passes), each value and validity once, the rank twice, and each output
// written once; a few additions a row.
//
// srt_window_rank, the ranking pass (the JAX program's ranking kinds,
// ops/window_ops.py:122-150 for the boundaries and first positions and
// :177-186 for row_number, rank and dense_rank), over rows sorted by the
// partition keys and then the order keys (K8 and K7):
//   1. part_rank = the exclusive scan of partition starts (the first
//      n_part key columns differ from the row before's), peer_rank = the
//      one of peer starts (any key column differs), both with StartOf and
//      common.cuh's tiled scan: a row's partition id is part_rank[i + 1]
//      - 1, its peer group's id peer_rank[i + 1] - 1.
//   2. rank_firsts: each start row writes its position at its id, in
//      part_first and peer_first.  The JAX program takes these first
//      positions with a segment minimum; here each id has one writer, so
//      a scatter gives them with no atomics and no scan of maxima.
//   3. rank_write: row_number = i - pstart + 1, rank = peerstart - pstart
//      + 1, dense_rank = peer_rank[i + 1] - peer_rank[pstart + 1] + 1 (the
//      peer starts in [pstart, i]), as int32.
// Peers compare as partitions do: a null equals a null, doubles by their
// normalised bits (-0.0 = 0.0, NaN = NaN), strings byte by byte.  No
// atomics, no sync.  Bound: device memory bytes: the keys read twice, a
// few int64 planes of scratch, 4 bytes written a row per function.
#include "keys.cuh"

namespace {

using srt::kThreads;

constexpr int kItems = 4;
constexpr int kTile = kThreads * kItems;

enum WinKind : int32_t { kSumI64 = 0, kSumF64 = 1, kCount = 2,
                         kCountAll = 3, kMean = 4 };

// 1 where row i starts a partition
struct StartOf {
  srt::Keys k;
  __device__ __forceinline__ long long operator()(int64_t i) const {
    return (i == 0 || !srt::keys_equal(k, i - 1, i)) ? 1 : 0;
  }
};

// The sum and count of a run of rows since the last partition start in
// it (all of them when none lies in it), and whether one does.
template <typename S>
struct Piece {
  S sum;
  long long cnt;
  int start;
};

template <typename S>
__device__ __forceinline__ Piece<S> none() {
  Piece<S> p;
  p.sum = S(0);
  p.cnt = 0;
  p.start = 0;
  return p;
}

// a, then b
template <typename S>
__device__ __forceinline__ Piece<S> join(const Piece<S>& a,
                                         const Piece<S>& b) {
  if (b.start) return b;
  Piece<S> p;
  p.sum = a.sum + b.sum;
  p.cnt = a.cnt + b.cnt;
  p.start = a.start;
  return p;
}

template <typename S>
__device__ __forceinline__ Piece<S> shfl_up(const Piece<S>& x, int d) {
  Piece<S> y;
  y.sum = __shfl_up_sync(0xffffffffu, x.sum, d);
  y.cnt = __shfl_up_sync(0xffffffffu, x.cnt, d);
  y.start = __shfl_up_sync(0xffffffffu, x.start, d);
  return y;
}

// The join of the pieces of the threads before this one, in thread order.
// Every thread of the block calls it.
template <typename S>
__device__ Piece<S> block_exclusive(const Piece<S>& x) {
  __shared__ Piece<S> warp_total[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  Piece<S> inc = x;
  for (int d = 1; d < 32; d <<= 1) {
    const Piece<S> y = shfl_up(inc, d);
    if (lane >= d) inc = join(y, inc);
  }
  if (lane == 31) warp_total[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    Piece<S> w = lane < kThreads / 32 ? warp_total[lane] : none<S>();
    for (int d = 1; d < 32; d <<= 1) {
      const Piece<S> y = shfl_up(w, d);
      if (lane >= d) w = join(y, w);
    }
    if (lane < kThreads / 32) warp_total[lane] = w;
  }
  __syncthreads();
  const Piece<S> in_warp = shfl_up(inc, 1);
  const Piece<S> before = warp > 0 ? warp_total[warp - 1] : none<S>();
  const Piece<S> out = lane == 0 ? before : join(before, in_warp);
  __syncthreads();  // warp_total is reused by the next call
  return out;
}

template <typename S>
__device__ __forceinline__ S value_of(const void* data, int64_t i);

template <>
__device__ __forceinline__ double value_of<double>(const void* data,
                                                   int64_t i) {
  return static_cast<const double*>(data)[i];
}

template <>
__device__ __forceinline__ unsigned long long value_of<unsigned long long>(
    const void* data, int64_t i) {
  return static_cast<unsigned long long>(
      static_cast<const long long*>(data)[i]);
}

__device__ __forceinline__ bool starts_at(const int64_t* rank, int64_t i) {
  return rank[i + 1] > rank[i];
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    win_tiles(int32_t kind, const void* __restrict__ data,
              const uint8_t* __restrict__ valid, int64_t n,
              const int64_t* __restrict__ rank, S* __restrict__ seg_sum,
              long long* __restrict__ seg_cnt, S* __restrict__ head_sum,
              long long* __restrict__ head_cnt, S* __restrict__ tail_sum,
              long long* __restrict__ tail_cnt,
              uint8_t* __restrict__ head_ends,
              uint8_t* __restrict__ tail_owned) {
  const int64_t t = blockIdx.x;
  const int64_t base = t * kTile;
  const int64_t first = base + static_cast<int64_t>(threadIdx.x) * kItems;
  const int64_t last_row = (base + kTile < n ? base + kTile : n) - 1;
  const bool sums = kind == kSumI64 || kind == kSumF64 || kind == kMean;
  Piece<S> row[kItems];
  Piece<S> local = none<S>();
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = first + k;
    row[k] = none<S>();
    if (i >= n) continue;
    const bool present =
        kind == kCountAll || valid == nullptr || valid[i] != 0;
    row[k].start = starts_at(rank, i) ? 1 : 0;
    row[k].cnt = present ? 1 : 0;
    if (sums && present) row[k].sum = value_of<S>(data, i);
    local = join(local, row[k]);
  }
  Piece<S> run = block_exclusive(local);
  for (int k = 0; k < kItems; ++k) {
    const int64_t i = first + k;
    if (i >= n) break;
    run = join(run, row[k]);
    const bool ends = i + 1 == n || starts_at(rank, i + 1);
    if (ends && run.start) {
      const int64_t g = rank[i + 1] - 1;
      seg_sum[g] = run.sum;
      seg_cnt[g] = run.cnt;
    } else if (ends || i == last_row) {
      if (run.start) {
        tail_sum[t] = run.sum;
        tail_cnt[t] = run.cnt;
      } else {
        head_sum[t] = run.sum;
        head_cnt[t] = run.cnt;
        head_ends[t] = ends ? 1 : 0;
      }
    }
    if (i == last_row) tail_owned[t] = (!ends && run.start) ? 1 : 0;
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    win_join(int64_t n, int64_t n_tiles, const int64_t* __restrict__ rank,
             S* __restrict__ seg_sum, long long* __restrict__ seg_cnt,
             const S* __restrict__ head_sum,
             const long long* __restrict__ head_cnt,
             const S* __restrict__ tail_sum,
             const long long* __restrict__ tail_cnt,
             const uint8_t* __restrict__ head_ends,
             const uint8_t* __restrict__ tail_owned) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       t < n_tiles; t += stride) {
    if (!tail_owned[t]) continue;
    S s = tail_sum[t];
    long long c = tail_cnt[t];
    for (int64_t u = t + 1; u < n_tiles; ++u) {
      s = s + head_sum[u];
      c += head_cnt[u];
      if (head_ends[u]) break;
    }
    const int64_t g = rank[(t + 1) * kTile] - 1;
    seg_sum[g] = s;
    seg_cnt[g] = c;
  }
}

template <typename S>
__global__ void __launch_bounds__(kThreads)
    win_write(int32_t kind, int64_t n, const int64_t* __restrict__ rank,
              const S* __restrict__ seg_sum,
              const long long* __restrict__ seg_cnt, void* __restrict__ out,
              uint8_t* __restrict__ out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t g = rank[i + 1] - 1;
    const long long c = seg_cnt[g];
    if (kind == kCount || kind == kCountAll) {
      static_cast<long long*>(out)[i] = c;
      out_valid[i] = 1;
      continue;
    }
    const S s = seg_sum[g];
    if (kind == kSumI64)
      static_cast<long long*>(out)[i] = static_cast<long long>(s);
    else if (kind == kSumF64)
      static_cast<double*>(out)[i] = static_cast<double>(s);
    else
      static_cast<double*>(out)[i] =
          c > 0 ? static_cast<double>(s) / static_cast<double>(c) : 0.0;
    out_valid[i] = c > 0 ? 1 : 0;
  }
}

template <typename S>
cudaError_t run_agg(int32_t kind, const void* data, const uint8_t* valid,
                    int64_t n, const int64_t* rank, void* out,
                    uint8_t* out_valid, void* seg_sum, long long* seg_cnt,
                    void* head_sum, long long* head_cnt, void* tail_sum,
                    long long* tail_cnt, uint8_t* head_ends,
                    uint8_t* tail_owned, cudaStream_t s) {
  const int64_t tiles = (n + kTile - 1) / kTile;
  win_tiles<S><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
      kind, data, valid, n, rank, static_cast<S*>(seg_sum), seg_cnt,
      static_cast<S*>(head_sum), head_cnt, static_cast<S*>(tail_sum),
      tail_cnt, head_ends, tail_owned);
  win_join<S><<<srt::grid_for(tiles), kThreads, 0, s>>>(
      n, tiles, rank, static_cast<S*>(seg_sum), seg_cnt,
      static_cast<const S*>(head_sum), head_cnt,
      static_cast<const S*>(tail_sum), tail_cnt, head_ends, tail_owned);
  win_write<S><<<srt::grid_for(n), kThreads, 0, s>>>(
      kind, n, rank, static_cast<const S*>(seg_sum), seg_cnt, out,
      out_valid);
  return cudaGetLastError();
}

__global__ void __launch_bounds__(kThreads)
    rank_firsts(int64_t n, const int64_t* __restrict__ part_rank,
                const int64_t* __restrict__ peer_rank,
                int64_t* __restrict__ part_first,
                int64_t* __restrict__ peer_first) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (starts_at(part_rank, i)) part_first[part_rank[i]] = i;
    if (starts_at(peer_rank, i)) peer_first[peer_rank[i]] = i;
  }
}

__global__ void __launch_bounds__(kThreads)
    rank_write(int64_t n, const int64_t* __restrict__ part_rank,
               const int64_t* __restrict__ peer_rank,
               const int64_t* __restrict__ part_first,
               const int64_t* __restrict__ peer_first,
               int32_t* __restrict__ row_number, int32_t* __restrict__ rank,
               int32_t* __restrict__ dense_rank) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t first = part_first[part_rank[i + 1] - 1];
    if (row_number != nullptr)
      row_number[i] = static_cast<int32_t>(i - first + 1);
    if (rank != nullptr)
      rank[i] = static_cast<int32_t>(peer_first[peer_rank[i + 1] - 1] -
                                     first + 1);
    if (dense_rank != nullptr)
      dense_rank[i] =
          static_cast<int32_t>(peer_rank[i + 1] - peer_rank[first + 1] + 1);
  }
}

}  // namespace

// rank: n + 1 int64 (rank[n] = the number of partitions); tile_scratch:
// srt::tiles_for(n) int64.  Keys as keys.cuh takes them; n_keys may be 0.
extern "C" int srt_window_segments(int32_t n_keys, const int32_t* type,
                                   const int32_t* off64,
                                   const void* const* data,
                                   const void* const* valid,
                                   const void* const* offsets, int64_t n,
                                   void* rank, void* tile_scratch,
                                   void* stream) {
  if (n_keys < 0 || n_keys > srt::kMaxKeys || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_keys; ++c)
    if (!srt::valid_key_type(type[c]))
      return static_cast<int>(cudaErrorInvalidValue);
  const StartOf f{srt::make_keys(n_keys, type, off64, data, valid,
                                 offsets)};
  return static_cast<int>(srt::exclusive_scan(
      f, n, static_cast<int64_t*>(rank),
      static_cast<int64_t*>(tile_scratch),
      static_cast<cudaStream_t>(stream)));
}

// One function over the rows srt_window_segments ranked.  data: int64 for
// kSumI64, double for kSumF64 and kMean, unread for the counts; valid may
// be null.  out: n int64 (sums of longs, counts) or doubles; out_valid: n
// bytes.  Scratch: seg_sum, seg_cnt (n words each); head_sum, head_cnt,
// tail_sum, tail_cnt (one word per tile of 1024 rows); head_ends,
// tail_owned (one byte per tile).
extern "C" int srt_window_agg(int32_t kind, const void* data,
                              const void* valid, int64_t n, const void* rank,
                              void* out, void* out_valid, void* seg_sum,
                              void* seg_cnt, void* head_sum, void* head_cnt,
                              void* tail_sum, void* tail_cnt,
                              void* head_ends, void* tail_owned,
                              void* stream) {
  if (kind < kSumI64 || kind > kMean || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* v = static_cast<const uint8_t*>(valid);
  const int64_t* r = static_cast<const int64_t*>(rank);
  long long* sc = static_cast<long long*>(seg_cnt);
  long long* hc = static_cast<long long*>(head_cnt);
  long long* tc = static_cast<long long*>(tail_cnt);
  uint8_t* he = static_cast<uint8_t*>(head_ends);
  uint8_t* to = static_cast<uint8_t*>(tail_owned);
  uint8_t* ov = static_cast<uint8_t*>(out_valid);
  if (kind == kSumF64 || kind == kMean)
    return static_cast<int>(run_agg<double>(kind, data, v, n, r, out, ov,
                                            seg_sum, sc, head_sum, hc,
                                            tail_sum, tc, he, to, s));
  return static_cast<int>(run_agg<unsigned long long>(
      kind, data, v, n, r, out, ov, seg_sum, sc, head_sum, hc, tail_sum, tc,
      he, to, s));
}

// The ranking pass.  Keys as keys.cuh takes them: the n_part partition
// keys, then the order keys, n_keys in all (0 <= n_part <= n_keys <= 8).
// part_rank, peer_rank: n + 1 int64; tile_scratch: srt::tiles_for(n)
// int64; part_first, peer_first: n int64.  Each of row_number, rank and
// dense_rank is n int32, or null when not wanted.
extern "C" int srt_window_rank(int32_t n_part, int32_t n_keys,
                               const int32_t* type, const int32_t* off64,
                               const void* const* data,
                               const void* const* valid,
                               const void* const* offsets, int64_t n,
                               void* part_rank, void* peer_rank,
                               void* tile_scratch, void* part_first,
                               void* peer_first, void* row_number,
                               void* rank, void* dense_rank, void* stream) {
  if (n_part < 0 || n_part > n_keys || n_keys > srt::kMaxKeys || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_keys; ++c)
    if (!srt::valid_key_type(type[c]))
      return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* pr = static_cast<int64_t*>(part_rank);
  int64_t* qr = static_cast<int64_t*>(peer_rank);
  int64_t* scratch = static_cast<int64_t*>(tile_scratch);
  const StartOf parts{srt::make_keys(n_part, type, off64, data, valid,
                                     offsets)};
  const StartOf peers{srt::make_keys(n_keys, type, off64, data, valid,
                                     offsets)};
  cudaError_t e = srt::exclusive_scan(parts, n, pr, scratch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = srt::exclusive_scan(peers, n, qr, scratch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  int64_t* pf = static_cast<int64_t*>(part_first);
  int64_t* qf = static_cast<int64_t*>(peer_first);
  rank_firsts<<<srt::grid_for(n), kThreads, 0, s>>>(n, pr, qr, pf, qf);
  rank_write<<<srt::grid_for(n), kThreads, 0, s>>>(
      n, pr, qr, pf, qf, static_cast<int32_t*>(row_number),
      static_cast<int32_t*>(rank), static_cast<int32_t*>(dense_rank));
  return static_cast<int>(cudaGetLastError());
}
