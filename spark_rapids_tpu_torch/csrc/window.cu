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
    if (peer_rank != nullptr && starts_at(peer_rank, i))
      peer_first[peer_rank[i]] = i;
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

// ---------------------------------------------------------------------------
// Frames: K14s (running frames), K14b (bounded ROWS frames) and K14o (lag,
// lead and ntile), the JAX program's `agg` kind over an ORDER BY, its
// `offset` kind and `ntile` (ops/window_ops.py:187-209, :210-351).
//
// srt_window_bounds ranks the rows as the ranking pass does (partition
// starts, and peer starts when a RANGE frame needs them) and scatters each
// partition's and peer group's first row; a row's partition is then
// [pfirst[g], pfirst[g + 1] - 1] for g = prank[i + 1] - 1, its peer
// group's last row likewise (Bounds).
//
// K14s, srt_window_running: a segmented inclusive scan of each row's
// state (sum and count; or the extreme, whether a value, a NaN and a
// non-NaN value are present) in three passes -- frame_tiles scans each
// tile of 1024 rows in one block (4 consecutive rows a thread, a block
// scan of the threads' pieces) and keeps the tile's last piece;
// frame_carry, one block, scans the tiles' pieces in order, so each tile
// gets the state of its partition's rows in the tiles before it (the
// carry-in); frame_fix adds the carry-in to the rows before the tile's
// first partition start -- and frame_take writes each row's result from
// the running state at a row of its frame: its own (ROWS UNBOUNDED
// PRECEDING..CURRENT ROW), its peer group's last (the default RANGE
// frame), its partition's last (the whole partition), or i + k clamped
// to the partition (UNBOUNDED PRECEDING..k FOLLOWING; empty when i + k
// lies before the partition).  CURRENT ROW or k PRECEDING/FOLLOWING ..
// UNBOUNDED FOLLOWING is the same scan over the rows in reverse, a
// partition's last row starting it.  A direct running sum gives IEEE's
// NaN and +-inf as they arise (the JAX program rebuilds them from counts
// beside its prefix differences, :244-273; its finite parts round
// otherwise, in the last bits).  No atomics; every addition in a fixed
// order.
//
// K14b, srt_window_bounded: each row folds its frame [max(i + lo, pstart),
// min(i + hi, pend)] directly, in row order: at most hi - lo + 1 loads a
// row, no prefix difference, so a small window after a long prefix keeps
// its precision and a NaN or inf touches only the frames holding it.
//
// Min and max follow Spark's NaN-greatest rule (:279-303): max is NaN
// when a NaN is in the frame, min skips NaN unless nothing else is there.
// Nulls are skipped; a frame with no present value is null (a count 0).
//
// K14o: srt_window_offset writes each row's source row for lag/lead
// (i + offset inside the row's partition, else -1; K7 then gathers the
// values, a -1 row null), srt_window_fill writes a scalar default into a
// fixed-width gather's -1 rows, and srt_window_ntile each row's tile from
// its partition's start and size (the first cnt % n tiles one row more).
//
// Bound: device memory bytes.  Running: the value and validity read once,
// the ranks read a few times, the state written and read twice, the
// output written once.  Bounded: the value read (hi - lo + 1) times
// through L1/L2.  Offset and ntile: the ranks read, 8 or 4 bytes written.

namespace {

enum FrameKind : int32_t { kMin = 5, kMax = 6 };
enum ValueType : int32_t { kI32 = 0, kI64 = 1, kF64 = 2 };
enum Take : int32_t { kTakeRows = 0, kTakePeers = 1, kTakePartition = 2 };
// bytes of one running state, and of a tile's piece, in the scratch planes
constexpr int kStateBytes = 32;

struct Bounds {
  const int64_t* prank;
  const int64_t* pfirst;
  const int64_t* qrank;
  const int64_t* qfirst;
  int64_t n;
  __device__ __forceinline__ int64_t pstart(int64_t i) const {
    return pfirst[prank[i + 1] - 1];
  }
  __device__ __forceinline__ int64_t pend(int64_t i) const {
    const int64_t g = prank[i + 1];
    return g < prank[n] ? pfirst[g] - 1 : n - 1;
  }
  __device__ __forceinline__ int64_t qend(int64_t i) const {
    const int64_t g = qrank[i + 1];
    return g < qrank[n] ? qfirst[g] - 1 : n - 1;
  }
  __device__ __forceinline__ bool starts(int64_t i) const {
    return prank[i + 1] > prank[i];
  }
  __device__ __forceinline__ bool ends(int64_t i) const {
    return i + 1 == n || prank[i + 2] > prank[i + 1];
  }
};

// sum, mean and the counts: a sum (wrapping for longs) and a count of the
// present values (of every row for count(*))
template <typename S>
struct SumOp {
  struct State {
    S sum;
    long long cnt;
  };
  int32_t kind;
  const void* data;
  const uint8_t* valid;
  __device__ __forceinline__ State none() const {
    State s;
    s.sum = S(0);
    s.cnt = 0;
    return s;
  }
  __device__ __forceinline__ State load(int64_t i) const {
    State s = none();
    if (kind != kCountAll && valid != nullptr && valid[i] == 0) return s;
    s.cnt = 1;
    if (kind == kSumI64 || kind == kSumF64 || kind == kMean)
      s.sum = value_of<S>(data, i);
    return s;
  }
  __device__ __forceinline__ static State join(const State& a,
                                               const State& b) {
    State s;
    s.sum = a.sum + b.sum;
    s.cnt = a.cnt + b.cnt;
    return s;
  }
  __device__ __forceinline__ void write(const State& s, int64_t i, void* out,
                                        uint8_t* out_valid) const {
    if (kind == kCount || kind == kCountAll) {
      static_cast<long long*>(out)[i] = s.cnt;
      out_valid[i] = 1;
      return;
    }
    if (kind == kSumI64)
      static_cast<long long*>(out)[i] =
          s.cnt > 0 ? static_cast<long long>(s.sum) : 0;
    else if (kind == kSumF64)
      static_cast<double*>(out)[i] =
          s.cnt > 0 ? static_cast<double>(s.sum) : 0.0;
    else
      static_cast<double*>(out)[i] =
          s.cnt > 0 ? static_cast<double>(s.sum) / static_cast<double>(s.cnt)
                    : 0.0;
    out_valid[i] = s.cnt > 0 ? 1 : 0;
  }
};

// min (kIsMax false) and max over int32, int64 or double values
template <typename V, bool kIsMax>
struct ExtremeOp {
  struct State {
    V val;
    int32_t has;   // a present value
    int32_t nan;   // a present NaN
    int32_t real;  // a present value that is not NaN (val holds the best)
  };
  int32_t vtype;
  const void* data;
  const uint8_t* valid;
  __device__ __forceinline__ State none() const {
    State s;
    s.val = V(0);
    s.has = 0;
    s.nan = 0;
    s.real = 0;
    return s;
  }
  __device__ __forceinline__ V read(int64_t i) const {
    if (vtype == kI32) return V(static_cast<const int32_t*>(data)[i]);
    if (vtype == kI64) return V(static_cast<const long long*>(data)[i]);
    return V(static_cast<const double*>(data)[i]);
  }
  __device__ __forceinline__ State load(int64_t i) const {
    State s = none();
    if (valid != nullptr && valid[i] == 0) return s;
    s.has = 1;
    const V x = read(i);
    if (x != x) {  // NaN, doubles only
      s.nan = 1;
      return s;
    }
    s.real = 1;
    s.val = x;
    return s;
  }
  __device__ __forceinline__ static State join(const State& a,
                                               const State& b) {
    State s;
    s.has = a.has | b.has;
    s.nan = a.nan | b.nan;
    s.real = a.real | b.real;
    if (a.real && b.real)
      s.val = kIsMax ? (b.val > a.val ? b.val : a.val)
                     : (b.val < a.val ? b.val : a.val);
    else
      s.val = a.real ? a.val : b.val;
    return s;
  }
  __device__ __forceinline__ void write(const State& s, int64_t i, void* out,
                                        uint8_t* out_valid) const {
    out_valid[i] = s.has ? 1 : 0;
    if (vtype == kI32) {
      static_cast<int32_t*>(out)[i] =
          s.has ? static_cast<int32_t>(s.val) : 0;
    } else if (vtype == kI64) {
      static_cast<long long*>(out)[i] =
          s.has ? static_cast<long long>(s.val) : 0;
    } else {
      const double nan = __longlong_as_double(0x7ff8000000000000LL);
      double v = static_cast<double>(s.val);
      if (kIsMax ? s.nan != 0 : s.real == 0) v = nan;
      static_cast<double*>(out)[i] = s.has ? v : 0.0;
    }
  }
};

template <typename St>
struct FPiece {
  St s;
  int32_t start;  // a partition start lies in the piece
};

// a, then b
template <class Op>
__device__ __forceinline__ FPiece<typename Op::State> fjoin(
    const FPiece<typename Op::State>& a, const FPiece<typename Op::State>& b) {
  if (b.start) return b;
  FPiece<typename Op::State> p;
  p.s = Op::join(a.s, b.s);
  p.start = a.start;
  return p;
}

// The join of the pieces of the threads before this one, in thread order
// (a scan in shared memory, log2(256) steps); *total gets the block's.
// Every thread of the block calls it.
template <class Op>
__device__ FPiece<typename Op::State> fblock_exclusive(
    const Op& op, const FPiece<typename Op::State>& x,
    FPiece<typename Op::State>* total) {
  using P = FPiece<typename Op::State>;
  __shared__ P buf[kThreads];
  buf[threadIdx.x] = x;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    P y;
    const bool take = static_cast<int>(threadIdx.x) >= d;
    if (take) y = buf[threadIdx.x - d];
    __syncthreads();
    if (take) buf[threadIdx.x] = fjoin<Op>(y, buf[threadIdx.x]);
    __syncthreads();
  }
  P out;
  if (threadIdx.x == 0) {
    out.s = op.none();
    out.start = 0;
  } else {
    out = buf[threadIdx.x - 1];
  }
  *total = buf[kThreads - 1];
  __syncthreads();  // buf is reused by the next call
  return out;
}

// the physical row of logical position k
__device__ __forceinline__ int64_t phys(int64_t k, int64_t n, int32_t rev) {
  return rev ? n - 1 - k : k;
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
    frame_tiles(Op op, Bounds b, int32_t rev,
                typename Op::State* __restrict__ run,
                uint8_t* __restrict__ run_start,
                FPiece<typename Op::State>* __restrict__ tile_piece) {
  using P = FPiece<typename Op::State>;
  const int64_t n = b.n;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const int64_t first = base + static_cast<int64_t>(threadIdx.x) * kItems;
  const int64_t last = (base + kTile < n ? base + kTile : n) - 1;
  P row[kItems];
  P local;
  local.s = op.none();
  local.start = 0;
  for (int k = 0; k < kItems; ++k) {
    row[k].s = op.none();
    row[k].start = 0;
    const int64_t lk = first + k;
    if (lk >= n) continue;
    const int64_t i = phys(lk, n, rev);
    row[k].s = op.load(i);
    row[k].start = (rev ? b.ends(i) : b.starts(i)) ? 1 : 0;
    local = fjoin<Op>(local, row[k]);
  }
  P total;
  P acc = fblock_exclusive(op, local, &total);
  for (int k = 0; k < kItems; ++k) {
    const int64_t lk = first + k;
    if (lk >= n) break;
    acc = fjoin<Op>(acc, row[k]);
    const int64_t i = phys(lk, n, rev);
    run[i] = acc.s;
    run_start[i] = static_cast<uint8_t>(acc.start);
    if (lk == last) tile_piece[blockIdx.x] = acc;
  }
}

// one block: carry[t] = the state of the rows of tile t's first
// partition that lie in the tiles before t
template <class Op>
__global__ void __launch_bounds__(kThreads)
    frame_carry(Op op, int64_t n_tiles,
                const FPiece<typename Op::State>* __restrict__ tile_piece,
                typename Op::State* __restrict__ carry) {
  using P = FPiece<typename Op::State>;
  P acc;
  acc.s = op.none();
  acc.start = 0;
  for (int64_t start = 0; start < n_tiles; start += kThreads) {
    const int64_t t = start + threadIdx.x;
    P v;
    v.s = op.none();
    v.start = 0;
    if (t < n_tiles) v = tile_piece[t];
    P total;
    const P ex = fblock_exclusive(op, v, &total);
    if (t < n_tiles) carry[t] = fjoin<Op>(acc, ex).s;
    acc = fjoin<Op>(acc, total);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
    frame_fix(int64_t n, int32_t rev, typename Op::State* __restrict__ run,
              const uint8_t* __restrict__ run_start,
              const typename Op::State* __restrict__ carry) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t t = phys(i, n, rev) / kTile;
    if (t > 0 && !run_start[i]) run[i] = Op::join(carry[t], run[i]);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
    frame_take(Op op, Bounds b, int32_t rev, int32_t take, int64_t off,
               const typename Op::State* __restrict__ run,
               void* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < b.n; i += stride) {
    int64_t pos;
    bool empty = false;
    if (take == kTakeRows) {
      const int64_t j = i + off;
      if (rev) {
        empty = j > b.pend(i);
        pos = j > b.pstart(i) ? j : b.pstart(i);
      } else {
        empty = j < b.pstart(i);
        pos = j < b.pend(i) ? j : b.pend(i);
      }
    } else if (take == kTakePeers) {
      pos = b.qend(i);
    } else {
      pos = rev ? b.pstart(i) : b.pend(i);
    }
    op.write(empty ? op.none() : run[pos], i, out, out_valid);
  }
}

template <class Op>
__global__ void __launch_bounds__(kThreads)
    frame_bounded(Op op, Bounds b, int64_t lo, int64_t hi,
                  void* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < b.n; i += stride) {
    const int64_t ps = b.pstart(i), pe = b.pend(i);
    const int64_t a = i + lo > ps ? i + lo : ps;
    const int64_t z = i + hi < pe ? i + hi : pe;
    typename Op::State s = op.none();
    for (int64_t j = a; j <= z; ++j) s = Op::join(s, op.load(j));
    op.write(s, i, out, out_valid);
  }
}

__global__ void __launch_bounds__(kThreads)
    frame_offset(Bounds b, int64_t off, long long* __restrict__ map) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < b.n; i += stride) {
    const int64_t j = i + off;
    map[i] = (j >= b.pstart(i) && j <= b.pend(i)) ? j : -1;
  }
}

__global__ void __launch_bounds__(kThreads)
    frame_ntile(Bounds b, int64_t tiles, int32_t* __restrict__ out) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < b.n; i += stride) {
    const int64_t ps = b.pstart(i);
    const int64_t cnt = b.pend(i) - ps + 1;
    const int64_t pos = i - ps;
    const int64_t base = cnt / tiles, rem = cnt % tiles;
    const int64_t big = rem * (base + 1);  // rows of the larger tiles
    const int64_t tile = pos < big ? pos / (base + 1)
                                   : rem + (pos - big) / (base > 0 ? base : 1);
    out[i] = static_cast<int32_t>(tile + 1);
  }
}

__global__ void __launch_bounds__(kThreads)
    frame_fill(const long long* __restrict__ map, int64_t n,
               void* __restrict__ data, uint8_t* __restrict__ valid,
               int32_t width, long long bits) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (map[i] >= 0) continue;
    if (width == 4)
      static_cast<int32_t*>(data)[i] = static_cast<int32_t>(bits);
    else
      static_cast<long long*>(data)[i] = bits;
    valid[i] = 1;
  }
}

// Calls fn with the op of one function kind and value type.
template <class Fn>
cudaError_t with_op(int32_t kind, int32_t vtype, const void* data,
                    const uint8_t* valid, Fn fn) {
  switch (kind) {
    case kSumF64:
    case kMean:
      return fn(SumOp<double>{kind, data, valid});
    case kSumI64:
    case kCount:
    case kCountAll:
      return fn(SumOp<unsigned long long>{kind, data, valid});
    case kMin:
      if (vtype == kF64) return fn(ExtremeOp<double, false>{vtype, data,
                                                            valid});
      return fn(ExtremeOp<long long, false>{vtype, data, valid});
    case kMax:
      if (vtype == kF64) return fn(ExtremeOp<double, true>{vtype, data,
                                                           valid});
      return fn(ExtremeOp<long long, true>{vtype, data, valid});
    default:
      return cudaErrorInvalidValue;
  }
}

bool valid_frame_args(int32_t kind, int32_t vtype, int64_t n) {
  return kind >= kSumI64 && kind <= kMax && vtype >= kI32 && vtype <= kF64 &&
         n >= 0;
}

Bounds bounds(int64_t n, const void* part_rank, const void* part_first,
              const void* peer_rank, const void* peer_first) {
  return Bounds{static_cast<const int64_t*>(part_rank),
                static_cast<const int64_t*>(part_first),
                static_cast<const int64_t*>(peer_rank),
                static_cast<const int64_t*>(peer_first), n};
}

}  // namespace

// Ranks for the frame kinds.  Keys as keys.cuh takes them: the n_part
// partition keys, then the order keys, n_keys in all.  part_rank: n + 1
// int64, part_first: n int64; peer_rank and peer_first likewise, or null
// when no RANGE frame needs the peer groups; tile_scratch: srt::tiles_for
// (n) int64.
extern "C" int srt_window_bounds(int32_t n_part, int32_t n_keys,
                                 const int32_t* type, const int32_t* off64,
                                 const void* const* data,
                                 const void* const* valid,
                                 const void* const* offsets, int64_t n,
                                 void* part_rank, void* peer_rank,
                                 void* tile_scratch, void* part_first,
                                 void* peer_first, void* stream) {
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
  cudaError_t e = srt::exclusive_scan(parts, n, pr, scratch, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (qr != nullptr) {
    const StartOf peers{srt::make_keys(n_keys, type, off64, data, valid,
                                       offsets)};
    e = srt::exclusive_scan(peers, n, qr, scratch, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  rank_firsts<<<srt::grid_for(n), kThreads, 0, s>>>(
      n, pr, qr, static_cast<int64_t*>(part_first),
      static_cast<int64_t*>(peer_first));
  return static_cast<int>(cudaGetLastError());
}

// K14s: one function over a running frame.  kind: WinKind or FrameKind;
// vtype: ValueType of a min or max input (int32 for int and date).  data:
// int64 for kSumI64, double for kSumF64 and kMean, the vtype for kMin and
// kMax, unread for the counts; valid may be null.  rev: scan the rows in
// reverse (a frame ending at UNBOUNDED FOLLOWING); take: Take, with off
// the row offset of kTakeRows.  peer_rank and peer_first are read only by
// kTakePeers.  out: n values of the result type (int64 for sums of longs
// and counts, double for double sums and means, the vtype for min and
// max); out_valid: n bytes.  Scratch: run, n x kStateBytes; run_start, n
// bytes; tile_piece and carry, kStateBytes per tile of 1024 rows each.
extern "C" int srt_window_running(
    int32_t kind, int32_t vtype, const void* data, const void* valid,
    int64_t n, const void* part_rank, const void* part_first,
    const void* peer_rank, const void* peer_first, int32_t rev, int32_t take,
    int64_t off, void* out, void* out_valid, void* run, void* run_start,
    void* tile_piece, void* carry, void* stream) {
  if (!valid_frame_args(kind, vtype, n) || take < kTakeRows ||
      take > kTakePartition || (take == kTakePeers && rev))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bounds b = bounds(n, part_rank, part_first, peer_rank, peer_first);
  const int64_t tiles = (n + kTile - 1) / kTile;
  uint8_t* ov = static_cast<uint8_t*>(out_valid);
  uint8_t* rs = static_cast<uint8_t*>(run_start);
  return static_cast<int>(with_op(
      kind, vtype, data, static_cast<const uint8_t*>(valid), [&](auto op) {
        using Op = decltype(op);
        using St = typename Op::State;
        using P = FPiece<St>;
        static_assert(sizeof(St) <= kStateBytes && sizeof(P) <= kStateBytes,
                      "a running state fits its scratch");
        St* r = static_cast<St*>(run);
        P* tp = static_cast<P*>(tile_piece);
        St* c = static_cast<St*>(carry);
        frame_tiles<Op><<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
            op, b, rev, r, rs, tp);
        frame_carry<Op><<<1, kThreads, 0, s>>>(op, tiles, tp, c);
        frame_fix<Op><<<srt::grid_for(n), kThreads, 0, s>>>(n, rev, r, rs,
                                                            c);
        frame_take<Op><<<srt::grid_for(n), kThreads, 0, s>>>(
            op, b, rev, take, off, r, out, ov);
        return cudaGetLastError();
      }));
}

// K14b: one function over ROWS BETWEEN lo AND hi (lo <= hi, both finite);
// arguments as srt_window_running's.
extern "C" int srt_window_bounded(int32_t kind, int32_t vtype,
                                  const void* data, const void* valid,
                                  int64_t n, const void* part_rank,
                                  const void* part_first, int64_t lo,
                                  int64_t hi, void* out, void* out_valid,
                                  void* stream) {
  if (!valid_frame_args(kind, vtype, n) || lo > hi)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Bounds b = bounds(n, part_rank, part_first, nullptr, nullptr);
  uint8_t* ov = static_cast<uint8_t*>(out_valid);
  return static_cast<int>(with_op(
      kind, vtype, data, static_cast<const uint8_t*>(valid), [&](auto op) {
        frame_bounded<decltype(op)><<<srt::grid_for(n), kThreads, 0, s>>>(
            op, b, lo, hi, out, ov);
        return cudaGetLastError();
      }));
}

// K14o: map[i] = i + off where that row lies in row i's partition, else
// -1 (lag is a negative off, lead a positive one).  map: n int64.
extern "C" int srt_window_offset(int64_t n, const void* part_rank,
                                 const void* part_first, int64_t off,
                                 void* map, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  frame_offset<<<srt::grid_for(n), kThreads, 0, s>>>(
      bounds(n, part_rank, part_first, nullptr, nullptr), off,
      static_cast<long long*>(map));
  return static_cast<int>(cudaGetLastError());
}

// K14o: ntile(tiles) of each row, int32 (tiles >= 1).
extern "C" int srt_window_ntile(int64_t n, const void* part_rank,
                                const void* part_first, int64_t tiles,
                                void* out, void* stream) {
  if (n < 0 || tiles < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  frame_ntile<<<srt::grid_for(n), kThreads, 0, s>>>(
      bounds(n, part_rank, part_first, nullptr, nullptr), tiles,
      static_cast<int32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

// K14o: a scalar default into the rows whose map entry is -1: data holds
// n values of width 4 or 8 bytes (bits: the default's low width bytes),
// valid n bytes.
extern "C" int srt_window_fill(const void* map, int64_t n, void* data,
                               void* valid, int32_t width, int64_t bits,
                               void* stream) {
  if (n < 0 || (width != 4 && width != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  frame_fill<<<srt::grid_for(n), kThreads, 0, s>>>(
      static_cast<const long long*>(map), n, data,
      static_cast<uint8_t*>(valid), width, bits);
  return static_cast<int>(cudaGetLastError());
}
