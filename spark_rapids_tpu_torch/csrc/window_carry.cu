// Kernel K14c: the running window's carry between the chunks of one
// sorted stream (the chunked running path of exec/window.py, which takes
// over when a window's input does not fit the memory pool).
//
// Replaces the JAX package's `window.running_fixup` program
// (spark_rapids_tpu/exec/window.py:637 _make_running_fixup, applied by
// _apply_carry :585).  K14 (its ranking pass K14r and its running frames
// K14s) has computed each function over the chunk alone; the rows at the
// chunk's head that continue the previous chunk's last partition are then
// shifted by the carried state, and the state advances from the chunk's
// last row:
//   1. fixup_bounds / fixup_bounds_final: a block-parallel min/max
//      reduction, no atomics: L = the first row whose partition keys
//      differ from the carried key row (the JAX program's cumulative
//      `prefix`), Lp = the first row whose partition or order keys differ
//      (`same_peer`), S = the first row of the chunk's last partition
//      group (the last partition start).  Rows are sorted, so the rows
//      continuing the carry are exactly [0, L).  Key equality is
//      keys.cuh keys_equal between the chunk's columns and the carried
//      one-row columns: a null equals a null, doubles by their normalised
//      bits (-0.0 = 0.0, NaN = NaN), strings byte for byte, so two chunks
//      whose strings have other widths still compare as equal strings.
//   2. fixup_rows, a thread a row of [0, L) only: row_number += rows,
//      rank = the carried rank for i < Lp else += rows, dense_rank +=
//      dense - (Lp > 0), count += the carried count, a sum adds the
//      carried sum where that is valid (validity v | (i < L & carried
//      valid)), min and max fold the carried value with NaN the greatest
//      value (the JAX program's _spark_minmax, :627).  The window columns
//      are fixed in place: K14 wrote them for this chunk alone and rows
//      from L on keep their values, so nothing else is read or written.
//      The thread of row n - 1 (thread 0 where n - 1 >= L) writes the
//      next carry: rows = (n - S) + (L == n ? carried rows : 0), the
//      rank, dense rank and each aggregate's value and validity of row
//      n - 1.  The wrapper takes the next carry's key row with K7.
// The first chunk of a stream runs the `first` form: nothing is carried,
// no row changes, only the next carry is written.  The carry never leaves
// the card, so a chunk costs no host sync.  Long sums wrap mod 2^64.
//
// Bound: device memory bytes.  The keys are read once (the bounds pass
// compares each row with its predecessor and the carried row; the first
// form reads the partition keys only), each window column's [0, L) read
// and written once and its row n - 1 read; a few comparisons a row.
#include "keys.cuh"

namespace {

using srt::kThreads;

constexpr int kMaxFuncs = 8;

enum FixKind : int32_t { kRowNumber = 0, kRank = 1, kDenseRank = 2,
                         kSum = 3, kCount = 4, kMin = 5, kMax = 6 };
enum ValueType : int32_t { kInt32 = 0, kInt64 = 1, kFloat64 = 2 };

struct Funcs {
  int32_t n;
  int32_t kind[kMaxFuncs];
  int32_t vtype[kMaxFuncs];
  void* d[kMaxFuncs];  // the window column, fixed in place
  uint8_t* v[kMaxFuncs];
  const void* c_d[kMaxFuncs];  // the carried value (one element)
  const uint8_t* c_v[kMaxFuncs];
  void* n_d[kMaxFuncs];  // the next carry's value
  uint8_t* n_v[kMaxFuncs];
};

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ int64_t lmax(int64_t a, int64_t b) {
  return a > b ? a : b;
}

__global__ void __launch_bounds__(kThreads)
    fixup_bounds(srt::Keys kp, srt::Keys ka, srt::Keys cp, srt::Keys ca,
                 int64_t n, int32_t first, int64_t* partial) {
  int64_t L = n, Lp = n, S = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    // a thread's rows rise, so its first hit is its minimum
    if (!first && L == n && !srt::keys_equal(kp, i, cp, 0)) {
      L = i;
      if (Lp == n) Lp = i;
    }
    if (!first && Lp == n && !srt::keys_equal(ka, i, ca, 0)) Lp = i;
    if (i > 0 && !srt::keys_equal(kp, i - 1, i)) S = i;
  }
  __shared__ int64_t sl[kThreads], slp[kThreads], ss[kThreads];
  sl[threadIdx.x] = L;
  slp[threadIdx.x] = Lp;
  ss[threadIdx.x] = S;
  __syncthreads();
  for (int d = kThreads / 2; d > 0; d >>= 1) {
    if (threadIdx.x < d) {
      sl[threadIdx.x] = lmin(sl[threadIdx.x], sl[threadIdx.x + d]);
      slp[threadIdx.x] = lmin(slp[threadIdx.x], slp[threadIdx.x + d]);
      ss[threadIdx.x] = lmax(ss[threadIdx.x], ss[threadIdx.x + d]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    partial[3 * blockIdx.x] = sl[0];
    partial[3 * blockIdx.x + 1] = slp[0];
    partial[3 * blockIdx.x + 2] = ss[0];
  }
}

// one block: the blocks' partial (L, Lp, S) -> bounds[0..3)
__global__ void __launch_bounds__(kThreads)
    fixup_bounds_final(const int64_t* partial, int32_t blocks, int64_t n,
                       int64_t* bounds) {
  int64_t L = n, Lp = n, S = 0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    L = lmin(L, partial[3 * b]);
    Lp = lmin(Lp, partial[3 * b + 1]);
    S = lmax(S, partial[3 * b + 2]);
  }
  __shared__ int64_t sl[kThreads], slp[kThreads], ss[kThreads];
  sl[threadIdx.x] = L;
  slp[threadIdx.x] = Lp;
  ss[threadIdx.x] = S;
  __syncthreads();
  for (int d = kThreads / 2; d > 0; d >>= 1) {
    if (threadIdx.x < d) {
      sl[threadIdx.x] = lmin(sl[threadIdx.x], sl[threadIdx.x + d]);
      slp[threadIdx.x] = lmin(slp[threadIdx.x], slp[threadIdx.x + d]);
      ss[threadIdx.x] = lmax(ss[threadIdx.x], ss[threadIdx.x + d]);
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    bounds[0] = sl[0];
    bounds[1] = slp[0];
    bounds[2] = ss[0];
  }
}

template <typename T>
__device__ __forceinline__ T add(T a, T b) {
  return a + b;
}

// long sums wrap mod 2^64, as the JAX program's int64 adds do
template <>
__device__ __forceinline__ long long add<long long>(long long a,
                                                    long long b) {
  return static_cast<long long>(static_cast<unsigned long long>(a) +
                                static_cast<unsigned long long>(b));
}

template <typename T>
__device__ __forceinline__ T extreme(bool is_max, T a, T b) {
  return is_max ? (a > b ? a : b) : (a < b ? a : b);
}

// NaN is the greatest value: max keeps a NaN, min drops one
template <>
__device__ __forceinline__ double extreme<double>(bool is_max, double a,
                                                  double b) {
  const bool na = isnan(a), nb = isnan(b);
  if (is_max) return na ? a : (nb ? b : fmax(a, b));
  return na ? b : (nb ? a : fmin(a, b));
}

// aggregate j of row i: fixed in place where `fix`, its value carried
// where `last`
template <typename T>
__device__ __forceinline__ void fix_agg(const Funcs& f, int j, int64_t i,
                                        bool fix, bool last) {
  T* data = static_cast<T*>(f.d[j]);
  const T d = data[i];
  const bool v = f.v[j][i] != 0;
  T d2 = d;
  bool v2 = v;
  if (fix) {
    const T acc = static_cast<const T*>(f.c_d[j])[0];
    const bool acc_v = f.c_v[j][0] != 0;
    const int32_t kind = f.kind[j];
    if (kind == kCount) {
      d2 = add<T>(d, acc);
    } else if (kind == kSum) {
      d2 = add<T>(v ? d : T(0), acc_v ? acc : T(0));
      v2 = v || acc_v;
    } else {
      d2 = (v && acc_v) ? extreme<T>(kind == kMax, d, acc) : (v ? d : acc);
      v2 = v || acc_v;
    }
    data[i] = d2;
    f.v[j][i] = v2;
  }
  if (last) {
    static_cast<T*>(f.n_d[j])[0] = d2;
    f.n_v[j][0] = v2;
  }
}

struct Carried {
  int64_t L, Lp, S;
  long long rows, rank, dense, cont;
};

// row i: fixed where `fix` (i < L), the next carry written where `last`
__device__ __forceinline__ void fix_row(const Funcs& f, int64_t i,
                                        const Carried& c, bool fix,
                                        bool last, int64_t n,
                                        int64_t* n_state) {
  const bool peer = i < c.Lp;
  long long rank_last = 0, dense_last = 0;
  for (int j = 0; j < f.n; ++j) {
    const int32_t kind = f.kind[j];
    if (kind <= kDenseRank) {
      int32_t* data = static_cast<int32_t*>(f.d[j]);
      const int32_t d = data[i];
      long long d2 = d;
      if (fix) {
        if (kind == kRowNumber)
          d2 = d + c.rows;
        else if (kind == kRank)
          d2 = peer ? c.rank : d + c.rows;
        else
          d2 = d + c.dense - c.cont;
        data[i] = static_cast<int32_t>(d2);
      }
      if (kind == kRank) rank_last = d2;
      if (kind == kDenseRank) dense_last = d2;
      continue;
    }
    if (f.vtype[j] == kFloat64)
      fix_agg<double>(f, j, i, fix, last);
    else if (f.vtype[j] == kInt64)
      fix_agg<long long>(f, j, i, fix, last);
    else
      fix_agg<int32_t>(f, j, i, fix, last);
  }
  if (last) {
    n_state[0] = (n - c.S) + (c.L == n ? c.rows : 0);
    n_state[1] = rank_last;
    n_state[2] = dense_last;
  }
}

__global__ void __launch_bounds__(kThreads)
    fixup_rows(Funcs f, int64_t n, int32_t first, const int64_t* bounds,
               const int64_t* c_state, int64_t* n_state) {
  Carried c;
  c.L = first ? 0 : bounds[0];
  c.Lp = first ? 0 : bounds[1];
  c.S = bounds[2];
  c.rows = first ? 0 : c_state[0];
  c.rank = first ? 0 : c_state[1];
  c.dense = first ? 0 : c_state[2];
  c.cont = c.Lp > 0 ? 1 : 0;
  const int64_t g = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = g; i < c.L; i += stride)
    fix_row(f, i, c, true, i == n - 1, n, n_state);
  // row n - 1 outside the prefix keeps its values: thread 0 carries them
  if (g == 0 && c.L < n) fix_row(f, n - 1, c, false, true, n, n_state);
}

}  // namespace

// K14c over one chunk of n rows.  The chunk's n_keys key columns (the
// first n_part the partition keys, then the order keys) as K14 received
// them; the carried one-row key columns c_* of the same types (unread
// when first); per function its kind (FixKind), value type (ValueType;
// the ranking kinds are int32), its window column's planes d/v (n rows,
// fixed in place), the carried value and validity c_d/c_v and the next
// carry's n_d/n_v (one element each; a ranking function's are unused);
// c_state and n_state: the carried and next (rows, rank, dense) as
// int64; scratch: 3 * 132 * 32 + 3 int64.
extern "C" int srt_window_fixup(
    int32_t n_part, int32_t n_keys, const int32_t* type,
    const int32_t* off64, const void* const* data, const void* const* valid,
    const void* const* offsets, const void* const* c_data,
    const void* const* c_valid, const void* const* c_offsets, int64_t n,
    int32_t first, int32_t n_funcs, const int32_t* kind,
    const int32_t* vtype, const void* const* d, const void* const* v,
    const void* const* c_d, const void* const* c_v, const void* const* n_d,
    const void* const* n_v, const void* c_state, void* n_state,
    void* scratch, void* stream) {
  if (n_part < 0 || n_part > n_keys || n_keys > srt::kMaxKeys || n < 0 ||
      n_funcs < 0 || n_funcs > kMaxFuncs)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int c = 0; c < n_keys; ++c)
    if (!srt::valid_key_type(type[c]))
      return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const srt::Keys kp =
      srt::make_keys(n_part, type, off64, data, valid, offsets);
  const srt::Keys ka =
      srt::make_keys(n_keys, type, off64, data, valid, offsets);
  const srt::Keys cp = first ? kp
                             : srt::make_keys(n_part, type, off64, c_data,
                                              c_valid, c_offsets);
  const srt::Keys ca = first ? ka
                             : srt::make_keys(n_keys, type, off64, c_data,
                                              c_valid, c_offsets);
  Funcs f;
  f.n = n_funcs;
  for (int j = 0; j < n_funcs; ++j) {
    if (kind[j] < kRowNumber || kind[j] > kMax || vtype[j] < kInt32 ||
        vtype[j] > kFloat64)
      return static_cast<int>(cudaErrorInvalidValue);
    f.kind[j] = kind[j];
    f.vtype[j] = vtype[j];
    f.d[j] = const_cast<void*>(d[j]);
    f.v[j] = static_cast<uint8_t*>(const_cast<void*>(v[j]));
    f.c_d[j] = first ? nullptr : c_d[j];
    f.c_v[j] = first ? nullptr : static_cast<const uint8_t*>(c_v[j]);
    f.n_d[j] = const_cast<void*>(n_d[j]);
    f.n_v[j] = static_cast<uint8_t*>(const_cast<void*>(n_v[j]));
  }
  int64_t* partial = static_cast<int64_t*>(scratch);
  const unsigned blocks = srt::grid_for(n);
  int64_t* bounds = partial + 3 * srt::kMaxBlocks;
  fixup_bounds<<<blocks, kThreads, 0, s>>>(kp, ka, cp, ca, n, first,
                                           partial);
  fixup_bounds_final<<<1, kThreads, 0, s>>>(
      partial, static_cast<int32_t>(blocks), n, bounds);
  fixup_rows<<<blocks, kThreads, 0, s>>>(
      f, n, first, bounds, static_cast<const int64_t*>(c_state),
      static_cast<int64_t*>(n_state));
  return static_cast<int>(cudaGetLastError());
}
