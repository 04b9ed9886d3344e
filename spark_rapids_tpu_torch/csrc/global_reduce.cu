// Kernel 2: global reduction of aggregation buffer rows.
//
// Replaces the JAX package's `agg.global` program
// (spark_rapids_tpu/ops/agg_ops.py:223 _global_aggregate, whose body is
// global_agg_trace :259 with _global_reduce :159) for the kinds sum,
// count, min, max, first, last, first_valid and last_valid.  It serves
// twice on the main path: it folds kernel 1's per-block partial rows into
// one partial row per partition, and it merges the partitions' partial
// rows in the FINAL aggregate.
//
// Layout: `values` is [n_rows, n_cols] of 8-byte words, row-major (int64
// as is, double as its bits); `valid` is [n_rows, n_cols] bytes (0 or 1);
// `kinds` holds one Kind per column.  Output: one word and one validity
// byte per column.
//
// Min and max of doubles compare each value's bits mapped to an int64
// that orders as the double does (f64_order), so -0.0 is below 0.0 in
// every order of the rows, as the JAX device path's jnp.min and jnp.max
// give them; NaN is kept apart as a flag (Spark: NaN is greater than
// every other value).  First and last take the word of the first or last
// row (whatever its validity: the JAX `first` merge kind takes the first
// buffer row even where its value is null), first_valid and last_valid
// that of the first or last valid row; each thread keeps the least or
// greatest row it saw, and the tree keeps the least or greatest of those.
//
// Design: one block per column; each thread folds rows tid, tid + 256, ...
// in order, then a fixed-shape tree in shared memory combines the threads.
// The order of every addition is fixed, so results do not depend on run
// order.  No atomics.
//
// Bound: by device memory bytes.  Sum, min and max need 9 bytes per cell,
// count the validity byte alone; first_valid and last_valid need the
// validity bytes and the picked row's word, first and last the picked
// row's word and validity alone.  On the main path it sees a few tens of thousands of
// rows, and launch latency dominates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "decimal.cuh"

namespace {

using srt::f64_order;

constexpr int kThreads = 256;
constexpr int kMaxCols = 64;

enum Kind : int32_t {
  kSumI64 = 0,
  kSumF64 = 1,
  kCount = 2,
  kMinI64 = 3,
  kMaxI64 = 4,
  kMinF64 = 5,  // NaN is greater than every other value (Spark)
  kMaxF64 = 6,
  kFirst = 7,       // the first row's word and validity
  kLast = 8,        // the last row's
  kFirstValid = 9,  // the first valid row's
  kLastValid = 10,  // the last valid row's
  kSumDec128 = 11,  // a decimal128 sum: this column hi, the next lo
  kDec128Lo = 12,   // the lo word of the column before (written there)
};

__device__ __forceinline__ bool first_kind(int kind) {
  return kind == kFirst || kind == kFirstValid;
}

__device__ __forceinline__ bool row_kind(int kind) {
  return kind >= kFirst && kind <= kLastValid;
}

struct KindTable {
  int32_t kind[kMaxCols];
};

struct Acc {
  unsigned long long u;  // int64 sums wrap: added as unsigned
  long long i;           // int64 min / max; a double's f64_order min /
                         // max over non-NaN values; a row-order kind's row
  double f;              // double sum
  srt::u128 w;           // decimal128 sum (wraps)
  int any;               // a valid row was seen
  int nan;               // a valid NaN was seen
  int num;               // a valid non-NaN double was seen
};

__device__ __forceinline__ Acc identity(int kind) {
  Acc a;
  a.u = 0ULL;
  a.i = (kind == kMinI64 || kind == kMinF64 || first_kind(kind))
            ? INT64_MAX
            : (row_kind(kind) ? -1LL : INT64_MIN);
  a.f = 0.0;
  a.w = 0;
  a.any = 0;
  a.nan = 0;
  a.num = 0;
  return a;
}

__device__ __forceinline__ void add_word(Acc& a, int64_t word, int kind) {
  a.any = 1;
  switch (kind) {
    case kSumI64:
      a.u += static_cast<unsigned long long>(word);
      break;
    case kCount:
      a.u += 1ULL;
      break;
    case kMinI64:
      a.i = word < a.i ? word : a.i;
      break;
    case kMaxI64:
      a.i = word > a.i ? word : a.i;
      break;
    default: {
      const double x = __longlong_as_double(word);
      if (kind == kSumF64) {
        a.f += x;
      } else if (isnan(x)) {
        a.nan = 1;
      } else {
        a.num = 1;
        const long long o = f64_order(word);
        if (kind == kMinF64)
          a.i = o < a.i ? o : a.i;
        else
          a.i = o > a.i ? o : a.i;
      }
    }
  }
}

__device__ __forceinline__ void combine(Acc& a, const Acc& b, int kind) {
  a.any |= b.any;
  a.nan |= b.nan;
  a.num |= b.num;
  switch (kind) {
    case kSumI64:
    case kCount:
      a.u += b.u;
      break;
    case kMinI64:
    case kMinF64:
    case kFirst:
    case kFirstValid:
      a.i = b.i < a.i ? b.i : a.i;
      break;
    case kSumF64:
      a.f += b.f;
      break;
    case kSumDec128:
      a.w += b.w;
      break;
    default:  // max kinds, last kinds
      a.i = b.i > a.i ? b.i : a.i;
  }
}

__global__ void __launch_bounds__(kThreads)
    global_reduce_kernel(const int64_t* __restrict__ values,
                         const uint8_t* __restrict__ valid, int64_t n_rows,
                         int64_t n_cols, KindTable kinds,
                         int64_t* __restrict__ out,
                         uint8_t* __restrict__ out_valid) {
  __shared__ Acc partial[kThreads];
  const int col = blockIdx.x;
  const int kind = kinds.kind[col];
  if (kind == kDec128Lo) return;  // written by the column before
  Acc acc = identity(kind);
  if (kind == kSumDec128) {
    for (int64_t r = threadIdx.x; r < n_rows; r += kThreads) {
      const int64_t idx = r * n_cols + col;
      if (!valid[idx]) continue;
      acc.any = 1;
      acc.w += (static_cast<srt::u128>(static_cast<uint64_t>(values[idx]))
                << 64) |
               static_cast<srt::u128>(static_cast<uint64_t>(values[idx + 1]));
    }
  } else if (row_kind(kind)) {
    // the least or greatest row this thread sees that the kind counts
    const bool any_row = kind == kFirst || kind == kLast;
    for (int64_t r = threadIdx.x; r < n_rows; r += kThreads) {
      if (!any_row && !valid[r * n_cols + col]) continue;
      if (first_kind(kind)) {
        acc.i = r < acc.i ? r : acc.i;
      } else {
        acc.i = r > acc.i ? r : acc.i;
      }
    }
  } else {
    for (int64_t r = threadIdx.x; r < n_rows; r += kThreads) {
      const int64_t idx = r * n_cols + col;
      if (valid[idx]) add_word(acc, values[idx], kind);
    }
  }
  partial[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride)
      combine(partial[threadIdx.x], partial[threadIdx.x + stride], kind);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  const Acc a = partial[0];
  int64_t word;
  uint8_t ok = static_cast<uint8_t>(a.any);
  switch (kind) {
    case kSumI64:
      word = static_cast<int64_t>(a.u);
      break;
    case kCount:
      word = static_cast<int64_t>(a.u);
      ok = 1;
      break;
    case kMinI64:
    case kMaxI64:
      word = a.i;
      break;
    case kSumF64:
      word = __double_as_longlong(a.f);
      break;
    case kSumDec128:
      word = static_cast<int64_t>(static_cast<uint64_t>(a.w >> 64));
      out[col + 1] = static_cast<int64_t>(static_cast<uint64_t>(a.w));
      out_valid[col + 1] = ok;
      break;
    case kMinF64:
    case kMaxF64: {
      // max: any NaN wins; min: NaN only when every valid value is NaN
      const bool to_nan = kind == kMaxF64 ? a.nan : (a.nan && !a.num);
      word = to_nan ? __double_as_longlong(NAN) : f64_order(a.i);
      break;
    }
    default: {
      // a row-order kind: the picked row's word and validity, if any
      const bool found = a.i >= 0 && a.i < n_rows;
      word = found ? values[a.i * n_cols + col] : 0;
      ok = found ? valid[a.i * n_cols + col] : 0;
    }
  }
  out[col] = word;
  out_valid[col] = ok;
}

}  // namespace

extern "C" int srt_global_reduce(const void* values, const void* valid,
                                 int64_t n_rows, int64_t n_cols,
                                 const int32_t* kinds, void* out,
                                 void* out_valid, void* stream) {
  if (n_cols <= 0 || n_cols > kMaxCols || n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  KindTable table;
  for (int64_t c = 0; c < n_cols; ++c) {
    if (kinds[c] < kSumI64 || kinds[c] > kDec128Lo ||
        (kinds[c] == kSumDec128) !=
            (c + 1 < n_cols && kinds[c + 1] == kDec128Lo) ||
        (kinds[c] == kDec128Lo && (c == 0 || kinds[c - 1] != kSumDec128)))
      return static_cast<int>(cudaErrorInvalidValue);
    table.kind[c] = kinds[c];
  }
  global_reduce_kernel<<<static_cast<unsigned>(n_cols), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(values),
      static_cast<const uint8_t*>(valid), n_rows, n_cols, table,
      static_cast<int64_t*>(out), static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
