// Kernel 2: global reduction of aggregation buffer rows.
//
// Replaces the JAX package's `agg.global` program
// (spark_rapids_tpu/ops/agg_ops.py:223 _global_aggregate, whose body is
// global_agg_trace :259 with _global_reduce :159) for the kinds sum, count,
// min and max.  It serves twice on the main path: it folds kernel 1's
// per-block partial rows into one partial row per partition, and it merges
// the partitions' partial rows in the FINAL aggregate.
//
// Layout: `values` is [n_rows, n_cols] of 8-byte words, row-major (int64
// as is, double as its bits); `valid` is [n_rows, n_cols] bytes (0 or 1);
// `kinds` holds one Kind per column.  Output: one word and one validity
// byte per column.
//
// Design: one block per column; each thread folds rows tid, tid + 256, ...
// in order, then a fixed-shape tree in shared memory combines the threads.
// The order of every addition is fixed, so results do not depend on run
// order.  No atomics.
//
// Bound: it reads 9 bytes per cell once, so it is bound by device memory
// bytes; on the main path it sees a few tens of thousands of rows, and
// launch latency dominates.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

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
};

struct KindTable {
  int32_t kind[kMaxCols];
};

struct Acc {
  unsigned long long u;  // int64 sums wrap: added as unsigned
  long long i;           // int64 min / max
  double f;              // double sum, or min / max over non-NaN values
  int any;               // a valid row was seen
  int nan;               // a valid NaN was seen
  int num;               // a valid non-NaN double was seen
};

__device__ __forceinline__ Acc identity(int kind) {
  Acc a;
  a.u = 0ULL;
  a.i = kind == kMinI64 ? INT64_MAX : INT64_MIN;
  a.f = kind == kMinF64 ? INFINITY : (kind == kMaxF64 ? -INFINITY : 0.0);
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
      } else if (kind == kMinF64) {
        a.num = 1;
        a.f = x < a.f ? x : a.f;
      } else {
        a.num = 1;
        a.f = x > a.f ? x : a.f;
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
      a.i = b.i < a.i ? b.i : a.i;
      break;
    case kMaxI64:
      a.i = b.i > a.i ? b.i : a.i;
      break;
    case kSumF64:
      a.f += b.f;
      break;
    case kMinF64:
      a.f = b.f < a.f ? b.f : a.f;
      break;
    default:
      a.f = b.f > a.f ? b.f : a.f;
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
  Acc acc = identity(kind);
  for (int64_t r = threadIdx.x; r < n_rows; r += kThreads) {
    const int64_t idx = r * n_cols + col;
    if (valid[idx]) add_word(acc, values[idx], kind);
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
    default: {
      // max: any NaN wins; min: NaN only when every valid value is NaN
      const bool to_nan = kind == kMaxF64 ? a.nan : (a.nan && !a.num);
      word = __double_as_longlong(to_nan ? NAN : a.f);
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
  for (int64_t c = 0; c < n_cols; ++c) table.kind[c] = kinds[c];
  global_reduce_kernel<<<static_cast<unsigned>(n_cols), kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(values),
      static_cast<const uint8_t*>(valid), n_rows, n_cols, table,
      static_cast<int64_t*>(out), static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
