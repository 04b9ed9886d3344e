// Kernel K10x: the pairs of a cross join (an n x m cartesian product).
//
// Replaces the JAX package's `join.cross_pairs` program
// (spark_rapids_tpu/ops/join_ops.py:251 cross_pairs, driven from
// exec/joins.py:271 and :493 by TpuBroadcastNestedLoopJoinExec :714).  The
// JAX program fills a power-of-two bucket of candidate pairs and a keep
// mask; here the pair count n * m is exact on the host (both row counts
// are), so the output is sized exactly and needs no mask and no sync.
//
// Pairs are probe-major: pair r is (probe row r / m, build row r % m), so
// the output holds each probe row's pairs together, in build-row order.
// A grid-stride loop writes the two int64 index planes; K7 then gathers
// each side's columns through them.
//
// Bound: device memory bytes: 16 bytes written a pair, nothing read.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(srt::kThreads)
    cross_pairs(int64_t n_probe, int64_t n_build,
                long long* __restrict__ out_probe,
                long long* __restrict__ out_build) {
  const int64_t total = n_probe * n_build;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < total; r += stride) {
    const int64_t p = r / n_build;
    out_probe[r] = p;
    out_build[r] = r - p * n_build;
  }
}

}  // namespace

// out_probe, out_build: n_probe * n_build int64 each (the caller checks
// that the product fits).  Nothing is launched for an empty side.
extern "C" int srt_cross_pairs(int64_t n_probe, int64_t n_build,
                               void* out_probe, void* out_build,
                               void* stream) {
  if (n_probe < 0 || n_build < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_probe == 0 || n_build == 0) return 0;
  cross_pairs<<<srt::grid_for(n_probe * n_build), srt::kThreads, 0,
                static_cast<cudaStream_t>(stream)>>>(
      n_probe, n_build, static_cast<long long*>(out_probe),
      static_cast<long long*>(out_build));
  return static_cast<int>(cudaGetLastError());
}
