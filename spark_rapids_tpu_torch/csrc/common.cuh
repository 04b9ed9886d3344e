// Device helpers shared by the port's CUDA kernels (gather, hash join,
// keyed aggregation, sort): a block-wide exclusive scan, a device-wide
// exclusive scan of int64 values in three passes, murmur3's 64-bit
// finalizer, and the grid size of a grid-stride loop.
//
// The device-wide scan reads its values through a functor, so a caller can
// scan values it computes on the fly (string lengths through a gather map,
// 0/1 flags) without writing them out first.  Tiles are 1024 values: 256
// threads, each taking the values i = tile * 1024 + k * 256 + t for k < 4,
// so loads are coalesced and a block scans its tile in row order with four
// block scans.  Pass 1 writes one sum per tile, pass 2 (one block) scans
// the tile sums and writes the grand total, pass 3 scans each tile again
// and adds its tile's offset.  No atomics: the result does not depend on
// timing.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace srt {

constexpr int kThreads = 256;
constexpr int kScanItems = 4;
constexpr int kScanTile = kThreads * kScanItems;
// blocks of a grid-stride loop: enough to fill 132 SMs many times over
constexpr int64_t kMaxBlocks = 132 * 32;

inline unsigned grid_for(int64_t n, int threads = kThreads) {
  int64_t blocks = (n + threads - 1) / threads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  return static_cast<unsigned>(blocks);
}

inline unsigned tiles_for(int64_t n) {
  return static_cast<unsigned>((n + kScanTile - 1) / kScanTile);
}

__device__ __forceinline__ uint64_t fmix64(uint64_t h) {
  h ^= h >> 33;
  h *= 0xff51afd7ed558ccdULL;
  h ^= h >> 33;
  h *= 0xc4ceb9fe1a85ec53ULL;
  h ^= h >> 33;
  return h;
}

// Exclusive prefix of `v` over the block's threads in thread order; the
// block's total goes to *total.  Every thread of the block must call it.
__device__ __forceinline__ long long block_exclusive_scan(long long v,
                                                          long long* total) {
  __shared__ long long warp_sums[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  long long x = v;
  for (int d = 1; d < 32; d <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = lane < kThreads / 32 ? warp_sums[lane] : 0;
    for (int d = 1; d < 32; d <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w += y;
    }
    if (lane < kThreads / 32) warp_sums[lane] = w;
  }
  __syncthreads();
  const long long before = warp ? warp_sums[warp - 1] : 0;
  *total = warp_sums[kThreads / 32 - 1];
  __syncthreads();  // warp_sums is reused by the next call
  return before + x - v;
}

// values of an int64 array
struct ArrayValues {
  const int64_t* p;
  __device__ __forceinline__ long long operator()(int64_t i) const {
    return p[i];
  }
};

template <class F>
__global__ void __launch_bounds__(kThreads)
    scan_tile_sums(F f, int64_t n, int64_t* tile_sums) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long s = 0;
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    if (i < n) s += f(i);
  }
  long long total;
  block_exclusive_scan(s, &total);
  if (threadIdx.x == 0) tile_sums[blockIdx.x] = total;
}

// one block: tile sums -> exclusive tile offsets in place; *total_out gets
// the grand total
__global__ void __launch_bounds__(kThreads)
    scan_tile_offsets(int64_t* tile_sums, int64_t n_tiles,
                      int64_t* total_out) {
  long long carry = 0;
  for (int64_t start = 0; start < n_tiles; start += kThreads) {
    const int64_t i = start + threadIdx.x;
    const long long v = i < n_tiles ? tile_sums[i] : 0;
    long long t;
    const long long ex = block_exclusive_scan(v, &t);
    if (i < n_tiles) tile_sums[i] = carry + ex;
    carry += t;
  }
  if (threadIdx.x == 0) *total_out = carry;
}

template <class F>
__global__ void __launch_bounds__(kThreads)
    scan_write(F f, int64_t n, const int64_t* tile_offsets, int64_t* out) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long carry = tile_offsets[blockIdx.x];
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    const long long v = i < n ? f(i) : 0;
    long long t;
    const long long ex = block_exclusive_scan(v, &t);
    if (i < n) out[i] = carry + ex;
    carry += t;
  }
}

// out[0..n) = exclusive prefix sums of f(0..n), out[n] = the total.
// `tile_scratch` holds tiles_for(n) int64.  `out` may be the array f
// reads, when f(i) reads only element i: each element is read before it
// is written, by the one thread that writes it.
template <class F>
inline cudaError_t exclusive_scan(F f, int64_t n, int64_t* out,
                                  int64_t* tile_scratch, cudaStream_t s) {
  if (n == 0) return cudaMemsetAsync(out, 0, sizeof(int64_t), s);
  const unsigned tiles = tiles_for(n);
  scan_tile_sums<<<tiles, kThreads, 0, s>>>(f, n, tile_scratch);
  scan_tile_offsets<<<1, kThreads, 0, s>>>(tile_scratch, tiles, out + n);
  scan_write<<<tiles, kThreads, 0, s>>>(f, n, tile_scratch, out);
  return cudaGetLastError();
}

}  // namespace srt
