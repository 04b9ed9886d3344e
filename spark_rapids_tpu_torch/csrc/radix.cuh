// Stable LSD radix sort of row indices by unsigned 64-bit words, 8 bits a
// pass; shared by the sort (sort.cu) and the keyed aggregation
// (keyed_agg.cu).
//
// Words are given most significant first, each with the number of low bits
// that can be non-zero, so a 1-bit null-rank word takes one pass and an int
// key 4.  A pass reads each element's digit through the current
// permutation (words stay in row order) and has three launches:
//   radix_hist        one 256-element tile per block: digit counts of the
//                     tile (shared-memory atomics on integers: exact);
//   radix_digit_scan  one block per digit: exclusive scan of that digit's
//                     counts across tiles, and the digit's total;
//   radix_scatter     each block scans the 256 digit totals for the digit
//                     bases, ranks its elements within the tile stably
//                     (warp __match_any_sync peers, then the counts of the
//                     warps before), and writes the permutation.
// Every pass is stable, so equal words keep their input order.
#pragma once

#include "common.cuh"

namespace srt {

constexpr int kRadixTile = kThreads;  // one element per thread
constexpr int kDigits = 256;
static_assert(kThreads == kDigits, "one thread per digit in the scans");

__global__ void __launch_bounds__(kThreads)
    radix_iota(long long* perm, int64_t n) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride)
    perm[i] = i;
}

__global__ void __launch_bounds__(kThreads)
    radix_hist(const uint64_t* __restrict__ word,
               const long long* __restrict__ perm, int64_t n, int shift,
               int32_t* __restrict__ hist, int64_t n_tiles) {
  __shared__ int32_t h[kDigits];
  h[threadIdx.x] = 0;
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRadixTile +
                    threadIdx.x;
  if (i < n) atomicAdd(&h[(word[perm[i]] >> shift) & 0xff], 1);
  __syncthreads();
  hist[static_cast<int64_t>(threadIdx.x) * n_tiles + blockIdx.x] =
      h[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
    radix_digit_scan(int32_t* __restrict__ hist, int64_t n_tiles,
                     int64_t* __restrict__ digit_total) {
  int32_t* row = hist + static_cast<int64_t>(blockIdx.x) * n_tiles;
  long long carry = 0;
  for (int64_t start = 0; start < n_tiles; start += kThreads) {
    const int64_t i = start + threadIdx.x;
    const long long v = i < n_tiles ? row[i] : 0;
    long long t;
    const long long ex = block_exclusive_scan(v, &t);
    if (i < n_tiles) row[i] = static_cast<int32_t>(carry + ex);
    carry += t;
  }
  if (threadIdx.x == 0) digit_total[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(kThreads)
    radix_scatter(const uint64_t* __restrict__ word,
                  const long long* __restrict__ perm_in, int64_t n,
                  int shift, const int32_t* __restrict__ hist,
                  const int64_t* __restrict__ digit_total, int64_t n_tiles,
                  long long* __restrict__ perm_out) {
  __shared__ long long digit_base[kDigits];
  __shared__ int32_t warp_counts[kThreads / 32][kDigits];
  long long total;
  digit_base[threadIdx.x] = block_exclusive_scan(digit_total[threadIdx.x],
                                                 &total);
  for (int w = 0; w < kThreads / 32; ++w) warp_counts[w][threadIdx.x] = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kRadixTile +
                    threadIdx.x;
  const bool active = i < n;
  const long long src = active ? perm_in[i] : 0;
  const unsigned d = active ? static_cast<unsigned>((word[src] >> shift) &
                                                    0xff)
                            : 0u;
  const unsigned active_mask = __ballot_sync(0xffffffffu, active);
  int rank = 0;
  if (active) {
    const unsigned peers = __match_any_sync(active_mask, d);
    rank = __popc(peers & ((1u << lane) - 1u));
    if (lane == __ffs(peers) - 1) warp_counts[warp][d] = __popc(peers);
  }
  __syncthreads();
  if (!active) return;
  int before = 0;
  for (int w = 0; w < warp; ++w) before += warp_counts[w][d];
  const long long pos = digit_base[d] +
                        hist[static_cast<int64_t>(d) * n_tiles + blockIdx.x] +
                        before + rank;
  perm_out[pos] = src;
}

inline int64_t radix_tiles(int64_t n) {
  return (n + kRadixTile - 1) / kRadixTile;
}

// Sorts row indices 0..n-1 by words[0..n_words) (most significant first;
// bits[w] low bits of word w may be non-zero) into perm_out.  Scratch:
// perm_tmp (n int64), hist (256 * radix_tiles(n) int32), digit_total (256
// int64).
inline cudaError_t radix_sort(const uint64_t* const* words, const int* bits,
                              int n_words, int64_t n, long long* perm_out,
                              long long* perm_tmp, int32_t* hist,
                              int64_t* digit_total, cudaStream_t s) {
  int passes = 0;
  for (int w = 0; w < n_words; ++w) passes += (bits[w] + 7) / 8;
  long long* cur = passes % 2 == 0 ? perm_out : perm_tmp;
  long long* other = cur == perm_out ? perm_tmp : perm_out;
  if (n == 0) return cudaSuccess;
  radix_iota<<<grid_for(n), kThreads, 0, s>>>(cur, n);
  const int64_t tiles = radix_tiles(n);
  for (int w = n_words - 1; w >= 0; --w) {
    for (int shift = 0; shift < bits[w]; shift += 8) {
      radix_hist<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          words[w], cur, n, shift, hist, tiles);
      radix_digit_scan<<<kDigits, kThreads, 0, s>>>(hist, tiles,
                                                    digit_total);
      radix_scatter<<<static_cast<unsigned>(tiles), kThreads, 0, s>>>(
          words[w], cur, n, shift, hist, digit_total, tiles, other);
      long long* t = cur;
      cur = other;
      other = t;
    }
  }
  return cudaGetLastError();
}

}  // namespace srt
