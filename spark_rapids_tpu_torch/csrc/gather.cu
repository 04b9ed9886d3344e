// Kernel K7: row gather through a gather map.
//
// Replaces the gathers of the JAX package's device programs:
// `join.gather` (spark_rapids_tpu/ops/join_ops.py:335 gather_join_output,
// built at :396), the gathers inside `fused.stage` (exec/fused.py:202) and
// `sort.fused` (ops/sort_ops.py:237), and ops/batch_ops.py:45
// gather_batch.  Output row i is input row idx[i].
//
// Fixed-width planes (1, 2, 4 or 8 bytes a row: data and validity bytes)
// go in one launch, one grid row (blockIdx.y) per plane.  A string column
// takes three steps: output offsets are the exclusive scan of the gathered
// rows' lengths (common.cuh, lengths read through the map on the fly),
// the host learns the chars total where it cannot bound it (the caller's
// one sync), then one warp per row copies its bytes, lanes striding the
// row.  Output offsets are int64; input offsets int32 or int64.
//
// Bound: device memory bytes.  It reads the map and each gathered value
// once and writes each output value once; the rows it reads are scattered,
// so a row of a narrow plane costs a 32-byte sector.
#include "common.cuh"

namespace {

using srt::kThreads;

constexpr int kMaxPlanes = 32;

struct Planes {
  const void* src[kMaxPlanes];
  void* dst[kMaxPlanes];
  int32_t width[kMaxPlanes];
};

__global__ void __launch_bounds__(kThreads)
    gather_fixed(const int64_t* __restrict__ idx, int64_t n, Planes p) {
  const int plane = blockIdx.y;
  const int w = p.width[plane];
  const void* src = p.src[plane];
  void* dst = p.dst[plane];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t r = idx[i];
    switch (w) {
      case 8:
        static_cast<int64_t*>(dst)[i] = static_cast<const int64_t*>(src)[r];
        break;
      case 4:
        static_cast<int32_t*>(dst)[i] = static_cast<const int32_t*>(src)[r];
        break;
      case 2:
        static_cast<int16_t*>(dst)[i] = static_cast<const int16_t*>(src)[r];
        break;
      default:
        static_cast<uint8_t*>(dst)[i] = static_cast<const uint8_t*>(src)[r];
    }
  }
}

template <typename Off>
struct GatheredLength {
  const int64_t* idx;
  const Off* off;
  __device__ __forceinline__ long long operator()(int64_t i) const {
    const int64_t r = idx[i];
    return static_cast<long long>(off[r + 1]) - static_cast<long long>(off[r]);
  }
};

template <typename Off>
__global__ void __launch_bounds__(kThreads)
    gather_chars(const int64_t* __restrict__ idx, int64_t n,
                 const Off* __restrict__ src_off,
                 const uint8_t* __restrict__ src,
                 const int64_t* __restrict__ dst_off,
                 uint8_t* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (static_cast<int64_t>(gridDim.x) * blockDim.x) >> 5;
  for (int64_t i = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x) >> 5;
       i < n; i += warps) {
    const int64_t r = idx[i];
    const int64_t s = src_off[r];
    const int64_t len = static_cast<int64_t>(src_off[r + 1]) - s;
    const int64_t d = dst_off[i];
    for (int64_t b = lane; b < len; b += 32) dst[d + b] = src[s + b];
  }
}

}  // namespace

extern "C" int srt_gather_fixed(const void* idx, int64_t n, int32_t n_planes,
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
  gather_fixed<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(idx), n, p);
  return static_cast<int>(cudaGetLastError());
}

// dst_off[0..n] = exclusive scan of the gathered rows' lengths (dst_off[n]
// is the chars total).  tile_scratch: srt::tiles_for(n) int64.
extern "C" int srt_gather_string_offsets(const void* idx, int64_t n,
                                         const void* src_off, int32_t off64,
                                         void* dst_off, void* tile_scratch,
                                         void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* map = static_cast<const int64_t*>(idx);
  int64_t* out = static_cast<int64_t*>(dst_off);
  int64_t* tiles = static_cast<int64_t*>(tile_scratch);
  cudaError_t err;
  if (off64)
    err = srt::exclusive_scan(
        GatheredLength<int64_t>{map, static_cast<const int64_t*>(src_off)},
        n, out, tiles, s);
  else
    err = srt::exclusive_scan(
        GatheredLength<int32_t>{map, static_cast<const int32_t*>(src_off)},
        n, out, tiles, s);
  return static_cast<int>(err);
}

extern "C" int srt_gather_string_chars(const void* idx, int64_t n,
                                       const void* src_off, int32_t off64,
                                       const void* src_chars,
                                       const void* dst_off, void* dst_chars,
                                       void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const unsigned grid = srt::grid_for(n * 32);
  if (off64)
    gather_chars<int64_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int64_t*>(idx), n,
        static_cast<const int64_t*>(src_off),
        static_cast<const uint8_t*>(src_chars),
        static_cast<const int64_t*>(dst_off),
        static_cast<uint8_t*>(dst_chars));
  else
    gather_chars<int32_t><<<grid, kThreads, 0, s>>>(
        static_cast<const int64_t*>(idx), n,
        static_cast<const int32_t*>(src_off),
        static_cast<const uint8_t*>(src_chars),
        static_cast<const int64_t*>(dst_off),
        static_cast<uint8_t*>(dst_chars));
  return static_cast<int>(cudaGetLastError());
}
