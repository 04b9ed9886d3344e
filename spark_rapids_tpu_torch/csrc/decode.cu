// Kernel K16: decode of dictionary-encoded and run-length-encoded columns.
//
// Replaces the JAX package's encoding.decode programs
// (spark_rapids_tpu/columnar/encoding.py: materialize :382, built at :402
// over decode_dictionary :337, and at :416 over decode_rle :358).  Those
// gather padded value planes by code with jnp.take; here each form writes
// its output at its exact size:
//
//   srt_decode_fixed  -- a dictionary of fixed-width values (1, 2, 4 or 8
//     bytes: bool, int, date, long, double): one thread a row,
//     out[i] = valid[i] && vvalid[code] ? values[code] : 0;
//   srt_decode_sizes, srt_decode_chars -- a dictionary of strings, in
//     three steps as K13 writes strings: a sizes pass writes each row's
//     length (0 for a null row) into out_offsets[i], common.cuh's tiled
//     scan turns the lengths into offsets in place and writes the total at
//     out_offsets[n]; the host reads it (one counted read) to size the
//     chars plane; then a write pass copies each row's bytes;
//   srt_decode_rle -- runs of fixed-width values: each row finds its run
//     by a binary search over the runs' exclusive ends (the first run whose
//     end exceeds the row); a null run gives zeroed rows.
//
// Codes are int32 on the card.  A code outside the dictionary is a null
// row, so an empty dictionary (every row null) needs no dummy value.
// Null rows have zeroed data (and length 0), the JAX invariant.
//
// Bound: device memory bytes -- codes and validity read once, each output
// value (or byte) written once, each value it copies read once (the
// dictionary itself is small and stays in L2); the string form reads the
// codes and value offsets twice (sizes and write pass).  A thread a row
// copies a string byte by byte; a warp per long row is a later step.
#include "common.cuh"

namespace {

using srt::kThreads;

__device__ __forceinline__ bool row_present(const int32_t* codes,
                                            const uint8_t* valid,
                                            const uint8_t* vvalid,
                                            int64_t n_values, int64_t i,
                                            int32_t* code) {
  const int32_t c = codes[i];
  *code = c;
  if (valid != nullptr && !valid[i]) return false;
  if (c < 0 || static_cast<int64_t>(c) >= n_values) return false;
  return vvalid == nullptr || vvalid[c] != 0;
}

template <class V>
__global__ void __launch_bounds__(kThreads)
    decode_fixed(const int32_t* __restrict__ codes,
                 const uint8_t* __restrict__ valid, int64_t n,
                 const V* __restrict__ values,
                 const uint8_t* __restrict__ vvalid, int64_t n_values,
                 V* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int32_t c;
    const bool ok = row_present(codes, valid, vvalid, n_values, i, &c);
    out[i] = ok ? values[c] : V(0);
    out_valid[i] = ok ? 1 : 0;
  }
}

__device__ __forceinline__ int64_t value_offset(const void* offsets,
                                                int32_t off64, int64_t j) {
  return off64 ? static_cast<const int64_t*>(offsets)[j]
               : static_cast<int64_t>(static_cast<const int32_t*>(offsets)[j]);
}

__global__ void __launch_bounds__(kThreads)
    decode_sizes(const int32_t* __restrict__ codes,
                 const uint8_t* __restrict__ valid, int64_t n,
                 const void* __restrict__ voffsets, int32_t off64,
                 const uint8_t* __restrict__ vvalid, int64_t n_values,
                 int64_t* __restrict__ out_offsets,
                 uint8_t* __restrict__ out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    int32_t c;
    const bool ok = row_present(codes, valid, vvalid, n_values, i, &c);
    out_offsets[i] = ok ? value_offset(voffsets, off64, c + 1) -
                              value_offset(voffsets, off64, c)
                        : 0;
    out_valid[i] = ok ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    decode_chars(const int32_t* __restrict__ codes, int64_t n,
                 const void* __restrict__ voffsets, int32_t off64,
                 const uint8_t* __restrict__ vchars,
                 const uint8_t* __restrict__ out_valid,
                 const int64_t* __restrict__ out_offsets,
                 uint8_t* __restrict__ out_chars) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (!out_valid[i]) continue;
    const int64_t start = out_offsets[i];
    const int64_t len = out_offsets[i + 1] - start;
    const uint8_t* src = vchars + value_offset(voffsets, off64, codes[i]);
    uint8_t* dst = out_chars + start;
    for (int64_t b = 0; b < len; ++b) dst[b] = src[b];
  }
}

template <class V>
__global__ void __launch_bounds__(kThreads)
    decode_rle(const V* __restrict__ run_values,
               const uint8_t* __restrict__ run_valid,
               const int32_t* __restrict__ run_ends, int64_t n_runs,
               int64_t n, V* __restrict__ out,
               uint8_t* __restrict__ out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    // the first run whose exclusive end exceeds i
    int64_t lo = 0, hi = n_runs;
    while (lo < hi) {
      const int64_t mid = (lo + hi) >> 1;
      if (static_cast<int64_t>(run_ends[mid]) <= i)
        lo = mid + 1;
      else
        hi = mid;
    }
    const bool ok =
        lo < n_runs && (run_valid == nullptr || run_valid[lo] != 0);
    out[i] = ok ? run_values[lo] : V(0);
    out_valid[i] = ok ? 1 : 0;
  }
}

template <class V>
cudaError_t launch_fixed(const void* codes, const void* valid, int64_t n,
                         const void* values, const void* vvalid,
                         int64_t n_values, void* out, void* out_valid,
                         cudaStream_t s) {
  decode_fixed<V><<<srt::grid_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(codes), static_cast<const uint8_t*>(valid),
      n, static_cast<const V*>(values), static_cast<const uint8_t*>(vvalid),
      n_values, static_cast<V*>(out), static_cast<uint8_t*>(out_valid));
  return cudaGetLastError();
}

template <class V>
cudaError_t launch_rle(const void* run_values, const void* run_valid,
                       const void* run_ends, int64_t n_runs, int64_t n,
                       void* out, void* out_valid, cudaStream_t s) {
  decode_rle<V><<<srt::grid_for(n), kThreads, 0, s>>>(
      static_cast<const V*>(run_values),
      static_cast<const uint8_t*>(run_valid),
      static_cast<const int32_t*>(run_ends), n_runs, n, static_cast<V*>(out),
      static_cast<uint8_t*>(out_valid));
  return cudaGetLastError();
}

}  // namespace

// Fixed-width dictionary decode.  codes: n int32; valid: n bytes or null
// (every row valid); values: n_values values of `width` bytes (1, 2, 4
// or 8); vvalid: n_values bytes or null; out: n values of `width` bytes;
// out_valid: n bytes.
extern "C" int srt_decode_fixed(const void* codes, const void* valid,
                                int64_t n, const void* values,
                                const void* vvalid, int64_t n_values,
                                int32_t width, void* out, void* out_valid,
                                void* stream) {
  if (n < 0 || n_values < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1:
      return static_cast<int>(launch_fixed<uint8_t>(
          codes, valid, n, values, vvalid, n_values, out, out_valid, s));
    case 2:
      return static_cast<int>(launch_fixed<uint16_t>(
          codes, valid, n, values, vvalid, n_values, out, out_valid, s));
    case 4:
      return static_cast<int>(launch_fixed<uint32_t>(
          codes, valid, n, values, vvalid, n_values, out, out_valid, s));
    case 8:
      return static_cast<int>(launch_fixed<uint64_t>(
          codes, valid, n, values, vvalid, n_values, out, out_valid, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// String dictionary decode, steps 1 and 2.  voffsets: n_values + 1 value
// offsets, int64 where off64 else int32; out_offsets: n + 1 int64 (the
// exclusive offsets, then the total chars); out_valid: n bytes;
// tile_scratch: srt::tiles_for(n) int64.
extern "C" int srt_decode_sizes(const void* codes, const void* valid,
                                int64_t n, const void* voffsets,
                                int32_t off64, const void* vvalid,
                                int64_t n_values, void* out_offsets,
                                void* out_valid, void* tile_scratch,
                                void* stream) {
  if (n < 0 || n_values < 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* offs = static_cast<int64_t*>(out_offsets);
  if (n > 0)
    decode_sizes<<<srt::grid_for(n), kThreads, 0, s>>>(
        static_cast<const int32_t*>(codes),
        static_cast<const uint8_t*>(valid), n, voffsets, off64,
        static_cast<const uint8_t*>(vvalid), n_values, offs,
        static_cast<uint8_t*>(out_valid));
  return static_cast<int>(srt::exclusive_scan(
      srt::ArrayValues{offs}, n, offs, static_cast<int64_t*>(tile_scratch),
      s));
}

// String dictionary decode, step 3, after the host has read
// out_offsets[n] and sized out_chars.
extern "C" int srt_decode_chars(const void* codes, int64_t n,
                                const void* voffsets, int32_t off64,
                                const void* vchars, const void* out_valid,
                                const void* out_offsets, void* out_chars,
                                void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  decode_chars<<<srt::grid_for(n), kThreads, 0, s>>>(
      static_cast<const int32_t*>(codes), n, voffsets, off64,
      static_cast<const uint8_t*>(vchars),
      static_cast<const uint8_t*>(out_valid),
      static_cast<const int64_t*>(out_offsets),
      static_cast<uint8_t*>(out_chars));
  return static_cast<int>(cudaGetLastError());
}

// RLE expansion.  run_values: n_runs values of `width` bytes; run_valid:
// n_runs bytes or null; run_ends: n_runs int32 exclusive row ends,
// ascending; rows at or past the last end are null.
extern "C" int srt_decode_rle(const void* run_values, const void* run_valid,
                              const void* run_ends, int64_t n_runs,
                              int32_t width, int64_t n, void* out,
                              void* out_valid, void* stream) {
  if (n < 0 || n_runs < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (width) {
    case 1:
      return static_cast<int>(launch_rle<uint8_t>(
          run_values, run_valid, run_ends, n_runs, n, out, out_valid, s));
    case 2:
      return static_cast<int>(launch_rle<uint16_t>(
          run_values, run_valid, run_ends, n_runs, n, out, out_valid, s));
    case 4:
      return static_cast<int>(launch_rle<uint32_t>(
          run_values, run_valid, run_ends, n_runs, n, out, out_valid, s));
    case 8:
      return static_cast<int>(launch_rle<uint64_t>(
          run_values, run_valid, run_ends, n_runs, n, out, out_valid, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
