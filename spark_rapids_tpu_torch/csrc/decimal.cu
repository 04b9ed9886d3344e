// The finish of a decimal avg: the sum buffer divided by the count by
// Spark's rule, a thread a row.
//
// Replaces the JAX package's final expression of a decimal Average
// (spark_rapids_tpu/expressions/aggregates.py:182-190, a double divide
// cast back to decimal, which its faulty cast makes 10^4 too small) with
// Spark's: q = round_half_up(|sum| * 10^up / count) at the scale of
// Divide(sum, cast(count as decimal(20,0))), NULL past its precision;
// then round_half_up(q / 10^down) at the result's scale, NULL past its
// precision; the sign of the sum; NULL for a null sum or a count of 0.
// For avg of decimal(7,2): up = 21, the quotient decimal(38,23), down = 17,
// the result decimal(11,6).
//
// The sum is a decimal64 (int64) or a decimal128 ((hi, lo) int64 pairs);
// |sum| * 10^up is below 10^38, so every step fits an unsigned __int128
// (2 * 10^38 + count < 2^128).  Triton has no 128-bit integer, which is
// why this step is CUDA C++.
//
// Bound: device memory bytes (sum, count and validity read once, the
// result written once); a row's two 128-bit divisions are a few hundred
// instructions, below the card's rate at the main path's group counts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "decimal.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    decimal_avg(const int64_t* __restrict__ sum, int32_t sum_wide,
                const uint8_t* __restrict__ sum_valid,
                const int64_t* __restrict__ count,
                const uint8_t* __restrict__ count_valid, int64_t n,
                int32_t up, int32_t down, int32_t mid_precision,
                int32_t out_precision, int32_t out_wide,
                int64_t* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const srt::u128 up_pow = srt::pow10_u128(up);
  const srt::u128 down_pow = srt::pow10_u128(down);
  const srt::u128 mid_bound = srt::pow10_u128(mid_precision);
  const srt::u128 out_bound = srt::pow10_u128(out_precision);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const srt::i128 s = sum_wide ? srt::load_i128(sum, i)
                                 : static_cast<srt::i128>(sum[i]);
    const long long c = count[i];
    bool ok = sum_valid[i] != 0 && count_valid[i] != 0 && c > 0;
    srt::u128 q = 0;
    if (ok) {
      const srt::u128 mag = s < 0 ? static_cast<srt::u128>(-s)
                                  : static_cast<srt::u128>(s);
      const srt::u128 den = static_cast<srt::u128>(c);
      q = (2 * (mag * up_pow) + den) / (2 * den);
      ok = q < mid_bound;
      q = (2 * q + down_pow) / (2 * down_pow);
      ok = ok && q < out_bound;
    }
    const srt::i128 v = !ok ? 0
                            : (s < 0 ? -static_cast<srt::i128>(q)
                                     : static_cast<srt::i128>(q));
    if (out_wide)
      srt::store_i128(out, i, v);
    else
      out[i] = static_cast<int64_t>(v);
    out_valid[i] = ok ? 1 : 0;
  }
}

}  // namespace

extern "C" int srt_decimal_avg(const void* sum, int32_t sum_wide,
                               const void* sum_valid, const void* count,
                               const void* count_valid, int64_t n,
                               int32_t up, int32_t down,
                               int32_t mid_precision, int32_t out_precision,
                               int32_t out_wide, void* out, void* out_valid,
                               void* stream) {
  if (n < 0 || up < 0 || down < 0 || up > 38 || down > 38 ||
      mid_precision < 1 || mid_precision > 38 || out_precision < 1 ||
      out_precision > 38)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  decimal_avg<<<static_cast<unsigned>(blocks < 4096 ? blocks : 4096),
                kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(sum), sum_wide,
      static_cast<const uint8_t*>(sum_valid),
      static_cast<const int64_t*>(count),
      static_cast<const uint8_t*>(count_valid), n, up, down, mid_precision,
      out_precision, out_wide, static_cast<int64_t*>(out),
      static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
