// Kernel K7c: several batches' columns copied into one batch.
//
// Replaces the JAX package's `batch.concat` program
// (spark_rapids_tpu/ops/batch_ops.py:274 concat_batches, built :374),
// which joins the batches an aggregate reads (the grouping sets of an
// Expand, exec/aggregate.py:200; the partitions' partial rows before a
// FINAL merge) into one padded batch.  Here the row counts are exact on
// the host, so every output is sized exactly, and one launch copies one
// column of all the inputs (at most kMaxInputs): blockIdx.y is the input,
// and its blocks stride over that input's rows (and chars).
//
//   fixed-width column: each input's values and validity bytes land at
//     the input's row offset (the exclusive sum of the row counts before
//     it, computed on the host);
//   string column: each input's offsets are rebased by its char base (the
//     sum of the char lengths of the inputs before it, offsets[rows] -
//     offsets[0] of each, read on the card by each block: no sync), the
//     output's offsets are int64 and end with the total, and its chars
//     are copied after the chars before it.  The chars plane is sized by
//     the host as the sum of the inputs' chars planes, an upper bound the
//     copied chars may stop short of (a plane that runs past its last
//     offset, as columnar/column.py allows).
//
// A null validity pointer is an input with no null.
//
// Bound: device memory bytes -- every input byte is read once and every
// output byte written once.  The copy moves one value (or one char) per
// thread, which is a simple first form: wider loads are a later step.
#include "common.cuh"

namespace {

using srt::kThreads;

constexpr int kMaxInputs = 32;

struct Inputs {
  int32_t n;          // inputs
  int32_t width;      // bytes of a fixed-width value; 0: a string column
  const void* data[kMaxInputs];      // values, or a string's chars
  const uint8_t* valid[kMaxInputs];  // validity bytes (null: all valid)
  const void* offsets[kMaxInputs];   // a string's offsets
  int32_t off64[kMaxInputs];         // its offsets are int64
  int64_t rows[kMaxInputs];
  int64_t row_start[kMaxInputs];     // the input's first output row
};

__device__ __forceinline__ int64_t offset_at(const Inputs& in, int j,
                                             int64_t i) {
  return in.off64[j] ? static_cast<const int64_t*>(in.offsets[j])[i]
                     : static_cast<const int32_t*>(in.offsets[j])[i];
}

template <class W>
__device__ __forceinline__ void copy_values(const Inputs& in, int j,
                                            int64_t tid, int64_t stride,
                                            void* dst) {
  const W* src = static_cast<const W*>(in.data[j]);
  W* out = static_cast<W*>(dst) + in.row_start[j];
  for (int64_t i = tid; i < in.rows[j]; i += stride) out[i] = src[i];
}

__global__ void __launch_bounds__(kThreads)
    concat_column(Inputs in, void* dst, uint8_t* dst_valid,
                  int64_t* dst_offsets, uint8_t* dst_chars) {
  const int j = blockIdx.y;
  const int64_t n = in.rows[j];
  const int64_t start = in.row_start[j];
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t tid =
      static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const uint8_t* valid = in.valid[j];
  for (int64_t i = tid; i < n; i += stride)
    dst_valid[start + i] = valid == nullptr ? 1 : (valid[i] != 0);
  switch (in.width) {
    case 1: copy_values<uint8_t>(in, j, tid, stride, dst); return;
    case 2: copy_values<uint16_t>(in, j, tid, stride, dst); return;
    case 4: copy_values<uint32_t>(in, j, tid, stride, dst); return;
    case 8: copy_values<unsigned long long>(in, j, tid, stride, dst); return;
    case 16: copy_values<longlong2>(in, j, tid, stride, dst); return;
    default: break;
  }
  // a string column: the chars of the inputs before this one
  __shared__ long long base_shared;
  if (threadIdx.x == 0) {
    long long b = 0;
    for (int q = 0; q < j; ++q)
      b += offset_at(in, q, in.rows[q]) - offset_at(in, q, 0);
    base_shared = b;
  }
  __syncthreads();
  const long long base = base_shared;
  const int64_t first = offset_at(in, j, 0);
  const int64_t len = offset_at(in, j, n) - first;
  for (int64_t i = tid; i < n; i += stride)
    dst_offsets[start + i] = base + offset_at(in, j, i) - first;
  // the end of this input's rows: the next input's first offset, or the
  // total after the last (inputs of no row write the same value)
  if (tid == 0) dst_offsets[start + n] = base + len;
  const uint8_t* chars = static_cast<const uint8_t*>(in.data[j]) + first;
  for (int64_t b = tid; b < len; b += stride) dst_chars[base + b] = chars[b];
}

}  // namespace

// One column of n_inputs batches into one.  width: bytes of a value (1,
// 2, 4 or 8), or 0 for a string column, whose inputs give offsets (int64
// where off64[j], else int32) and whose output gives int64 dst_offsets
// (total rows + 1) and dst_chars.  data[j], valid[j] (null: no null),
// rows[j]: input j.  max_items: the most rows, or chars, of any input
// (the grid's width).
extern "C" int srt_concat_column(int32_t n_inputs, int32_t width,
                                 const void* const* data,
                                 const void* const* valid,
                                 const void* const* offsets,
                                 const int32_t* off64, const int64_t* rows,
                                 int64_t max_items, void* dst,
                                 void* dst_valid, void* dst_offsets,
                                 void* dst_chars, void* stream) {
  if (n_inputs < 1 || n_inputs > kMaxInputs ||
      (width != 0 && width != 1 && width != 2 && width != 4 && width != 8 &&
       width != 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Inputs in;
  in.n = n_inputs;
  in.width = width;
  int64_t start = 0;
  for (int j = 0; j < n_inputs; ++j) {
    if (rows[j] < 0) return static_cast<int>(cudaErrorInvalidValue);
    in.data[j] = data[j];
    in.valid[j] = static_cast<const uint8_t*>(valid[j]);
    in.offsets[j] = width == 0 ? offsets[j] : nullptr;
    in.off64[j] = width == 0 ? off64[j] : 0;
    in.rows[j] = rows[j];
    in.row_start[j] = start;
    start += rows[j];
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(srt::grid_for(max_items), n_inputs);
  concat_column<<<grid, kThreads, 0, s>>>(
      in, dst, static_cast<uint8_t*>(dst_valid),
      static_cast<int64_t*>(dst_offsets), static_cast<uint8_t*>(dst_chars));
  return static_cast<int>(cudaGetLastError());
}
