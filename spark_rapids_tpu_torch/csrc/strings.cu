// Kernel K13: computed strings, written as Arrow offsets and chars.
//
// Replaces the device forms of the JAX package's Substring and Concat
// (spark_rapids_tpu/expressions/strings.py: Substring :157, eval_tpu :179;
// Concat :105, eval_tpu :115), which write padded uint8[rows, width]
// planes: a static-shape form for the TPU.  Here the output is a string
// column of exact size, in three steps:
//
//   1. srt_string_sizes: one thread a row writes the row's output length
//      into out_offsets[i] and its validity byte;
//   2. the same call then scans the lengths in place into exclusive
//      offsets with common.cuh's tiled scan (srt::exclusive_scan), which
//      writes the total after them, out_offsets[n]; the host reads it
//      (one counted read) to size the chars plane;
//   3. srt_string_write: one thread a row copies its bytes.
//
// Forms:
//   substring -- one string column; JAX's byte rule: start = pos - 1 for
//     pos > 0, max(len + pos, 0) for pos < 0, 0 for pos = 0, clamped to
//     the value's length first, then out = clamp(min(slen, len - start),
//     0) bytes (slen 2^30 without a length);
//   concat -- up to kMaxParts parts, each a string column or a literal
//     (its bytes in one small device buffer of every literal, at a
//     host-known offset and length; a null literal makes every row null);
//     NULL if any part is NULL, else the parts' bytes one after another.
// A null row has length 0.  `rows`, when not null, maps output row i to
// input row rows[i] (the survivors of a compacting stage), so the inputs
// need not be gathered first.
//
// Bound: device memory bytes -- each output byte is written once and each
// byte it copies read once, plus the offsets and validity of the inputs
// (read twice: the sizes pass and the write pass) and of the output.  A
// thread per row copies byte by byte: a warp per long row, or wider
// copies, are later steps.
#include "common.cuh"

namespace {

using srt::kThreads;

constexpr int kMaxParts = 8;
constexpr int32_t kSubstring = 0;
constexpr int32_t kConcat = 1;
constexpr int32_t kColumn = 0;
constexpr int32_t kLiteral = 1;
constexpr int32_t kNullLiteral = 2;

struct Parts {
  int32_t n;
  int32_t kind[kMaxParts];
  int32_t off64[kMaxParts];
  const uint8_t* chars[kMaxParts];  // a column's chars, or the literals'
  const void* offsets[kMaxParts];
  const uint8_t* valid[kMaxParts];  // null: every row valid
  int64_t lit_start[kMaxParts];
  int64_t lit_len[kMaxParts];
  const int64_t* rows;              // null: output row i reads row i
  int32_t pos;
  int32_t slen;
};

__device__ __forceinline__ int64_t source_row(const Parts& p, int64_t i) {
  return p.rows == nullptr ? i : p.rows[i];
}

__device__ __forceinline__ void bounds(const Parts& p, int j, int64_t r,
                                       int64_t* start, int64_t* len) {
  if (p.kind[j] != kColumn) {
    *start = p.lit_start[j];
    *len = p.kind[j] == kLiteral ? p.lit_len[j] : 0;
    return;
  }
  int64_t s, e;
  if (p.off64[j]) {
    const int64_t* o = static_cast<const int64_t*>(p.offsets[j]);
    s = o[r];
    e = o[r + 1];
  } else {
    const int32_t* o = static_cast<const int32_t*>(p.offsets[j]);
    s = o[r];
    e = o[r + 1];
  }
  *start = s;
  *len = e - s;
}

__device__ __forceinline__ bool present(const Parts& p, int j, int64_t r) {
  if (p.kind[j] == kNullLiteral) return false;
  return p.kind[j] == kLiteral || p.valid[j] == nullptr || p.valid[j][r];
}

// the substring's (start within the value, length) for a value of len
// bytes
__device__ __forceinline__ void substring_range(const Parts& p, int64_t len,
                                                int64_t* skip,
                                                int64_t* out) {
  int64_t s = p.pos > 0 ? static_cast<int64_t>(p.pos) - 1
                        : (p.pos < 0 ? len + p.pos : 0);
  if (s < 0) s = 0;
  if (s > len) s = len;
  int64_t n = len - s;
  if (n > p.slen) n = p.slen;
  if (n < 0) n = 0;
  *skip = s;
  *out = n;
}

// row i's output length (0 for a null row) and validity
__device__ __forceinline__ int64_t row_size(const Parts& p, int32_t op,
                                            int64_t i, bool* ok) {
  const int64_t r = source_row(p, i);
  bool v = true;
  for (int j = 0; j < p.n; ++j) v = v && present(p, j, r);
  *ok = v;
  if (!v) return 0;
  int64_t total = 0;
  for (int j = 0; j < p.n; ++j) {
    int64_t s, len;
    bounds(p, j, r, &s, &len);
    if (op == kSubstring) {
      int64_t skip;
      substring_range(p, len, &skip, &len);
    }
    total += len;
  }
  return total;
}

__global__ void __launch_bounds__(kThreads)
    string_sizes(Parts p, int32_t op, int64_t n, int64_t* out_offsets,
                 uint8_t* out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    bool ok;
    out_offsets[i] = row_size(p, op, i, &ok);
    out_valid[i] = ok ? 1 : 0;
  }
}

__global__ void __launch_bounds__(kThreads)
    string_write(Parts p, int32_t op, int64_t n,
                 const uint8_t* __restrict__ out_valid,
                 const int64_t* __restrict__ out_offsets,
                 uint8_t* __restrict__ out_chars) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    if (!out_valid[i]) continue;
    const int64_t r = source_row(p, i);
    uint8_t* dst = out_chars + out_offsets[i];
    for (int j = 0; j < p.n; ++j) {
      int64_t s, len;
      bounds(p, j, r, &s, &len);
      if (op == kSubstring) {
        int64_t skip;
        substring_range(p, len, &skip, &len);
        s += skip;
      }
      const uint8_t* src = p.chars[j] + s;
      for (int64_t b = 0; b < len; ++b) dst[b] = src[b];
      dst += len;
    }
  }
}

bool make_parts(int32_t op, int32_t n_parts, const int32_t* kinds,
                const int32_t* off64, const void* const* chars,
                const void* const* offsets, const void* const* valid,
                const int64_t* lit_start, const int64_t* lit_len,
                int32_t pos, int32_t slen, const void* rows, Parts* p) {
  if (n_parts < 1 || n_parts > kMaxParts) return false;
  if (op == kSubstring && (n_parts != 1 || kinds[0] != kColumn))
    return false;
  if (op != kSubstring && op != kConcat) return false;
  p->n = n_parts;
  for (int j = 0; j < n_parts; ++j) {
    if (kinds[j] < kColumn || kinds[j] > kNullLiteral) return false;
    // a column's chars plane may be empty (every value "" or null): no
    // byte of it is read then
    if (kinds[j] == kLiteral && chars[j] == nullptr) return false;
    if (kinds[j] == kColumn && offsets[j] == nullptr) return false;
    p->kind[j] = kinds[j];
    p->off64[j] = off64[j];
    p->chars[j] = static_cast<const uint8_t*>(chars[j]);
    p->offsets[j] = offsets[j];
    p->valid[j] = static_cast<const uint8_t*>(valid[j]);
    p->lit_start[j] = lit_start[j];
    p->lit_len[j] = lit_len[j];
  }
  p->rows = static_cast<const int64_t*>(rows);
  p->pos = pos;
  p->slen = slen;
  return true;
}

}  // namespace

// Steps 1 and 2.  op: 0 substring (pos, slen), 1 concat.  Part j:
// kinds[j] 0 a string column (chars[j], offsets[j] int64 where off64[j]
// else int32, valid[j] bytes or null), 1 a literal (lit_len[j] bytes at
// chars[j] + lit_start[j]), 2 a null literal.  rows: n int64 input rows
// or null.  out_offsets: n + 1 int64 (the exclusive offsets, then the
// total chars); out_valid: n bytes; tile_scratch: srt::tiles_for(n)
// int64.
extern "C" int srt_string_sizes(int32_t op, int32_t n_parts,
                                const int32_t* kinds, const int32_t* off64,
                                const void* const* chars,
                                const void* const* offsets,
                                const void* const* valid,
                                const int64_t* lit_start,
                                const int64_t* lit_len, int32_t pos,
                                int32_t slen, const void* rows, int64_t n,
                                void* out_offsets, void* out_valid,
                                void* tile_scratch, void* stream) {
  Parts p;
  if (n < 0 || !make_parts(op, n_parts, kinds, off64, chars, offsets, valid,
                           lit_start, lit_len, pos, slen, rows, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* offs = static_cast<int64_t*>(out_offsets);
  if (n > 0)
    string_sizes<<<srt::grid_for(n), kThreads, 0, s>>>(
        p, op, n, offs, static_cast<uint8_t*>(out_valid));
  // lengths -> exclusive offsets in place, the total at offs[n]
  return static_cast<int>(srt::exclusive_scan(
      srt::ArrayValues{offs}, n, offs, static_cast<int64_t*>(tile_scratch),
      s));
}

// Step 3, after the host has read out_offsets[n] and sized out_chars;
// the same parts as srt_string_sizes.
extern "C" int srt_string_write(int32_t op, int32_t n_parts,
                                const int32_t* kinds, const int32_t* off64,
                                const void* const* chars,
                                const void* const* offsets,
                                const void* const* valid,
                                const int64_t* lit_start,
                                const int64_t* lit_len, int32_t pos,
                                int32_t slen, const void* rows, int64_t n,
                                const void* out_offsets,
                                const void* out_valid, void* out_chars,
                                void* stream) {
  Parts p;
  if (n < 0 || !make_parts(op, n_parts, kinds, off64, chars, offsets, valid,
                           lit_start, lit_len, pos, slen, rows, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  string_write<<<srt::grid_for(n), kThreads, 0, s>>>(
      p, op, n, static_cast<const uint8_t*>(out_valid),
      static_cast<const int64_t*>(out_offsets),
      static_cast<uint8_t*>(out_chars));
  return static_cast<int>(cudaGetLastError());
}
