// Kernel K13: computed strings, written as Arrow offsets and chars, and
// the length of a string.
//
// Replaces the device forms of the JAX package's Substring, Concat, Length,
// Upper and Lower (spark_rapids_tpu/expressions/strings.py: Substring :157,
// eval_tpu :179; Concat :105, eval_tpu :115; Length :42, eval_tpu :49;
// Upper/Lower :68, eval_tpu :78), which write padded uint8[rows, width]
// planes: a static-shape form for the TPU.  Here the output is a string
// column of exact size, in three steps:
//
//   1. srt_string_sizes: one thread a row writes the row's output length
//      into out_offsets[i] and its validity byte;
//   2. the same call then scans the lengths in place into exclusive
//      offsets with common.cuh's tiled scan (srt::exclusive_scan), which
//      writes the total after them, out_offsets[n]; the host reads it
//      (one counted read) to size the chars plane;
//   3. srt_string_write: one thread a row writes its bytes.
//
// A character is a byte that is not a continuation byte (10xxxxxx),
// together with the continuation bytes after it: the rule the JAX Length
// counts by, so bytes that are not valid UTF-8 still give one answer.
//
// Forms:
//   substring -- one string column, by characters (Spark's rule, the JAX
//     CPU engine's; the JAX device form cuts bytes): the start character
//     c0 = pos - 1 for pos > 0, max(chars + pos, 0) for pos < 0, 0 for
//     pos = 0, clamped to the value's character count first, then
//     clamp(min(slen, chars - c0), 0) characters (slen 2^30 without a
//     length).  The bytes run from the c0-th character's first byte to
//     the (c0 + take)-th's (or the end): bytes before the first character
//     (stray continuation bytes) belong to none;
//   concat -- up to kMaxParts parts, each a string column or a literal
//     (its bytes in one small device buffer of every literal, at a
//     host-known offset and length; a null literal makes every row null);
//     NULL if any part is NULL, else the parts' bytes one after another;
//   upper, lower -- one string column through a case table (Python's
//     str.upper and str.lower, which the JAX CPU engine runs: Spark's
//     rule; the JAX device form maps ASCII only): sorted code points, the
//     offsets of their mappings and the mappings' UTF-8 bytes, so a
//     mapping may change the length ('ß' -> "SS").  An ASCII byte maps by
//     arithmetic; a valid UTF-8 sequence (2 to 4 bytes, not overlong, not
//     a surrogate, at most U+10FFFF) is looked up by binary search and
//     copied when it has no mapping; any other byte is copied as it is.
//     lower gives U+03A3 (capital sigma) its final form U+03C2 where a
//     cased character comes before it and none after it, skipping
//     case-ignorable ones (Unicode's Final_Sigma, as CPython applies it):
//     two more sorted range tables, of the cased and the case-ignorable
//     code points, read only around a sigma.
// A null row has length 0.  `rows`, when not null, maps output row i to
// input row rows[i] (the survivors of a compacting stage), so the inputs
// need not be gathered first.
//
// srt_string_length: one int32 a row, the count of its characters (the
// JAX Length's device rule), 0 and invalid under a null; one pass, no
// sync.
//
// Bound: device memory bytes -- each output byte is written once and each
// byte it copies read once (a substring and a case map read their row's
// bytes twice: the sizes pass and the write pass), plus the offsets and
// validity of the inputs and of the output.  A thread per row walks its
// row byte by byte: a warp per long row, or wider copies, are later
// steps.
#include "common.cuh"

namespace {

using srt::kThreads;

constexpr int kMaxParts = 8;
constexpr int32_t kSubstring = 0;
constexpr int32_t kConcat = 1;
constexpr int32_t kUpper = 3;
constexpr int32_t kLower = 4;
constexpr int32_t kColumn = 0;
constexpr int32_t kLiteral = 1;
constexpr int32_t kNullLiteral = 2;
constexpr int32_t kCapitalSigma = 0x3A3;

struct CaseTable {
  const int32_t* cps;     // sorted code points that change
  const int32_t* moff;    // n_map + 1 offsets into mbytes
  const uint8_t* mbytes;  // each mapping's UTF-8 bytes
  const int32_t* cased;   // sorted [lo, hi] ranges, 2 * n_cased
  const int32_t* ign;     // case-ignorable ranges, 2 * n_ign
  int64_t n_map;
  int64_t n_cased;
  int64_t n_ign;
};

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
  CaseTable table;
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

__device__ __forceinline__ bool is_lead(uint8_t b) {
  return (b & 0xC0) != 0x80;
}

// the substring's (first byte within the value, byte length) for the len
// bytes at s, by characters
__device__ __forceinline__ void substring_range(const Parts& p,
                                                const uint8_t* s,
                                                int64_t len, int64_t* skip,
                                                int64_t* out) {
  int64_t chars = 0;
  for (int64_t b = 0; b < len; ++b) chars += is_lead(s[b]);
  int64_t c0 = p.pos > 0 ? static_cast<int64_t>(p.pos) - 1
                         : (p.pos < 0 ? chars + p.pos : 0);
  if (c0 < 0) c0 = 0;
  if (c0 > chars) c0 = chars;
  int64_t take = chars - c0;
  if (take > p.slen) take = p.slen;
  if (take < 0) take = 0;
  const int64_t c1 = c0 + take;
  // the c-th character starts at the c-th lead byte; past the last, at
  // the end
  int64_t b0 = len, b1 = len;
  if (c0 < chars) {
    int64_t k = 0;
    for (int64_t b = 0; b < len; ++b) {
      if (!is_lead(s[b])) continue;
      if (k == c0) b0 = b;
      if (k == c1) {
        b1 = b;
        break;
      }
      ++k;
    }
  }
  *skip = b0;
  *out = b1 - b0;
}

// The unit at byte q of a value of len bytes: a valid UTF-8 sequence
// (its length, *cp its code point), or one byte (an ASCII byte: *cp the
// byte; any other: *cp -1).
__device__ __forceinline__ int unit_at(const uint8_t* s, int64_t q,
                                       int64_t len, int32_t* cp) {
  const uint8_t b = s[q];
  if (b < 0x80) {
    *cp = b;
    return 1;
  }
  const int L = b >= 0xF8 ? 0 : b >= 0xF0 ? 4 : b >= 0xE0 ? 3
                                  : b >= 0xC0 ? 2 : 0;
  *cp = -1;
  if (L == 0 || q + L > len) return 1;
  int32_t c = b & (L == 2 ? 0x1F : L == 3 ? 0x0F : 0x07);
  for (int k = 1; k < L; ++k) {
    const uint8_t x = s[q + k];
    if ((x & 0xC0) != 0x80) return 1;
    c = (c << 6) | (x & 0x3F);
  }
  const bool ok = L == 2 ? c >= 0x80
                  : L == 3 ? c >= 0x800 && (c < 0xD800 || c > 0xDFFF)
                           : c >= 0x10000 && c <= 0x10FFFF;
  if (!ok) return 1;
  *cp = c;
  return L;
}

// the first byte of the unit that holds byte q (a valid sequence that
// starts up to three bytes before covers it, else q starts its own)
__device__ __forceinline__ int64_t unit_start(const uint8_t* s, int64_t q,
                                              int64_t len) {
  for (int k = 1; k <= 3 && q - k >= 0; ++k) {
    int32_t cp;
    if (unit_at(s, q - k, len, &cp) > k) return q - k;
  }
  return q;
}

__device__ __forceinline__ bool in_ranges(const int32_t* r, int64_t n,
                                          int32_t cp) {
  int64_t lo = 0, hi = n;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (r[2 * mid + 1] < cp)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < n && r[2 * lo] <= cp;
}

// the case table's index of cp, or -1
__device__ __forceinline__ int64_t find_mapping(const CaseTable& t,
                                                int32_t cp) {
  int64_t lo = 0, hi = t.n_map;
  while (lo < hi) {
    const int64_t mid = (lo + hi) >> 1;
    if (t.cps[mid] < cp)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo < t.n_map && t.cps[lo] == cp ? lo : -1;
}

// the cased verdict of the first unit that is not case-ignorable, walking
// from byte q backwards (dir < 0) or forwards; false at the value's end
// (a byte outside valid UTF-8 is neither cased nor case-ignorable)
__device__ bool next_cased(const CaseTable& t, const uint8_t* s,
                           int64_t len, int64_t q, int dir) {
  while (q >= 0 && q < len) {
    int32_t cp;
    int64_t st = dir < 0 ? unit_start(s, q, len) : q;
    const int L = unit_at(s, st, len, &cp);
    if (cp < 0) return false;
    if (!in_ranges(t.ign, t.n_ign, cp))
      return in_ranges(t.cased, t.n_cased, cp);
    q = dir < 0 ? st - 1 : st + L;
  }
  return false;
}

// Walks one value's units through the case table: with dst null it
// counts the output bytes, else it writes them.
__device__ int64_t case_map(const Parts& p, int32_t op, const uint8_t* s,
                            int64_t len, uint8_t* dst) {
  const CaseTable& t = p.table;
  int64_t out = 0;
  int64_t q = 0;
  while (q < len) {
    const uint8_t b = s[q];
    if (b < 0x80) {
      uint8_t m = b;
      if (op == kUpper && b >= 'a' && b <= 'z') m = b - 32;
      if (op == kLower && b >= 'A' && b <= 'Z') m = b + 32;
      if (dst != nullptr) dst[out] = m;
      ++out;
      ++q;
      continue;
    }
    int32_t cp;
    const int L = unit_at(s, q, len, &cp);
    const int64_t k = cp < 0 ? -1 : find_mapping(t, cp);
    if (k < 0) {
      if (dst != nullptr)
        for (int j = 0; j < L; ++j) dst[out + j] = s[q + j];
      out += L;
    } else if (op == kLower && cp == kCapitalSigma &&
               next_cased(t, s, len, q - 1, -1) &&
               !next_cased(t, s, len, q + L, 1)) {
      // final sigma, U+03C2
      if (dst != nullptr) {
        dst[out] = 0xCF;
        dst[out + 1] = 0x82;
      }
      out += 2;
    } else {
      const int32_t a = t.moff[k], e = t.moff[k + 1];
      if (dst != nullptr)
        for (int32_t j = a; j < e; ++j) dst[out + j - a] = t.mbytes[j];
      out += e - a;
    }
    q += L;
  }
  return out;
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
      substring_range(p, p.chars[j] + s, len, &skip, &len);
    } else if (op == kUpper || op == kLower) {
      len = case_map(p, op, p.chars[j] + s, len, nullptr);
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
      if (op == kUpper || op == kLower) {
        dst += case_map(p, op, p.chars[j] + s, len, dst);
        continue;
      }
      if (op == kSubstring) {
        int64_t skip;
        substring_range(p, p.chars[j] + s, len, &skip, &len);
        s += skip;
      }
      const uint8_t* src = p.chars[j] + s;
      for (int64_t b = 0; b < len; ++b) dst[b] = src[b];
      dst += len;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    string_length(const uint8_t* __restrict__ chars, const void* offsets,
                  int32_t off64, const uint8_t* __restrict__ valid,
                  const int64_t* __restrict__ rows, int64_t n,
                  int32_t* __restrict__ out, uint8_t* __restrict__ out_valid) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const int64_t r = rows == nullptr ? i : rows[i];
    const bool ok = valid == nullptr || valid[r];
    int32_t count = 0;
    if (ok) {
      int64_t s, e;
      if (off64) {
        s = static_cast<const int64_t*>(offsets)[r];
        e = static_cast<const int64_t*>(offsets)[r + 1];
      } else {
        s = static_cast<const int32_t*>(offsets)[r];
        e = static_cast<const int32_t*>(offsets)[r + 1];
      }
      for (int64_t b = s; b < e; ++b) count += is_lead(chars[b]);
    }
    out[i] = count;
    out_valid[i] = ok ? 1 : 0;
  }
}

bool make_parts(int32_t op, int32_t n_parts, const int32_t* kinds,
                const int32_t* off64, const void* const* chars,
                const void* const* offsets, const void* const* valid,
                const int64_t* lit_start, const int64_t* lit_len,
                int32_t pos, int32_t slen, const void* rows,
                const void* const* table, const int64_t* table_sizes,
                Parts* p) {
  if (n_parts < 1 || n_parts > kMaxParts) return false;
  const bool single = op == kSubstring || op == kUpper || op == kLower;
  if (single && (n_parts != 1 || kinds[0] != kColumn)) return false;
  if (!single && op != kConcat) return false;
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
  p->table = CaseTable{};
  if (op == kUpper || op == kLower) {
    if (table == nullptr || table_sizes == nullptr || table[0] == nullptr ||
        table[1] == nullptr || table[2] == nullptr ||
        (op == kLower && (table[3] == nullptr || table[4] == nullptr)))
      return false;
    p->table.cps = static_cast<const int32_t*>(table[0]);
    p->table.moff = static_cast<const int32_t*>(table[1]);
    p->table.mbytes = static_cast<const uint8_t*>(table[2]);
    p->table.cased = static_cast<const int32_t*>(table[3]);
    p->table.ign = static_cast<const int32_t*>(table[4]);
    p->table.n_map = table_sizes[0];
    p->table.n_cased = table_sizes[1];
    p->table.n_ign = table_sizes[2];
  }
  return true;
}

}  // namespace

// Steps 1 and 2.  op: 0 substring (pos, slen), 1 concat, 3 upper, 4
// lower.  Part j: kinds[j] 0 a string column (chars[j], offsets[j] int64
// where off64[j] else int32, valid[j] bytes or null), 1 a literal
// (lit_len[j] bytes at chars[j] + lit_start[j]), 2 a null literal.  rows:
// n int64 input rows or null.  table (upper and lower): device pointers
// to the code points, the mapping offsets, the mapping bytes, the cased
// ranges and the case-ignorable ranges; table_sizes: their counts
// (mappings, cased ranges, case-ignorable ranges).  out_offsets: n + 1
// int64 (the exclusive offsets, then the total chars); out_valid: n
// bytes; tile_scratch: srt::tiles_for(n) int64.
extern "C" int srt_string_sizes(int32_t op, int32_t n_parts,
                                const int32_t* kinds, const int32_t* off64,
                                const void* const* chars,
                                const void* const* offsets,
                                const void* const* valid,
                                const int64_t* lit_start,
                                const int64_t* lit_len, int32_t pos,
                                int32_t slen, const void* rows, int64_t n,
                                const void* const* table,
                                const int64_t* table_sizes,
                                void* out_offsets, void* out_valid,
                                void* tile_scratch, void* stream) {
  Parts p;
  if (n < 0 || !make_parts(op, n_parts, kinds, off64, chars, offsets, valid,
                           lit_start, lit_len, pos, slen, rows, table,
                           table_sizes, &p))
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
                                const void* const* table,
                                const int64_t* table_sizes,
                                const void* out_offsets,
                                const void* out_valid, void* out_chars,
                                void* stream) {
  Parts p;
  if (n < 0 || !make_parts(op, n_parts, kinds, off64, chars, offsets, valid,
                           lit_start, lit_len, pos, slen, rows, table,
                           table_sizes, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  string_write<<<srt::grid_for(n), kThreads, 0, s>>>(
      p, op, n, static_cast<const uint8_t*>(out_valid),
      static_cast<const int64_t*>(out_offsets),
      static_cast<uint8_t*>(out_chars));
  return static_cast<int>(cudaGetLastError());
}

// The characters of each of n rows of a string column (chars, offsets
// int64 where off64 else int32, valid bytes or null; rows: n int64 input
// rows or null) into out (n int32) and out_valid (n bytes).
extern "C" int srt_string_length(const void* chars, const void* offsets,
                                 int32_t off64, const void* valid,
                                 const void* rows, int64_t n, void* out,
                                 void* out_valid, void* stream) {
  if (n < 0 || offsets == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  string_length<<<srt::grid_for(n), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(chars), offsets, off64,
      static_cast<const uint8_t*>(valid), static_cast<const int64_t*>(rows),
      n, static_cast<int32_t*>(out), static_cast<uint8_t*>(out_valid));
  return static_cast<int>(cudaGetLastError());
}
