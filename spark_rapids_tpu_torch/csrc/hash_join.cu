// Kernel K10: inner, left (and right) outer, full outer, left semi and
// left anti equi-join on up to 8 key columns of int, date, long or string,
// through a hash table.
//
// Replaces the JAX package's sort-based join programs `join.build`,
// `join.probe`, `join.pair` and `join.compact_pairs`
// (spark_rapids_tpu/ops/join_ops.py: build_side :125 with _hash_rows :96
// folding every key column through _mix64 :58, built :150; _probe_ranges
// :157, :183; _expand_verify :191, :242; compact_pairs :290, :308).  XLA
// has no hash tables, so the JAX package sorts the build side by key hash
// and binary-searches it; on the card an open-addressing table is the
// direct form, as in the plugin this repository models (cuDF hash joins).
//
// Keys: each side's key columns are a keys.cuh Keys (an int key is widened
// to long before it is hashed or compared, so an int key of one side
// equals a long key of the other with the same value; a string key,
// offsets and chars, meets a string key of the other side, each side with
// its own planes, the JAX package's _hash_rows :96 with string word
// widths agreed between the sides :71).  A row whose keys hold a null in
// any column never matches; an empty string is not null.  A row's hash is
// keys.cuh row_hash over all its key columns (a string's bytes folded by
// FNV-1a); equality is keys_equal across the two sides, byte by byte for
// a string, so two keys whose hashes collide never match.
//
// Build: a table of a power of two >= 2 * build rows slots; each build row
// whose keys are all present takes its own slot (atomicCAS, linear
// probing from its hash), so duplicate keys stay apart; the slot holds the
// row index, and a tag goes beside it in slot_tag: with one int, date or
// long key column the key's own 64-bit word, so a tag match is a key match
// and no build key is read (the one-key form of earlier versions kept the
// key in the slot the same way); with several, or a string key, the row
// hash, a filter before keys_equal reads the build row's keys.
// Probe, in tiles of 1024 rows: the count pass walks each probe row's
// chain -- a slot whose tag differs is skipped -- and writes one match
// count per tile; common.cuh scans the tile
// counts and writes the total, which the host reads (the join's one sync)
// to size the output; the write pass walks again, scans the counts inside
// the tile, and writes (probe row, build row) pairs in probe-row order.
// Within one probe row the build rows are put in ascending order (an
// insertion sort of that row's run), so the output does not depend on the
// order in which build rows won their slots.
//
// Modes (the JAX package's finishing programs join.matched_flags,
// join.unmatched_positions and concat_matched_unmatched, :275, :313, :418,
// become modes of the count and write passes):
//   inner  -- one pair per match;
//   outer  -- a probe row with no match gives one pair (row, -1);
//   semi   -- a probe row with a match is kept once, whatever the build
//             side's duplicates: its chain walk stops at the first match;
//   anti   -- a probe row with no match is kept, a null key included (the
//             JAX package's plain anti join, not Spark's null-aware one);
//   full   -- K10f, the full outer join (join.matched_flags,
//             join.unmatched and join.concat_maps, :275, :313, :418): the
//             pairs of the outer mode, and the count pass also stores
//             flag[build row] = 1 for every match it finds (a plain byte
//             store: threads that race write the same value).  Then
//             srt_join_unmatched scans the build rows whose flag is 0 (a
//             null key is never inserted, so never matched: it comes out
//             unmatched, as Spark gives it), and its count joins the pair
//             count in the join's one read; srt_join_unmatched_write puts
//             each such row after the pairs as (-1, build row), in build
//             order.  A right outer join is the outer mode with the sides
//             swapped.
// Semi and anti write only the kept probe rows, in probe order.
//
// Null-safe keys (null_safe, a bit per key column; the JAX package's
// _expand_verify null_safe, :192, :234, which INTERSECT and EXCEPT use,
// session.py:495): a null in such a column is a value, so a build row
// holding one is inserted, not dropped, and equals a probe row with a null
// there (row_hash hashes a null as one word, keys_equal equates two
// nulls).  Every mode takes them.  A one-column null-safe key is tagged by
// its hash, not its word (the word under a null is not read).
//
// One key column is the case n_keys = 1 of the same code; one fixed-width
// key differs only in its tag (the key word, not the hash).
//
// Bound: device memory bytes.  The probe side is read twice (count and
// write passes) where the function needs it once; the table (a few
// thousand slots on the main path) stays in L2.
#include "keys.cuh"

namespace {

using srt::Keys;
using srt::kScanItems;
using srt::kScanTile;
using srt::kThreads;

constexpr long long kEmpty = -1;

enum Mode : int32_t { kInner = 0, kOuter = 1, kSemi = 2, kAnti = 3,
                      kFull = 4 };

struct Side {
  Keys k;
  int64_t n;
};

struct Table {
  const long long* slots;
  const uint64_t* tag;
  uint64_t mask;
};

// one fixed-width key column, not null-safe: the key's word is the
// slot's tag
__device__ __forceinline__ bool word_tagged(const Keys& k) {
  return k.n == 1 && k.type[0] != srt::kKeyString && k.null_safe == 0;
}

// the tag a slot keeps for a row of hash h: the key's word for one
// fixed-width key column, else the hash
__device__ __forceinline__ uint64_t row_tag(const Keys& k, int64_t i,
                                           uint64_t h) {
  return word_tagged(k) ? srt::key_word(k, 0, i) : h;
}

__global__ void __launch_bounds__(kThreads)
    table_clear(long long* slots, int64_t size) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < size; i += stride)
    slots[i] = kEmpty;
}

__global__ void __launch_bounds__(kThreads)
    table_build(Side b, long long* slots, uint64_t* slot_tag,
                uint64_t mask) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < b.n; r += stride) {
    if (!srt::all_present(b.k, r)) continue;
    const uint64_t h = srt::row_hash(b.k, r);
    uint64_t s = h & mask;
    while (true) {
      const unsigned long long prev = atomicCAS(
          reinterpret_cast<unsigned long long*>(&slots[s]),
          static_cast<unsigned long long>(kEmpty),
          static_cast<unsigned long long>(r));
      if (prev == static_cast<unsigned long long>(kEmpty)) {
        slot_tag[s] = row_tag(b.k, r, h);
        break;
      }
      s = (s + 1) & mask;
    }
  }
}

// build row of slot s when it matches probe row i of tag `tag`, else -1
__device__ __forceinline__ long long slot_match(const Side& b, const Side& p,
                                                const Table& t, uint64_t s,
                                                int64_t i, uint64_t tag) {
  if (t.tag[s] != tag) return -1;
  const long long r = t.slots[s];
  return word_tagged(p.k) || srt::keys_equal(b.k, r, p.k, i) ? r : -1;
}

// matches of probe row i; semi and anti modes stop at the first; each
// match's build row is flagged where flags is not null
__device__ __forceinline__ long long match_count(const Side& b,
                                                 const Side& p, int64_t i,
                                                 const Table& t, int mode,
                                                 uint8_t* flags = nullptr) {
  if (i >= p.n || !srt::all_present(p.k, i)) return 0;
  const uint64_t h = srt::row_hash(p.k, i);
  const uint64_t tag = row_tag(p.k, i, h);
  const bool first_only = mode == kSemi || mode == kAnti;
  long long c = 0;
  for (uint64_t s = h & t.mask; t.slots[s] != kEmpty;
       s = (s + 1) & t.mask) {
    const long long r = slot_match(b, p, t, s, i, tag);
    if (r < 0) continue;
    ++c;
    if (flags != nullptr) flags[r] = 1;
    if (first_only) break;
  }
  return c;
}

// rows a probe row gives: its matches; in outer mode at least one; in semi
// mode one if it matched, in anti mode one if it did not
__device__ __forceinline__ long long pair_count(long long matches,
                                                const Side& p, int64_t i,
                                                int mode) {
  if (i >= p.n) return 0;
  switch (mode) {
    case kOuter:
    case kFull: return matches == 0 ? 1 : matches;
    case kSemi: return matches > 0 ? 1 : 0;
    case kAnti: return matches == 0 ? 1 : 0;
    default: return matches;
  }
}

__global__ void __launch_bounds__(kThreads)
    probe_count(Side b, Side p, Table t, int mode, uint8_t* flags,
                int64_t* tile_counts) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long c = 0;
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    c += pair_count(match_count(b, p, i, t, mode, flags), p, i, mode);
  }
  long long total;
  srt::block_exclusive_scan(c, &total);
  if (threadIdx.x == 0) tile_counts[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kThreads)
    probe_write(Side b, Side p, Table t, int mode,
                const int64_t* __restrict__ tile_offsets,
                long long* __restrict__ out_probe,
                long long* __restrict__ out_build) {
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kScanTile;
  long long carry = tile_offsets[blockIdx.x];
  for (int k = 0; k < kScanItems; ++k) {
    const int64_t i = base + k * kThreads + threadIdx.x;
    const long long m = match_count(b, p, i, t, mode);
    const long long c = pair_count(m, p, i, mode);
    long long total;
    const long long start = carry + srt::block_exclusive_scan(c, &total);
    carry += total;
    if (c == 0) continue;
    if (mode == kSemi || mode == kAnti) {  // the kept row alone
      out_probe[start] = i;
      continue;
    }
    if (m == 0) {  // outer and full: the row with no match, null-extended
      out_probe[start] = i;
      out_build[start] = -1;
      continue;
    }
    const uint64_t h = srt::row_hash(p.k, i);
    const uint64_t tag = row_tag(p.k, i, h);
    long long o = start;
    for (uint64_t s = h & t.mask; t.slots[s] != kEmpty;
         s = (s + 1) & t.mask) {
      const long long r = slot_match(b, p, t, s, i, tag);
      if (r < 0) continue;
      out_probe[o] = i;
      out_build[o] = r;
      ++o;
    }
    // build rows of this probe row in ascending order
    for (long long a = start + 1; a < o; ++a) {
      const long long v = out_build[a];
      long long j = a - 1;
      while (j >= start && out_build[j] > v) {
        out_build[j + 1] = out_build[j];
        --j;
      }
      out_build[j + 1] = v;
    }
  }
}

// 1 for a build row no probe row matched
struct Unmatched {
  const uint8_t* flags;
  __device__ __forceinline__ long long operator()(int64_t i) const {
    return flags[i] ? 0 : 1;
  }
};

__global__ void __launch_bounds__(kThreads)
    unmatched_write(const uint8_t* __restrict__ flags, int64_t nb,
                    const int64_t* __restrict__ offsets, int64_t base,
                    long long* __restrict__ out_probe,
                    long long* __restrict__ out_build) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       r < nb; r += stride) {
    if (flags[r]) continue;
    out_probe[base + offsets[r]] = -1;
    out_build[base + offsets[r]] = r;
  }
}

bool valid_keys(int32_t n_keys, const int32_t* type) {
  if (n_keys < 1 || n_keys > srt::kMaxKeys) return false;
  for (int c = 0; c < n_keys; ++c)
    if (type[c] != srt::kKeyInt32 && type[c] != srt::kKeyInt64 &&
        type[c] != srt::kKeyString)
      return false;
  return true;
}

// a string key column of one side meets a string one on the other
bool same_kinds(int32_t n_keys, const int32_t* btype, const int32_t* ptype) {
  for (int c = 0; c < n_keys; ++c)
    if ((btype[c] == srt::kKeyString) != (ptype[c] == srt::kKeyString))
      return false;
  return true;
}

Side side(int32_t n_keys, int32_t null_safe, const int32_t* type,
          const int32_t* off64, const void* const* data,
          const void* const* valid, const void* const* offsets, int64_t n) {
  Keys k = srt::make_keys(n_keys, type, off64, data, valid, offsets);
  k.null_safe = static_cast<uint32_t>(null_safe);
  return Side{k, n};
}

Table table(const void* slots, const void* slot_tag, int64_t size) {
  return Table{static_cast<const long long*>(slots),
               static_cast<const uint64_t*>(slot_tag),
               static_cast<uint64_t>(size - 1)};
}

}  // namespace

// Each side's keys: n_keys columns, type[c] a keys.cuh KeyType (int32,
// int64 or string), data[c] the column's values (a string's chars),
// valid[c] its validity bytes (null: all present), and for a string
// offsets[c] (int64 where off64[c], else int32); null_safe: bit c marks
// key column c null-safe (the same on every call of one join).  slots,
// slot_tag: table_size int64 each (a power of two >= 2 * build rows).
extern "C" int srt_join_build(int32_t n_keys, int32_t null_safe,
                              const int32_t* type,
                              const int32_t* off64, const void* const* data,
                              const void* const* valid,
                              const void* const* offsets, int64_t n,
                              void* slots, void* slot_tag,
                              int64_t table_size, void* stream) {
  if (!valid_keys(n_keys, type) || table_size <= 0 ||
      (table_size & (table_size - 1)) != 0 || table_size < 2 * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  long long* sl = static_cast<long long*>(slots);
  table_clear<<<srt::grid_for(table_size), kThreads, 0, s>>>(sl, table_size);
  if (n > 0)
    table_build<<<srt::grid_for(n), kThreads, 0, s>>>(
        side(n_keys, null_safe, type, off64, data, valid, offsets, n), sl,
        static_cast<uint64_t*>(slot_tag),
        static_cast<uint64_t>(table_size - 1));
  return static_cast<int>(cudaGetLastError());
}

// mode: Mode.  flags: nb bytes in full mode (cleared here, then each
// matched build row's set), else null.  tile_offsets: srt::tiles_for(n) +
// 1 int64; after the call tile_offsets[tiles] holds the number of pairs
// (kept rows in semi and anti modes).
extern "C" int srt_join_count(int32_t n_keys, int32_t null_safe,
                              const int32_t* btype,
                              const int32_t* boff64, const void* const* bdata,
                              const void* const* bvalid,
                              const void* const* boffsets, int64_t nb,
                              const int32_t* ptype, const int32_t* poff64,
                              const void* const* pdata,
                              const void* const* pvalid,
                              const void* const* poffsets, int64_t n,
                              const void* slots, const void* slot_tag,
                              int64_t table_size, int32_t mode,
                              void* flags, void* tile_offsets,
                              void* stream) {
  if (mode < kInner || mode > kFull || !valid_keys(n_keys, btype) ||
      !valid_keys(n_keys, ptype) || !same_kinds(n_keys, btype, ptype) ||
      ((mode == kFull) != (flags != nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int64_t* offs = static_cast<int64_t*>(tile_offsets);
  uint8_t* fl = static_cast<uint8_t*>(flags);
  if (fl != nullptr && nb > 0) {
    const cudaError_t e = cudaMemsetAsync(fl, 0, nb, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (n == 0)
    return static_cast<int>(cudaMemsetAsync(offs, 0, sizeof(int64_t), s));
  const unsigned tiles = srt::tiles_for(n);
  probe_count<<<tiles, kThreads, 0, s>>>(
      side(n_keys, null_safe, btype, boff64, bdata, bvalid, boffsets, nb),
      side(n_keys, null_safe, ptype, poff64, pdata, pvalid, poffsets, n),
      table(slots, slot_tag, table_size), mode, fl, offs);
  srt::scan_tile_offsets<<<1, kThreads, 0, s>>>(offs, tiles, offs + tiles);
  return static_cast<int>(cudaGetLastError());
}

// out_build is not written in semi and anti modes (it may be null).
extern "C" int srt_join_write(int32_t n_keys, int32_t null_safe,
                              const int32_t* btype,
                              const int32_t* boff64, const void* const* bdata,
                              const void* const* bvalid,
                              const void* const* boffsets, int64_t nb,
                              const int32_t* ptype, const int32_t* poff64,
                              const void* const* pdata,
                              const void* const* pvalid,
                              const void* const* poffsets, int64_t n,
                              const void* slots, const void* slot_tag,
                              int64_t table_size, int32_t mode,
                              const void* tile_offsets, void* out_probe,
                              void* out_build, void* stream) {
  if (mode < kInner || mode > kFull || !valid_keys(n_keys, btype) ||
      !valid_keys(n_keys, ptype) || !same_kinds(n_keys, btype, ptype))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  probe_write<<<srt::tiles_for(n), kThreads, 0, s>>>(
      side(n_keys, null_safe, btype, boff64, bdata, bvalid, boffsets, nb),
      side(n_keys, null_safe, ptype, poff64, pdata, pvalid, poffsets, n),
      table(slots, slot_tag, table_size), mode,
      static_cast<const int64_t*>(tile_offsets),
      static_cast<long long*>(out_probe), static_cast<long long*>(out_build));
  return static_cast<int>(cudaGetLastError());
}

// K10f, after srt_join_count in full mode: offsets[r] = the unmatched
// build rows before row r, offsets[nb] = their number.  offsets: nb + 1
// int64; tile_scratch: srt::tiles_for(nb) int64.
extern "C" int srt_join_unmatched(const void* flags, int64_t nb,
                                  void* offsets, void* tile_scratch,
                                  void* stream) {
  if (nb < 0) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(srt::exclusive_scan(
      Unmatched{static_cast<const uint8_t*>(flags)}, nb,
      static_cast<int64_t*>(offsets), static_cast<int64_t*>(tile_scratch),
      static_cast<cudaStream_t>(stream)));
}

// K10f: each unmatched build row r as the pair (-1, r) at base +
// offsets[r] (base: the number of pairs srt_join_write wrote).
extern "C" int srt_join_unmatched_write(const void* flags, int64_t nb,
                                        const void* offsets, int64_t base,
                                        void* out_probe, void* out_build,
                                        void* stream) {
  if (nb < 0 || base < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (nb == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unmatched_write<<<srt::grid_for(nb), kThreads, 0, s>>>(
      static_cast<const uint8_t*>(flags), nb,
      static_cast<const int64_t*>(offsets), base,
      static_cast<long long*>(out_probe), static_cast<long long*>(out_build));
  return static_cast<int>(cudaGetLastError());
}
