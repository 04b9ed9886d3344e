"""A shuffle exchange's kernels (``csrc/partition.cu``, ``csrc/murmur3.cuh``):
partition ids and their histogram, K11h by hash (the analog of
``spark_rapids_tpu/plan/partitioning.py:77 HashPartitioning.
partition_ids_tpu``) and K11r by range (``:186 RangePartitioning.
partition_ids_tpu``), and K7s, the split of a batch into one contiguous
segment per partition (``ops/batch_ops.py:71 compact_batch`` once per
partition, ``exec/exchange.py:623-627``).

``hash_partition`` and ``range_partition`` are K11h's and K11r's wrappers.
Both give each row's pid (int32) and the histogram: the rows of each
partition, then, for each string column the split will move, its chars
in each partition (int64 ``[(1 + strings) * n]``), so the exchange's one
read (``TransferGateway.read_counts``) sizes every plane of the split.
A hash key is a column (or a ``HashColumn`` of raw planes, such as a
float32 one) whose type K11h reads from its planes: int32 (int, date),
int64, float32, float64, bool and strings; ``as_long`` hashes int keys as
longs (a join's key against a long partner).  A range key is an int,
date, long, double or string column, held against bound rows of the same
types in the given ``(ascending, nulls_first)`` orders.

``split_columns`` is K7s's wrapper: from the pids and the host-read
histogram it writes every column's planes ordered by partition, stably,
and returns each partition's columns as views (a string's offsets per
segment, each from 0).  On no rows the wrappers launch nothing and count
no launch.

On CPU tensors the wrappers run the plain versions: murmur3 of
``expressions/hashing.py`` with ``pmod``, a binary search over the order
words of ``ops/sort_ops.py`` (a rank word for every key, so rows and
bounds have the same words), ``torch.bincount``, and a stable argsort
with K7's plain gather."""

from __future__ import annotations

import collections
from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K11h, K11r and K7s (wrapper calls that launch them)
HASH_LAUNCHES = 0
RANGE_LAUNCHES = 0
SPLIT_LAUNCHES = 0

#: partitions one launch takes (csrc/partition.cu kMaxParts)
MAX_PARTITIONS = 1024
#: hash columns (csrc/murmur3.cuh kMaxHashCols), range key columns
MAX_HASH_KEYS = 8
MAX_RANGE_KEYS = 8
#: string columns one histogram counts chars for, planes one split launch
MAX_STRINGS = 32
MAX_PLANES = 32
#: rows of a K7s tile (csrc/partition.cu kSplitTile), values a scan tile
SPLIT_TILE = 4096
SCAN_TILE = 1024

#: murmur3.cuh HashType of each plane dtype
_HASH_CODES = {torch.int32: 0, torch.int64: 1, torch.float64: 2,
               torch.float32: 4, torch.bool: 5}
_HASH_STRING, _HASH_INT_AS_LONG = 3, 6
#: keys.cuh KeyType of each range key type
_RANGE_CODES = {T.INT: 0, T.DATE: 0, T.LONG: 1, T.DOUBLE: 2, T.STRING: 3}
RANGE_KEY_TYPES = tuple(_RANGE_CODES)


def _range_code(dt: T.DataType) -> int:
    """K11r's code of a key type: a decimal64 is its unscaled long."""
    if isinstance(dt, T.DecimalType) and not dt.is_decimal128:
        return _RANGE_CODES[T.LONG]
    if dt not in _RANGE_CODES:
        raise NotImplementedError(
            f"a range key of {dt} is not in the port yet (int, date, long, "
            "double, decimal64 and string keys are)")
    return _RANGE_CODES[dt]

_SIGNATURES = {
    "srt_hash_partition": "ipppppqipippp" + "p",
    "srt_range_partition": "ipppppqppppqppipipppp",
    "srt_split_rows": "pqipppp" + "p",
    "srt_split_fixed": "pqipppp",
    "srt_split_string_offsets": "pqpipipppp" + "p",
    "srt_split_string_chars": "pqpipppp",
}

#: raw planes of a hash key: ``validity`` None has no null, ``offsets``
#: marks a string (``data`` its chars)
HashColumn = collections.namedtuple("HashColumn",
                                    "data validity offsets")


def load_library():
    """Builds (first call) and binds ``csrc/partition.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("exchange.partition", "csrc/partition.cu",
                        lambda: load_cuda("partition.cu", _SIGNATURES))


def _planes(c) -> HashColumn:
    """A column's planes (its validity None when it holds no null)."""
    if isinstance(c, HashColumn):
        return c
    return HashColumn(c.data, None if c.all_valid else c.validity,
                      c.offsets)


def hash_code(c: HashColumn, as_long: bool = False) -> int:
    if c.offsets is not None:
        return _HASH_STRING
    if c.data.dtype not in _HASH_CODES or c.data.dim() != 1:
        raise NotImplementedError(
            f"a hash key of {c.data.dtype} is not in the port yet")
    code = _HASH_CODES[c.data.dtype]
    return _HASH_INT_AS_LONG if as_long and code == 0 else code


def _check_parts(n_parts: int) -> None:
    if not 1 <= n_parts <= MAX_PARTITIONS:
        raise NotImplementedError(
            f"an exchange into {n_parts} partitions is not in the port yet "
            f"(1 to {MAX_PARTITIONS} are)")


def _check_rows(cols, n: int, device) -> None:
    for c in cols:
        rows = c.offsets.shape[0] - 1 if c.offsets is not None \
            else c.data.shape[0]
        if rows != n:
            raise ValueError("columns of different lengths")
        if c.data.device != device:
            raise ValueError("columns lie on different devices")


def _check_strings(strings, n: int, device) -> None:
    if len(strings) > MAX_STRINGS:
        raise NotImplementedError(
            f"an exchange of more than {MAX_STRINGS} string columns is not "
            "in the port yet")
    if any(c.offsets is None for c in strings):
        raise ValueError("the histogram counts chars of string columns")
    _check_rows(strings, n, device)


def _no_rows(n_parts: int, n_strings: int, device
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ids and histogram of no rows: nothing to launch."""
    return (torch.empty(0, dtype=torch.int32, device=device),
            torch.zeros((1 + n_strings) * n_parts, dtype=torch.int64,
                        device=device))


def _string_args(strings):
    from spark_rapids_tpu_torch.kernels.build import int32s, pointers
    offs = [c.offsets.contiguous() for c in strings]
    return offs, int32s([int(o.dtype == torch.int64) for o in offs]), \
        pointers(offs)


# -- K11h ---------------------------------------------------------------------

def hash_partition(keys: Sequence, n_parts: int, strings: Sequence = (),
                   as_long: Optional[Sequence[bool]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11h's wrapper: ``(pids int32[rows], counts int64[(1 + len(strings))
    * n_parts])``; pid = pmod(murmur3(keys, 42), n_parts)."""
    keys = [_planes(k) for k in keys]
    if not 1 <= len(keys) <= MAX_HASH_KEYS:
        raise NotImplementedError(
            f"a hash exchange on {len(keys)} keys is not in the port yet "
            f"(1 to {MAX_HASH_KEYS} are)")
    _check_parts(n_parts)
    as_long = list(as_long) if as_long is not None else [False] * len(keys)
    codes = [hash_code(k, wide) for k, wide in zip(keys, as_long)]
    device = keys[0].data.device
    n = keys[0].offsets.shape[0] - 1 if keys[0].offsets is not None \
        else keys[0].data.shape[0]
    _check_rows(keys, n, device)
    _check_strings(strings, n, device)
    if n == 0:
        return _no_rows(n_parts, len(strings), device)
    if device.type == "cpu":
        return hash_partition_plain(keys, n_parts, strings, as_long)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # held by name until the launch is queued
        data = [k.data.contiguous() for k in keys]
        valid = [None if k.validity is None else
                 k.validity.contiguous().view(torch.uint8) for k in keys]
        offs = [None if k.offsets is None else k.offsets.contiguous()
                for k in keys]
        pids = torch.empty(n, dtype=torch.int32, device=device)
        counts = torch.empty((1 + len(strings)) * n_parts,
                             dtype=torch.int64, device=device)
        soffs, soff64, sptrs = _string_args(strings)
        check_launch(lib.srt_hash_partition(
            len(keys), int32s(codes),
            int32s([int(o is not None and o.dtype == torch.int64)
                    for o in offs]),
            pointers(data), pointers(valid), pointers(offs), n, n_parts,
            pids.data_ptr(), len(strings), soff64, sptrs, counts.data_ptr(),
            stream), "K11h hash partition")
    global HASH_LAUNCHES
    HASH_LAUNCHES += 1
    return pids, counts


def murmur3_rows(keys: Sequence, as_long: Optional[Sequence[bool]] = None
                 ) -> torch.Tensor:
    """Spark's hash(keys...) of each row (int32), with torch ops: the
    plain version of K11h's hash."""
    from spark_rapids_tpu_torch.expressions import hashing as H
    keys = [_planes(k) for k in keys]
    as_long = list(as_long) if as_long is not None else [False] * len(keys)
    n = keys[0].offsets.shape[0] - 1 if keys[0].offsets is not None \
        else keys[0].data.shape[0]
    h = torch.full((n,), 42, dtype=torch.int64, device=keys[0].data.device)
    for k, wide in zip(keys, as_long):
        code = hash_code(k, wide)
        if code == _HASH_STRING:
            hk = H.hash_string(k.offsets, k.data, h)
        elif code in (1, _HASH_INT_AS_LONG):
            hk = H.hash_long(k.data.to(torch.int64), h)
        elif code == 2:
            hk = H.hash_double(k.data, h)
        elif code == 4:
            hk = H.hash_float(k.data, h)
        else:
            hk = H.hash_int(k.data.to(torch.int64), h)
        h = hk if k.validity is None else torch.where(k.validity, hk, h)
    return H.to_int32(h)


def histogram_plain(pids: torch.Tensor, n_parts: int,
                    strings: Sequence = ()) -> torch.Tensor:
    """Rows, then each string column's chars, of each partition."""
    out = [torch.bincount(pids.to(torch.int64), minlength=n_parts)]
    for c in strings:
        off = c.offsets.to(torch.int64)
        out.append(torch.zeros(n_parts, dtype=torch.int64,
                               device=pids.device).index_add_(
            0, pids.to(torch.int64), off[1:] - off[:-1]))
    return torch.cat(out).to(torch.int64)


def hash_partition_plain(keys: Sequence, n_parts: int,
                         strings: Sequence = (),
                         as_long: Optional[Sequence[bool]] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K11h."""
    h = murmur3_rows(keys, as_long).to(torch.int64)
    pids = torch.remainder(h, n_parts).to(torch.int32)
    return pids, histogram_plain(pids, n_parts, strings)


# -- K11r ---------------------------------------------------------------------

def _check_range(keys, bounds, orders, n_parts) -> None:
    if not 1 <= len(keys) <= MAX_RANGE_KEYS:
        raise NotImplementedError(
            f"a range exchange on {len(keys)} keys is not in the port yet "
            f"(1 to {MAX_RANGE_KEYS} are)")
    if len(bounds) != len(keys) or len(orders) != len(keys):
        raise ValueError("one bound column and one order per key")
    _check_parts(n_parts)
    for k, b in zip(keys, bounds):
        _range_code(k.data_type)
        if b.data_type != k.data_type:
            raise TypeError(f"a bound of {b.data_type} for a key of "
                            f"{k.data_type}")
    n_bounds = bounds[0].row_count
    if n_bounds >= n_parts:
        raise ValueError(f"{n_bounds} bounds for {n_parts} partitions")


def range_partition(keys: Sequence[DeviceColumn],
                    bounds: Sequence[DeviceColumn],
                    orders: Sequence[Tuple[bool, bool]], n_parts: int,
                    strings: Sequence = ()
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K11r's wrapper: ``(pids, counts)`` as K11h's; a row's pid is the
    number of the sorted bound rows it is strictly above, in the order of
    ``orders`` (``(ascending, nulls_first)`` per key)."""
    _check_range(keys, bounds, orders, n_parts)
    device = keys[0].device
    n = keys[0].row_count
    _check_rows(list(keys), n, device)
    _check_strings(strings, n, device)
    if n == 0:
        return _no_rows(n_parts, len(strings), device)
    if device.type == "cpu":
        return range_partition_plain(keys, bounds, orders, n_parts, strings)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()

    def args(cols):
        data = [c.data.contiguous() for c in cols]
        valid = [None if c.all_valid else
                 c.validity.contiguous().view(torch.uint8) for c in cols]
        offs = [c.offsets.contiguous() if c.is_string else None
                for c in cols]
        off64 = int32s([int(o is not None and o.dtype == torch.int64)
                        for o in offs])
        return (data, valid, offs), off64

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # held by name until the launch is queued
        held, off64 = args(keys)
        bheld, boff64 = args(bounds)
        pids = torch.empty(n, dtype=torch.int32, device=device)
        counts = torch.empty((1 + len(strings)) * n_parts,
                             dtype=torch.int64, device=device)
        soffs, soff64, sptrs = _string_args(strings)
        check_launch(lib.srt_range_partition(
            len(keys), int32s([_range_code(k.data_type) for k in keys]),
            off64, *(pointers(h) for h in held), n, boff64,
            *(pointers(h) for h in bheld), bounds[0].row_count,
            int32s([int(a) for a, _nf in orders]),
            int32s([int(nf) for _a, nf in orders]), n_parts,
            pids.data_ptr(), len(strings), soff64, sptrs, counts.data_ptr(),
            stream), "K11r range partition")
    global RANGE_LAUNCHES
    RANGE_LAUNCHES += 1
    return pids, counts


def range_words_plain(keys: Sequence[DeviceColumn],
                      orders: Sequence[Tuple[bool, bool]],
                      n_words: Sequence[int]) -> List[torch.Tensor]:
    """int64 words whose signed lexicographic order is the keys' SQL order
    (``ops/sort_ops.py order_words_plain``, with a rank word for every key
    and ``n_words`` words for a string key), so rows and bounds compare
    word by word."""
    from spark_rapids_tpu_torch.ops.sort_ops import (SortOrder,
                                                     order_words_plain)
    words = []
    for c, (asc, nf), w in zip(keys, orders, n_words):
        if c.all_valid:
            c = DeviceColumn(c.data, c.validity, c.data_type, False,
                             c.offsets)
        words += order_words_plain(c, SortOrder(0, asc, nf), w)
    return words


def range_partition_plain(keys: Sequence[DeviceColumn],
                          bounds: Sequence[DeviceColumn],
                          orders: Sequence[Tuple[bool, bool]], n_parts: int,
                          strings: Sequence = ()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K11r: a binary search over the bounds'
    order words."""
    from spark_rapids_tpu_torch.ops.sort_ops import (string_longest_plain,
                                                     string_word_count)
    _check_range(keys, bounds, orders, n_parts)
    n = keys[0].row_count
    device = keys[0].device
    n_words = []
    for k, b in zip(keys, bounds):
        longest = 0
        if k.is_string:
            longest = max(int(string_longest_plain(k)) if n else 0,
                          int(string_longest_plain(b))
                          if b.row_count else 0)
        n_words.append(string_word_count(longest))
    rows = range_words_plain(keys, orders, n_words)
    bws = range_words_plain(bounds, orders, n_words)
    lo = torch.zeros(n, dtype=torch.int64, device=device)
    hi = torch.full((n,), bounds[0].row_count, dtype=torch.int64,
                    device=device)
    while bool((lo < hi).any()):
        mid = torch.div(lo + hi, 2, rounding_mode="floor")
        at = mid.clamp(max=max(bounds[0].row_count - 1, 0))
        gt = torch.zeros(n, dtype=torch.bool, device=device)
        eq = torch.ones(n, dtype=torch.bool, device=device)
        for rw, bw in zip(rows, bws):
            b = bw[at]
            gt |= eq & (rw > b)
            eq &= rw == b
        open_ = lo < hi
        lo = torch.where(open_ & gt, mid + 1, lo)
        hi = torch.where(open_ & ~gt, mid, hi)
    pids = lo.to(torch.int32)
    return pids, histogram_plain(pids, n_parts, strings)


# -- K7s ----------------------------------------------------------------------

def _segment_views(planes, columns, row_base: List[int],
                   char_base: List[List[int]]) -> List[List[DeviceColumn]]:
    """Each partition's columns, as views of the split planes: ``planes``
    is ``(data, validity, segment offsets or None)`` per column."""
    n_parts = len(row_base) - 1
    out = []
    for p in range(n_parts):
        lo, hi = row_base[p], row_base[p + 1]
        cols, s = [], 0
        for (data, valid, seg_off), c in zip(planes, columns):
            if seg_off is None:
                cols.append(DeviceColumn(data[lo:hi], valid[lo:hi],
                                         c.data_type, c.all_valid))
                continue
            cb = char_base[s]
            s += 1
            cols.append(DeviceColumn(data[cb[p]:cb[p + 1]], valid[lo:hi],
                                     c.data_type, c.all_valid,
                                     seg_off[lo + p:hi + p + 1]))
        out.append(cols)
    return out


def _bases(row_counts, char_counts):
    row_base = [0]
    for r in row_counts:
        row_base.append(row_base[-1] + r)
    char_base = []
    for counts in char_counts:
        cb = [0]
        for r in counts:
            cb.append(cb[-1] + r)
        char_base.append(cb)
    return row_base, char_base


def _check_split(columns, pids, row_counts, char_counts) -> None:
    n = pids.shape[0]
    if pids.dtype != torch.int32 or pids.dim() != 1:
        raise TypeError("pids must be a 1-D int32 tensor")
    _check_parts(len(row_counts))
    if sum(row_counts) != n:
        raise ValueError("the row counts do not add up to the rows")
    n_strings = sum(c.is_string for c in columns)
    if len(char_counts) != n_strings or \
            any(len(cc) != len(row_counts) for cc in char_counts):
        raise ValueError("one char count per partition for each string "
                         "column")
    for c in columns:
        if c.row_count != n or c.device != pids.device:
            raise ValueError("columns and pids of different rows or "
                             "devices")


def split_columns(columns: Sequence[DeviceColumn], pids: torch.Tensor,
                  row_counts: Sequence[int],
                  char_counts: Sequence[Sequence[int]] = (),
                  transfers=None) -> List[List[DeviceColumn]]:
    """K7s's wrapper: ``[partition][column]`` views of one stable scatter
    of every column by pid.  ``row_counts[p]`` and, per string column in
    column order, ``char_counts[s][p]`` are the histogram's counts; a
    string column's segment starts go up through ``transfers``."""
    _check_split(columns, pids, row_counts, char_counts)
    device = pids.device
    if pids.shape[0] == 0:
        # nothing to launch: every partition holds the empty columns
        return [list(columns) for _ in row_counts]
    if device.type == "cpu":
        return split_columns_plain(columns, pids, row_counts, char_counts,
                                   transfers)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.ops.batch_ops import (empty_rows,
                                                      fixed_plane, row_bytes)
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    n = pids.shape[0]
    n_parts = len(row_counts)
    row_base, char_base = _bases(row_counts, char_counts)

    def empty(count, dtype=torch.int64):
        return torch.empty(count, dtype=dtype, device=device)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        pids = pids.contiguous()
        tiles = -(-n // SPLIT_TILE)
        # scratch is held by name until the launches are queued
        hist = empty(max(1, tiles * n_parts), torch.int32)
        base = empty(tiles * n_parts + 1)
        scan_tiles = empty(max(1, -(-(tiles * n_parts) // SCAN_TILE)))
        dest = empty(n)
        check_launch(lib.srt_split_rows(
            pids.data_ptr(), n, n_parts, hist.data_ptr(), base.data_ptr(),
            scan_tiles.data_ptr(), dest.data_ptr(), stream), "K7s rows")
        planes, fixed = [], []      # fixed: (source, destination, width)
        for c in columns:
            valid = empty(n, torch.bool)
            fixed.append((c.validity.contiguous().view(torch.uint8),
                          valid.view(torch.uint8), 1))
            if c.is_string:
                planes.append([None, valid, None])
                continue
            src = fixed_plane(c.data)
            data = empty_rows(src, n)
            fixed.append((src, data, row_bytes(src)))
            planes.append([data, valid, None])
        for k in range(0, len(fixed), MAX_PLANES):
            chunk = fixed[k:k + MAX_PLANES]
            check_launch(lib.srt_split_fixed(
                dest.data_ptr(), n, len(chunk),
                pointers([f[0] for f in chunk]),
                pointers([f[1] for f in chunk]),
                int32s([f[2] for f in chunk]), stream), "K7s planes")
        strings = [j for j, c in enumerate(columns) if c.is_string]
        if strings:
            if transfers is None:
                raise ValueError("a string column's split needs the "
                                 "transfer gateway")
            import numpy as np
            row_base_dev = transfers.to_device(np.array(row_base,
                                                        dtype=np.int64))
            lens = empty(n)
            gpos = empty(n + 1)
            len_tiles = empty(max(1, -(-n // SCAN_TILE)))
        for s, j in enumerate(strings):
            c = columns[j]
            offs = c.offsets.contiguous()
            src_chars = c.data.contiguous()
            off64 = int(offs.dtype == torch.int64)
            seg_off = empty(n + n_parts)
            chars = empty(char_base[s][-1], torch.uint8)
            check_launch(lib.srt_split_string_offsets(
                dest.data_ptr(), n, offs.data_ptr(), off64,
                row_base_dev.data_ptr(), n_parts, lens.data_ptr(),
                len_tiles.data_ptr(), gpos.data_ptr(), seg_off.data_ptr(),
                stream), "K7s string offsets")
            check_launch(lib.srt_split_string_chars(
                dest.data_ptr(), n, offs.data_ptr(), off64,
                src_chars.data_ptr(), gpos.data_ptr(),
                chars.data_ptr(), stream), "K7s string chars")
            planes[j][0] = chars
            planes[j][2] = seg_off
    global SPLIT_LAUNCHES
    SPLIT_LAUNCHES += 1
    return _segment_views(planes, columns, row_base, char_base)


def split_columns_plain(columns: Sequence[DeviceColumn], pids: torch.Tensor,
                        row_counts: Sequence[int],
                        char_counts: Sequence[Sequence[int]] = (),
                        transfers=None) -> List[List[DeviceColumn]]:
    """The plain PyTorch version of K7s: a stable argsort of the pids and
    K7's plain gather, then each string's offsets cut per segment."""
    from spark_rapids_tpu_torch.ops.batch_ops import gather_columns_plain
    _check_split(columns, pids, row_counts, char_counts)
    n_parts = len(row_counts)
    row_base, char_base = _bases(row_counts, char_counts)
    perm = torch.argsort(pids.to(torch.int64), stable=True)
    moved = gather_columns_plain(columns, perm, None, unique=True)
    planes = []
    for c in moved:
        if not c.is_string:
            planes.append((c.data, c.validity, None))
            continue
        off = c.offsets.to(torch.int64)
        pieces = [off[row_base[p]:row_base[p + 1] + 1] - off[row_base[p]]
                  for p in range(n_parts)]
        planes.append((c.data, c.validity, torch.cat(pieces)))
    return _segment_views(planes, columns, row_base, char_base)
