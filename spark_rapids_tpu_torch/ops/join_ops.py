"""Equi-join pairs through a hash table: kernel K10 (the analog of
``spark_rapids_tpu/ops/join_ops.py``: ``build_side`` ``:125`` with
``_hash_rows`` ``:96``, ``_probe_ranges`` ``:157``, ``_expand_verify``
``:191`` and ``compact_pairs`` ``:290``, kinds ``join.build``,
``join.probe``, ``join.pair`` and ``join.compact_pairs``).

``join_pairs`` is the kernel's wrapper: given the build side's and the
probe side's key columns (one to eight each, int, date, long or string; a
column alone or a sequence), it returns the matching (probe row, build
row) pairs of an inner join, in probe-row order and, within a probe row,
in build-row order.  A row with a null in any key column never matches; an
int key equals a long one of the same value, a string key a string one of
the same bytes (an empty string is not null).
With ``outer=True`` (a left outer join, the probe side preserved) a probe
row with no match, a null key included, gives one pair (row, -1) in its
place: the JAX package's three finishing programs ``matched_flags``
(``:275``), ``unmatched_positions`` (``:313``) and
``concat_matched_unmatched`` (``:418``, kinds ``join.matched_flags``,
``join.unmatched``, ``join.concat_maps``) become one mode of the count
and write passes, which count ``max(1, matches)`` per probe row.  The
JAX package puts the matched pairs first and the unmatched rows after
them; here each unmatched row stays at its probe row's place.  With
``mode="semi"`` or ``"anti"`` (a left semi or anti join: the JAX
package's ``matched_flags`` and ``unmatched_positions`` in that role,
driven from ``exec/joins.py:433-513``) it returns only the kept probe
rows, in probe order: semi keeps a row with a match, once whatever the
build side's duplicates, and anti a row with none, a null key included
(the JAX package's plain anti join, ``sql/analyzer.py:24-26``).  With
``mode="full"`` (K10f: a full outer join, the JAX package's
``matched_flags`` on the build side, ``unmatched_positions`` and
``concat_matched_unmatched`` as its ``exec/joins.py:499-502, :544-551``
drive them) it returns the outer mode's pairs, then one pair ``(-1,
row)`` per build row no probe row matched (a null key included), in
build order, and the number of pairs before those; both counts come
back in the join's one read.  A right outer join is the outer mode with
the sides swapped (``exec/joins.py``).  On
CUDA columns it launches ``csrc/hash_join.cu`` (build, count, then write
after one sync that sizes the output exactly: the JAX package's
speculative sizing, ``ops/speculation.py``, is not carried over); on CPU
columns ``join_pairs_plain`` computes the same pairs with a stable sort
and binary search (over one id per distinct key tuple when there are
several key columns or a string one), and reads the pair count through
the gateway just as the kernel does.  Double keys are still to port
(ROADMAP queue 2, K10: Spark's NaN and -0.0 rules for joins are not
checked yet).

With ``null_safe`` (one flag, or a flag a key column: SQL's ``<=>``, the
JAX package's ``_expand_verify`` ``null_safe`` ``:192``, ``:234``) a null
in that key column is a value that equals a null: K10's null-safe mode
(``csrc/keys.cuh all_present``), which inserts a build row with such a
null and matches it in every mode; its launches outside the full mode
are counted apart (``NULL_SAFE_LAUNCHES``).  The plain version then keys
each null-safe column by its validity and its value under it.

``cross_pairs`` is the wrapper of K10x (``csrc/cross_join.cu``, the JAX
package's ``cross_pairs`` ``:251``, kind ``join.cross_pairs``): the
probe-major pairs ``(r // m, r % m)`` of an ``n x m`` cross join, sized on
the host (both row counts are exact there), so no sync; on CPU tensors
``cross_pairs_plain``."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K10, of K10f (its full mode, counted apart), of K10's
#: null-safe mode in the other modes (counted apart) and of K10x, the
#: cross join (wrapper calls that launch them)
LAUNCHES = 0
FULL_LAUNCHES = 0
NULL_SAFE_LAUNCHES = 0
CROSS_LAUNCHES = 0

#: probe rows one tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024
#: csrc/hash_join.cu Mode of each join type
MODES = {"inner": 0, "outer": 1, "semi": 2, "anti": 3, "full": 4}
KEY_TYPES = (T.IntegerType, T.LongType, T.DateType, T.StringType)
#: key columns one join takes (csrc/keys.cuh kMaxKeys)
MAX_KEYS = 8
#: csrc/keys.cuh kKeyString
STRING_KEY = 3

_SIGNATURES = {
    "srt_join_build": "iipppppqppqp",
    "srt_join_count": "iipppppqpppppqppqippp",
    "srt_join_write": "iipppppqpppppqppqipppp",
    "srt_join_unmatched": "pqppp",
    "srt_join_unmatched_write": "pqpqppp",
}
_CROSS_SIGNATURES = {"srt_cross_pairs": "qqppp"}

Keys = Union[DeviceColumn, Sequence[DeviceColumn]]


def load_library():
    """Builds (first call) and binds ``csrc/hash_join.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("join.hash", "csrc/hash_join.cu",
                        lambda: load_cuda("hash_join.cu", _SIGNATURES))


def load_cross_library():
    """Builds (first call) and binds ``csrc/cross_join.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("join.cross_pairs", "csrc/cross_join.cu",
                        lambda: load_cuda("cross_join.cu",
                                          _CROSS_SIGNATURES))


def table_size(n_build: int) -> int:
    """Slots of the build table: a power of two, at least twice the rows."""
    size = 16
    while size < 2 * n_build:
        size *= 2
    return size


def key_list(keys: Keys) -> List[DeviceColumn]:
    """One key column, or a sequence of them, as a list."""
    return [keys] if isinstance(keys, DeviceColumn) else list(keys)


def _check(build: List[DeviceColumn], probe: List[DeviceColumn]) -> None:
    if not 1 <= len(build) <= MAX_KEYS or len(probe) != len(build):
        raise NotImplementedError(
            f"K10 takes 1..{MAX_KEYS} key columns a side, the same number "
            f"on both; got {len(build)} and {len(probe)}")
    for c in (*build, *probe):
        if not isinstance(c.data_type, KEY_TYPES):
            raise NotImplementedError(
                f"a join key of {c.data_type} is not in the port yet "
                "(int, date, long and string keys are)")
        if c.device != probe[0].device:
            raise ValueError("build and probe keys lie on different "
                             "devices")
    for side in (build, probe):
        if any(c.row_count != side[0].row_count for c in side):
            raise ValueError("key columns of one side differ in length")
    for b, p in zip(build, probe):
        if b.is_string != p.is_string:
            raise TypeError(f"a {b.data_type} key cannot meet a "
                            f"{p.data_type} key")


def null_safe_flags(null_safe, n_keys: int) -> List[bool]:
    """Per key column, whether a null in it is a value that equals a null
    (``<=>``): one flag for every column, or a flag a column."""
    if null_safe is None or isinstance(null_safe, bool):
        return [bool(null_safe)] * n_keys
    flags = [bool(f) for f in null_safe]
    if len(flags) != n_keys:
        raise ValueError(f"{len(flags)} null-safe flags for {n_keys} keys")
    return flags


def _mode(outer: bool, mode: Optional[str]) -> str:
    if mode is None:
        return "outer" if outer else "inner"
    if mode not in ("semi", "anti", "full") or outer:
        raise ValueError(f"join mode {mode!r} with outer={outer}")
    return mode


def join_pairs(build: Keys, probe: Keys, transfers, outer: bool = False,
               mode: Optional[str] = None, null_safe=None):
    """K10's wrapper: ``(probe_rows, build_rows)``, int64, one entry per
    matching pair (and with ``outer``, one ``(row, -1)`` per probe row
    with no match); with ``mode`` ``"semi"`` or ``"anti"``, ``(kept probe
    rows, None)``; with ``mode="full"`` (K10f), ``(probe_rows,
    build_rows, pairs)``: the outer pairs, then ``(-1, row)`` for each
    unmatched build row, and the number of pairs before those.
    ``null_safe`` (a flag, or one a key column) makes a null in a key
    column a value equal to a null (``<=>``)."""
    build, probe = key_list(build), key_list(probe)
    _check(build, probe)
    kind = _mode(outer, mode)
    safe = null_safe_flags(null_safe, len(build))
    device = probe[0].device
    if device.type == "cpu":
        return join_pairs_plain(build, probe, transfers, outer, mode, safe)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    nb, n = build[0].row_count, probe[0].row_count
    size = table_size(nb)
    tiles = -(-n // SCAN_TILE)

    def keys(cols):
        """(key types, int64-offset flags, data, validity, offsets) of one
        side, each held by name until the launches are queued."""
        data = [c.data.contiguous() for c in cols]
        valid = [None if c.all_valid else
                 c.validity.contiguous().view(torch.uint8) for c in cols]
        offsets = [c.offsets.contiguous() if c.is_string else None
                   for c in cols]
        types = int32s([STRING_KEY if c.is_string else
                        int(d.dtype == torch.int64)
                        for c, d in zip(cols, data)])
        off64 = int32s([int(o is not None and o.dtype == torch.int64)
                        for o in offsets])
        return types, off64, data, valid, offsets

    mask = sum(1 << c for c, f in enumerate(safe) if f)
    btypes, boff64, bdata, bvalid, boffsets = keys(build)
    ptypes, poff64, pdata, pvalid, poffsets = keys(probe)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        slots = torch.empty(size, dtype=torch.int64, device=device)
        slot_tag = torch.empty(size, dtype=torch.int64, device=device)
        tile_offsets = torch.empty(tiles + 1, dtype=torch.int64,
                                   device=device)
        full = kind == "full"
        flags = torch.empty(max(nb, 1), dtype=torch.uint8, device=device) \
            if full else None
        table = (slots.data_ptr(), slot_tag.data_ptr(), size)
        bargs = (btypes, boff64, pointers(bdata), pointers(bvalid),
                 pointers(boffsets), nb)
        check_launch(lib.srt_join_build(len(build), mask, *bargs, *table,
                                        stream), "K10 build")
        probe_args = (len(build), mask, *bargs, ptypes, poff64,
                      pointers(pdata),
                      pointers(pvalid), pointers(poffsets), n, *table,
                      MODES[kind])
        check_launch(lib.srt_join_count(
            *probe_args, None if flags is None else flags.data_ptr(),
            tile_offsets.data_ptr(), stream), "K10 count")
        counts = [tile_offsets[tiles]]
        if full:
            # K10f: the unmatched build rows' offsets, counted in the same
            # read as the pairs
            unmatched = torch.empty(nb + 1, dtype=torch.int64,
                                    device=device)
            scratch = torch.empty(max(-(-nb // SCAN_TILE), 1),
                                  dtype=torch.int64, device=device)
            check_launch(lib.srt_join_unmatched(
                flags.data_ptr(), nb, unmatched.data_ptr(),
                scratch.data_ptr(), stream), "K10f unmatched")
            counts.append(unmatched[nb])
        got = transfers.read_counts(counts)
        total, extra = got[0], (got[1] if full else 0)
        out_probe = torch.empty(total + extra, dtype=torch.int64,
                                device=device)
        out_build = None if mode in ("semi", "anti") else \
            torch.empty(total + extra, dtype=torch.int64, device=device)
        if total:
            check_launch(lib.srt_join_write(
                *probe_args, tile_offsets.data_ptr(), out_probe.data_ptr(),
                None if out_build is None else out_build.data_ptr(),
                stream), "K10 write")
        if extra:
            check_launch(lib.srt_join_unmatched_write(
                flags.data_ptr(), nb, unmatched.data_ptr(), total,
                out_probe.data_ptr(), out_build.data_ptr(), stream),
                "K10f unmatched write")
    global LAUNCHES, FULL_LAUNCHES, NULL_SAFE_LAUNCHES
    if full:
        FULL_LAUNCHES += 1
        return out_probe, out_build, total
    if mask:
        NULL_SAFE_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out_probe, out_build


def _string_ids(b: DeviceColumn, p: DeviceColumn):
    """One int64 id per row of two string columns, equal where the bytes
    are: the index of the row's (length, bytes) among the distinct ones
    of both columns."""
    from spark_rapids_tpu_torch.ops.agg_ops import _padded_chars
    mats = [_padded_chars(c) for c in (b, p)]
    width = max(m.shape[1] for m in mats)
    rows = torch.cat([torch.cat([
        (c.offsets[1:] - c.offsets[:-1]).to(torch.int64)[:, None],
        torch.nn.functional.pad(m.to(torch.int64), (0, width - m.shape[1]))],
        1) for c, m in zip((b, p), mats)])
    _u, ids = torch.unique(rows, dim=0, return_inverse=True)
    return ids[:b.row_count], ids[b.row_count:]


def _key_ids(build: List[DeviceColumn], probe: List[DeviceColumn],
             null_safe: Sequence[bool]):
    """One int64 key per row of each side and whether the row may match
    (every key column present, or null in a null-safe one): the column
    itself for one int, date or long key that is not null-safe, else the
    index of the row's key tuple among the distinct tuples of both sides
    (an int key widened to long, so it equals a long of the same value; a
    string as its id among both sides' strings; a null-safe column as
    its validity and its value under it, 0 under a null)."""
    def valid(cols):
        v = torch.ones(cols[0].row_count, dtype=torch.bool,
                       device=cols[0].device)
        for c, safe in zip(cols, null_safe):
            if not safe:
                v = v & c.validity
        return v

    words = []
    for b, p, safe in zip(build, probe, null_safe):
        w = _string_ids(b, p) if b.is_string else \
            (b.data.to(torch.int64), p.data.to(torch.int64))
        if safe:
            words += [(b.validity.to(torch.int64),
                       p.validity.to(torch.int64)),
                      (torch.where(b.validity, w[0], 0),
                       torch.where(p.validity, w[1], 0))]
        else:
            words.append(w)
    if len(words) == 1:
        return words[0][0], valid(build), words[0][1], valid(probe)
    words = torch.cat([torch.stack([w[side] for w in words], 1)
                       for side in (0, 1)])
    _u, ids = torch.unique(words, dim=0, return_inverse=True)
    nb = build[0].row_count
    return ids[:nb], valid(build), ids[nb:], valid(probe)


def join_pairs_plain(build: Keys, probe: Keys, transfers,
                     outer: bool = False, mode: Optional[str] = None,
                     null_safe=None):
    """The plain PyTorch version of K10: the build side's present keys
    sorted stably, each probe key's range of equals found by binary
    search, the ranges expanded into pairs (an empty range into one pair
    with build row -1 when ``outer`` or in full mode); in semi and anti
    modes the probe rows whose range is not empty, or is; in full mode
    then the build rows no pair holds, with probe row -1."""
    build, probe = key_list(build), key_list(probe)
    _check(build, probe)
    _mode(outer, mode)
    safe = null_safe_flags(null_safe, len(build))
    device = probe[0].device
    bk, bvalid, pk, pvalid = _key_ids(build, probe, safe)
    rows = torch.nonzero(bvalid).flatten()
    keys, order = torch.sort(bk[rows], stable=True)
    rows = rows[order]
    lo = torch.searchsorted(keys, pk, right=False)
    hi = torch.searchsorted(keys, pk, right=True)
    count = torch.where(pvalid, hi - lo, 0)
    if mode in ("semi", "anti"):
        keep = (count > 0) if mode == "semi" else (count == 0)
        transfers.read_counts([keep.sum()])
        return torch.nonzero(keep).flatten(), None
    full = mode == "full"
    emit = count.clamp(min=1) if outer or full else count
    if full:
        # the build rows in some probe row's range of equals
        hit = torch.zeros(rows.numel() + 1, dtype=torch.int64,
                          device=device)
        hit.index_add_(0, torch.where(count > 0, lo, rows.numel()),
                       torch.ones_like(lo))
        hit.index_add_(0, torch.where(count > 0, hi, rows.numel()),
                       -torch.ones_like(lo))
        matched = torch.zeros(build[0].row_count, dtype=torch.bool,
                              device=device)
        matched[rows] = torch.cumsum(hit, 0)[:-1] > 0
        unmatched = torch.nonzero(~matched).flatten()
        total, _extra = transfers.read_counts([emit.sum(),
                                               (~matched).sum()])
        pairs = join_pairs_plain(build, probe, _NoSync(), outer=True,
                                 null_safe=safe)
        return (torch.cat([pairs[0], torch.full_like(unmatched, -1)]),
                torch.cat([pairs[1], unmatched]), total)
    total, = transfers.read_counts([emit.sum()])
    n = probe[0].row_count
    out_probe = torch.repeat_interleave(
        torch.arange(n, dtype=torch.int64, device=device), emit,
        output_size=total)
    first = torch.cumsum(emit, 0) - emit
    within = torch.arange(total, dtype=torch.int64, device=device) - \
        torch.repeat_interleave(first, emit, output_size=total)
    at = torch.repeat_interleave(lo, emit, output_size=total) + within
    matched = torch.repeat_interleave(count > 0, emit, output_size=total)
    if not rows.numel():
        return out_probe, torch.full_like(out_probe, -1)
    out_build = torch.where(matched, rows[at.clamp(max=rows.numel() - 1)],
                            -1)
    return out_probe, out_build


class _NoSync:
    """A stand-in gateway for a plain version's inner call, whose counts
    its caller has already read."""

    @staticmethod
    def read_counts(counts):
        return [int(c) for c in counts]


def _check_cross(n_probe: int, n_build: int) -> None:
    if n_probe < 0 or n_build < 0:
        raise ValueError(f"row counts {n_probe} and {n_build}")
    if n_probe * n_build >= 2 ** 63:
        raise ValueError(f"a cross join of {n_probe} x {n_build} rows "
                         "does not fit int64 indices")


def cross_pairs(n_probe: int, n_build: int, device: torch.device
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10x's wrapper: ``(probe rows, build rows)``, int64, the ``n_probe
    * n_build`` probe-major pairs of a cross join (empty when either side
    is)."""
    _check_cross(n_probe, n_build)
    device = torch.device(device)
    if device.type == "cpu":
        return cross_pairs_plain(n_probe, n_build, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import check_launch
    total = n_probe * n_build
    out_probe = torch.empty(total, dtype=torch.int64, device=device)
    out_build = torch.empty(total, dtype=torch.int64, device=device)
    if total:
        lib = load_cross_library()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            check_launch(lib.srt_cross_pairs(
                n_probe, n_build, out_probe.data_ptr(),
                out_build.data_ptr(), stream), "K10x cross pairs")
        global CROSS_LAUNCHES
        CROSS_LAUNCHES += 1
    return out_probe, out_build


def cross_pairs_plain(n_probe: int, n_build: int, device: torch.device
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K10x."""
    _check_cross(n_probe, n_build)
    r = torch.arange(n_probe * n_build, dtype=torch.int64, device=device)
    m = max(n_build, 1)
    return torch.div(r, m, rounding_mode="floor"), torch.remainder(r, m)
