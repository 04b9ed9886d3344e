"""Equi-join pairs through a hash table: kernel K10 (the analog of
``spark_rapids_tpu/ops/join_ops.py``: ``build_side`` ``:125`` with
``_hash_rows`` ``:96``, ``_probe_ranges`` ``:157``, ``_expand_verify``
``:191`` and ``compact_pairs`` ``:290``, kinds ``join.build``,
``join.probe``, ``join.pair`` and ``join.compact_pairs``).

``join_pairs`` is the kernel's wrapper: given the build side's and the
probe side's key columns (one to eight each, int, date or long; a column
alone or a sequence), it returns the matching (probe row, build row) pairs
of an inner join, in probe-row order and, within a probe row, in
build-row order.  A row with a null in any key column never matches; an
int key equals a long one of the same value.
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
(the JAX package's plain anti join, ``sql/analyzer.py:24-26``).  On
CUDA columns it launches ``csrc/hash_join.cu`` (build, count, then write
after one sync that sizes the output exactly: the JAX package's
speculative sizing, ``ops/speculation.py``, is not carried over); on CPU
columns ``join_pairs_plain`` computes the same pairs with a stable sort
and binary search (over one id per distinct key tuple when there are
several key columns), and reads the pair count through the gateway just
as the kernel does.  String and double keys are still to port (ROADMAP
queue 2, K10)."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple, Union

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K10 (wrapper calls that launch it)
LAUNCHES = 0

#: probe rows one tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024
#: csrc/hash_join.cu Mode of each join type
MODES = {"inner": 0, "outer": 1, "semi": 2, "anti": 3}
KEY_TYPES = (T.IntegerType, T.LongType, T.DateType)
#: key columns one join takes (csrc/keys.cuh kMaxKeys)
MAX_KEYS = 8

_SIGNATURES = {
    "srt_join_build": "ipppqppqp",
    "srt_join_count": "ipppqpppqppqipp",
    "srt_join_write": "ipppqpppqppqipppp",
}

Keys = Union[DeviceColumn, Sequence[DeviceColumn]]


def load_library():
    """Builds (first call) and binds ``csrc/hash_join.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("join.hash", "csrc/hash_join.cu",
                        lambda: load_cuda("hash_join.cu", _SIGNATURES))


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
                "(int, date and long keys are)")
        if c.device != probe[0].device:
            raise ValueError("build and probe keys lie on different "
                             "devices")
    for side in (build, probe):
        if any(c.row_count != side[0].row_count for c in side):
            raise ValueError("key columns of one side differ in length")


def _mode(outer: bool, mode: Optional[str]) -> str:
    if mode is None:
        return "outer" if outer else "inner"
    if mode not in ("semi", "anti") or outer:
        raise ValueError(f"join mode {mode!r} with outer={outer}")
    return mode


def join_pairs(build: Keys, probe: Keys, transfers, outer: bool = False,
               mode: Optional[str] = None
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """K10's wrapper: ``(probe_rows, build_rows)``, int64, one entry per
    matching pair (and with ``outer``, one ``(row, -1)`` per probe row
    with no match); with ``mode`` ``"semi"`` or ``"anti"``, ``(kept probe
    rows, None)``."""
    build, probe = key_list(build), key_list(probe)
    _check(build, probe)
    kind = _mode(outer, mode)
    device = probe[0].device
    if device.type == "cpu":
        return join_pairs_plain(build, probe, transfers, outer, mode)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    nb, n = build[0].row_count, probe[0].row_count
    size = table_size(nb)
    tiles = -(-n // SCAN_TILE)

    def keys(cols):
        """(key types, data, validity) of one side, each held by name
        until the launches are queued."""
        data = [c.data.contiguous() for c in cols]
        valid = [None if c.all_valid else
                 c.validity.contiguous().view(torch.uint8) for c in cols]
        types = int32s([int(d.dtype == torch.int64) for d in data])
        return types, data, valid

    btypes, bdata, bvalid = keys(build)
    ptypes, pdata, pvalid = keys(probe)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        slots = torch.empty(size, dtype=torch.int64, device=device)
        slot_tag = torch.empty(size, dtype=torch.int64, device=device)
        tile_offsets = torch.empty(tiles + 1, dtype=torch.int64,
                                   device=device)
        table = (slots.data_ptr(), slot_tag.data_ptr(), size)
        bargs = (btypes, pointers(bdata), pointers(bvalid), nb)
        check_launch(lib.srt_join_build(len(build), *bargs, *table, stream),
                     "K10 build")
        probe_args = (len(build), *bargs, ptypes, pointers(pdata),
                      pointers(pvalid), n, *table, MODES[kind])
        check_launch(lib.srt_join_count(*probe_args, tile_offsets.data_ptr(),
                                        stream), "K10 count")
        total, = transfers.read_counts([tile_offsets[tiles]])
        out_probe = torch.empty(total, dtype=torch.int64, device=device)
        out_build = None if mode else \
            torch.empty(total, dtype=torch.int64, device=device)
        if total:
            check_launch(lib.srt_join_write(
                *probe_args, tile_offsets.data_ptr(), out_probe.data_ptr(),
                None if out_build is None else out_build.data_ptr(),
                stream), "K10 write")
    global LAUNCHES
    LAUNCHES += 1
    return out_probe, out_build


def _key_ids(build: List[DeviceColumn], probe: List[DeviceColumn]):
    """One int64 key per row of each side and whether every key column of
    the row is present: the column itself for one key, else the index of
    the row's key tuple among the distinct tuples of both sides (an int
    key widened to long, so it equals a long of the same value)."""
    def valid(cols):
        v = cols[0].validity
        for c in cols[1:]:
            v = v & c.validity
        return v

    if len(build) == 1:
        return (build[0].data.to(torch.int64), valid(build),
                probe[0].data.to(torch.int64), valid(probe))
    words = torch.cat([torch.stack([c.data.to(torch.int64) for c in cols], 1)
                       for cols in (build, probe)])
    _u, ids = torch.unique(words, dim=0, return_inverse=True)
    nb = build[0].row_count
    return ids[:nb], valid(build), ids[nb:], valid(probe)


def join_pairs_plain(build: Keys, probe: Keys, transfers,
                     outer: bool = False, mode: Optional[str] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The plain PyTorch version of K10: the build side's present keys
    sorted stably, each probe key's range of equals found by binary
    search, the ranges expanded into pairs (an empty range into one pair
    with build row -1 when ``outer``); in semi and anti modes the probe
    rows whose range is not empty, or is."""
    build, probe = key_list(build), key_list(probe)
    _check(build, probe)
    _mode(outer, mode)
    device = probe[0].device
    bk, bvalid, pk, pvalid = _key_ids(build, probe)
    rows = torch.nonzero(bvalid).flatten()
    keys, order = torch.sort(bk[rows], stable=True)
    rows = rows[order]
    lo = torch.searchsorted(keys, pk, right=False)
    hi = torch.searchsorted(keys, pk, right=True)
    count = torch.where(pvalid, hi - lo, 0)
    if mode:
        keep = (count > 0) if mode == "semi" else (count == 0)
        transfers.read_counts([keep.sum()])
        return torch.nonzero(keep).flatten(), None
    emit = count.clamp(min=1) if outer else count
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
