"""Equi-join pairs through a hash table: kernel K10 (the analog of
``spark_rapids_tpu/ops/join_ops.py``: ``build_side`` ``:125``,
``_probe_ranges`` ``:157``, ``_expand_verify`` ``:191`` and
``compact_pairs`` ``:290``, kinds ``join.build``, ``join.probe``,
``join.pair`` and ``join.compact_pairs``).

``join_pairs`` is the kernel's wrapper: given the build side's and the
probe side's key column (one int or long key each), it returns the
matching (probe row, build row) pairs of an inner join, in probe-row order
and, within a probe row, in build-row order.  Null keys never match.
With ``outer=True`` (a left outer join, the probe side preserved) a probe
row with no match, a null key included, gives one pair (row, -1) in its
place: the JAX package's three finishing programs ``matched_flags``
(``:275``), ``unmatched_positions`` (``:313``) and
``concat_matched_unmatched`` (``:418``, kinds ``join.matched_flags``,
``join.unmatched``, ``join.concat_maps``) become one mode of the count
and write passes, which count ``max(1, matches)`` per probe row.  The
JAX package puts the matched pairs first and the unmatched rows after
them; here each unmatched row stays at its probe row's place.  On
CUDA columns it launches ``csrc/hash_join.cu`` (build, count, then write
after one sync that sizes the output exactly: the JAX package's
speculative sizing, ``ops/speculation.py``, is not carried over); on CPU
columns ``join_pairs_plain`` computes the same pairs with a stable sort
and binary search, and reads the pair count through the gateway just as
the kernel does.  String and multi-column keys are still to port
(ROADMAP queue 2, K10)."""

from __future__ import annotations

from typing import Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K10 (wrapper calls that launch it)
LAUNCHES = 0

#: probe rows one tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024
KEY_TYPES = (T.IntegerType, T.LongType)

_SIGNATURES = {
    "srt_join_build": "pipqppqp",
    "srt_join_count": "pipqppqipp",
    "srt_join_write": "pipqppqipppp",
}


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


def _check(build: DeviceColumn, probe: DeviceColumn) -> None:
    for c in (build, probe):
        if not isinstance(c.data_type, KEY_TYPES):
            raise NotImplementedError(
                f"a join key of {c.data_type} is not in the port yet "
                "(int and long keys are)")
    if build.device != probe.device:
        raise ValueError("build and probe keys lie on different devices")


def join_pairs(build: DeviceColumn, probe: DeviceColumn, transfers,
               outer: bool = False) -> Tuple[torch.Tensor, torch.Tensor]:
    """K10's wrapper: ``(probe_rows, build_rows)``, int64, one entry per
    matching pair (and with ``outer``, one ``(row, -1)`` per probe row
    with no match)."""
    _check(build, probe)
    device = probe.device
    if device.type == "cpu":
        return join_pairs_plain(build, probe, transfers, outer)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_library()
    size = table_size(build.row_count)
    n = probe.row_count
    tiles = -(-n // SCAN_TILE)
    bkeys, pkeys = build.data.contiguous(), probe.data.contiguous()
    bvalid = None if build.all_valid else \
        build.validity.contiguous().view(torch.uint8)
    pvalid = None if probe.all_valid else \
        probe.validity.contiguous().view(torch.uint8)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        slots = torch.empty(size, dtype=torch.int64, device=device)
        slot_keys = torch.empty(size, dtype=torch.int64, device=device)
        tile_offsets = torch.empty(tiles + 1, dtype=torch.int64,
                                   device=device)
        table = (slots.data_ptr(), slot_keys.data_ptr(), size)
        check_launch(lib.srt_join_build(
            bkeys.data_ptr(), int(bkeys.dtype == torch.int64), ptr(bvalid),
            build.row_count, *table, stream), "K10 build")
        probe_args = (pkeys.data_ptr(), int(pkeys.dtype == torch.int64),
                      ptr(pvalid), n) + table + (int(outer),)
        check_launch(lib.srt_join_count(*probe_args, tile_offsets.data_ptr(),
                                        stream), "K10 count")
        total, = transfers.read_counts([tile_offsets[tiles]])
        out_probe = torch.empty(total, dtype=torch.int64, device=device)
        out_build = torch.empty(total, dtype=torch.int64, device=device)
        if total:
            check_launch(lib.srt_join_write(
                *probe_args, tile_offsets.data_ptr(), out_probe.data_ptr(),
                out_build.data_ptr(), stream), "K10 write")
    global LAUNCHES
    LAUNCHES += 1
    return out_probe, out_build


def join_pairs_plain(build: DeviceColumn, probe: DeviceColumn, transfers,
                     outer: bool = False
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of K10: the build side's present keys
    sorted stably, each probe key's range of equals found by binary
    search, the ranges expanded into pairs (an empty range into one pair
    with build row -1 when ``outer``)."""
    _check(build, probe)
    device = probe.device
    rows = torch.nonzero(build.validity).flatten()
    keys, order = torch.sort(build.data[rows].to(torch.int64), stable=True)
    rows = rows[order]
    pk = probe.data.to(torch.int64)
    lo = torch.searchsorted(keys, pk, right=False)
    hi = torch.searchsorted(keys, pk, right=True)
    count = torch.where(probe.validity, hi - lo, 0)
    emit = count.clamp(min=1) if outer else count
    total, = transfers.read_counts([emit.sum()])
    n = probe.row_count
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
