"""Windows: kernel K14 (the analog of ``spark_rapids_tpu/ops/
window_ops.py``: ``compute_windows`` ``:79``, kind ``window.frame``, built
``:157``, with ``_one_func`` ``:173`` in its whole-partition ``agg`` kind
and its ranking kinds ``row_number``, ``rank`` and ``dense_rank``
``:177-186``).

``compute_windows`` sorts the rows by the partition keys with K8
(ascending, nulls first, stable: the JAX program's ``SortOrder(i, True,
True)``), then by the order keys in their own direction and null order
(``:99-115``), gathers the payload, the keys and the function inputs
through the permutation with K7, and calls ``window_reduce``, K14's
wrapper, on the sorted keys and inputs, or ``window_rank``, its ranking
pass, on the sorted partition and order keys.  With no key the rows keep
their order (one partition) and nothing is sorted or gathered.

``window_reduce`` finds partition starts from adjacent rows' keys (a null
equals a null and its data is not read, as ``_masked_group_words``
``ops/agg_ops.py:38`` masks it; doubles by their normalised bits; strings
byte by byte) and reduces each partition into each row: a long sum
(wrapping), a double sum (IEEE's NaN and infinities as a direct sum gives
them), a count of present values or of rows, or a mean (the double sum
over the count).  A sum or mean of a partition with no present value is
null.  On CUDA tensors it launches ``csrc/window.cu`` (a segment scan,
then per function a tile-parallel segmented reduction, a combine of the
pieces of partitions that span tiles, and a write; no atomics); on CPU
tensors ``window_reduce_plain`` (cumsum segment ids, ``index_add_``, a
gather).  Neither reads a count back to the host: no sync.

``window_rank`` finds partition starts over the partition keys and peer
starts over the partition and order keys (the same adjacent-row
equality), and writes each row's ``row_number = i - pstart + 1``, ``rank
= peerstart - pstart + 1`` and ``dense_rank`` (the peer groups of the
partition up to the row's), as int32 with no null.  On CUDA tensors it
launches ``csrc/window.cu srt_window_rank``; on CPU tensors
``window_rank_plain`` (cumulative maxima of the start positions and a
cumulative sum of the peer starts).  No sync."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import batch_ops, sort_ops
from spark_rapids_tpu_torch.ops.agg_ops import KEY_CODES, key_words_plain

#: K14 function kinds (csrc/window.cu WinKind), then the ranking kinds
#: of its ranking pass (csrc/window.cu srt_window_rank's outputs)
WIN_SUM_I64, WIN_SUM_F64, WIN_COUNT, WIN_COUNT_ALL, WIN_MEAN = range(5)
WIN_ROW_NUMBER, WIN_RANK, WIN_DENSE_RANK = range(5, 8)
RANKING = (WIN_ROW_NUMBER, WIN_RANK, WIN_DENSE_RANK)
#: launches of K14's reduction and of its ranking pass (wrapper calls
#: that launch them)
LAUNCHES = 0
RANK_LAUNCHES = 0
#: rows of one tile of the reduction pass (csrc/window.cu kTile)
TILE = 1024
#: values one scan tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024
MAX_KEYS = 8
WINDOW_KEY_TYPES = tuple(KEY_CODES)

_SIGNATURES = {
    "srt_window_segments": "ipppppqppp",
    "srt_window_agg": "ippq" + "p" * 12,
    "srt_window_rank": "iippppp" + "q" + "p" * 9,
}


def result_type(kind: int) -> T.DataType:
    if kind in RANKING:
        return T.INT
    return T.DOUBLE if kind in (WIN_SUM_F64, WIN_MEAN) else T.LONG


def load_library():
    """Builds (first call) and binds ``csrc/window.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("window.frame", "csrc/window.cu",
                        lambda: load_cuda("window.cu", _SIGNATURES))


def _check(keys: Sequence[DeviceColumn], values, kinds, n: int,
           device) -> None:
    if len(keys) > MAX_KEYS:
        raise NotImplementedError(f"K14 takes at most {MAX_KEYS} keys")
    if len(values) != len(kinds):
        raise ValueError("one input per function")
    for k in keys:
        if k.data_type not in KEY_CODES:
            raise NotImplementedError(
                f"a window partition key of {k.data_type} is not in the "
                "port yet (int, date, long, double and string keys are)")
        if k.row_count != n or k.device != device:
            raise ValueError("a key column of another length or device")
    want = {WIN_SUM_I64: T.LONG, WIN_SUM_F64: T.DOUBLE, WIN_MEAN: T.DOUBLE}
    for c, kind in zip(values, kinds):
        if kind not in range(5):
            raise ValueError(f"unknown window function kind {kind}")
        if kind == WIN_COUNT_ALL:
            continue
        if c is None or c.row_count != n or c.device != device:
            raise ValueError("a function input of the keys' rows and "
                             "device is needed")
        if kind in want and c.data_type != want[kind]:
            raise TypeError(f"window kind {kind} takes a {want[kind]} "
                            f"input, got {c.data_type}")


def window_reduce(keys: Sequence[DeviceColumn], values, kinds, n: int,
                  device: torch.device) -> List[DeviceColumn]:
    """K14's wrapper: for ``n`` rows on ``device`` whose partitions lie
    together (sorted by ``keys``), each function's result for each row's
    partition.  ``values[j]`` is function ``j``'s input (None for a count
    of rows)."""
    _check(keys, values, kinds, n, device)
    if device.type == "cpu":
        return window_reduce_plain(keys, values, kinds, n, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    outs = [DeviceColumn(torch.empty(n, dtype=result_type(k).torch_dtype,
                                     device=device),
                         torch.empty(n, dtype=torch.bool, device=device),
                         result_type(k)) for k in kinds]
    if n == 0 or not kinds:
        return outs
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    tiles = -(-n // TILE)

    def empty(count, dtype=torch.int64):
        return torch.empty(count, dtype=dtype, device=device)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # scratch is held by name until the launches are queued: a tensor
        # freed at once would let the next one reuse its memory
        kdata = [k.data.contiguous() for k in keys]
        kvalid = [None if k.all_valid else
                  k.validity.contiguous().view(torch.uint8) for k in keys]
        rank, scan_tiles = empty(n + 1), empty(-(-n // SCAN_TILE))
        check_launch(lib.srt_window_segments(
            len(keys), int32s([KEY_CODES[k.data_type] for k in keys]),
            int32s([int(k.is_string and k.offsets.dtype == torch.int64)
                    for k in keys]),
            pointers(kdata), pointers(kvalid),
            pointers([k.offsets for k in keys]), n, rank.data_ptr(),
            scan_tiles.data_ptr(), stream), "K14 segments")
        seg_sum, seg_cnt = empty(n), empty(n)
        head_sum, head_cnt, tail_sum, tail_cnt = (empty(tiles)
                                                  for _ in range(4))
        flags = empty(2 * tiles, torch.uint8)
        for c, kind, out in zip(values, kinds, outs):
            data = None if c is None or kind in (WIN_COUNT, WIN_COUNT_ALL) \
                else c.data.contiguous()
            valid = None if c is None or c.all_valid or \
                kind == WIN_COUNT_ALL else \
                c.validity.contiguous().view(torch.uint8)
            check_launch(lib.srt_window_agg(
                kind, None if data is None else data.data_ptr(),
                None if valid is None else valid.data_ptr(), n,
                rank.data_ptr(), out.data.data_ptr(),
                out.validity.view(torch.uint8).data_ptr(),
                seg_sum.data_ptr(), seg_cnt.data_ptr(), head_sum.data_ptr(),
                head_cnt.data_ptr(), tail_sum.data_ptr(),
                tail_cnt.data_ptr(), flags.data_ptr(),
                flags[tiles:].data_ptr(), stream), "K14 reduce")
    global LAUNCHES
    LAUNCHES += 1
    return outs


def partition_starts_plain(keys: Sequence[DeviceColumn], n: int,
                           device) -> torch.Tensor:
    """Rows whose keys differ from the row before's (row 0 always)."""
    from spark_rapids_tpu_torch.expressions.base import Col
    from spark_rapids_tpu_torch.expressions.predicates import string_equal
    same = torch.ones(max(n - 1, 0), dtype=torch.bool, device=device)
    for c in keys:
        va, vb = c.validity[:-1], c.validity[1:]
        if c.is_string:
            off = c.offsets
            eq = string_equal(Col(c.data, va, off[:-1]),
                              Col(c.data, vb, off[1:])) if n > 1 else \
                same
        else:
            w = key_words_plain(c)
            eq = w[:-1] == w[1:]
        same = same & (va == vb) & (~va | eq)
    starts = torch.ones(n, dtype=torch.bool, device=device)
    starts[1:] = ~same
    return starts


def window_reduce_plain(keys: Sequence[DeviceColumn], values, kinds,
                        n: int, device: torch.device) -> List[DeviceColumn]:
    """The plain PyTorch version of K14: segment ids from a cumsum of the
    partition starts, ``index_add_`` per segment, a gather back to the
    rows."""
    _check(keys, values, kinds, n, device)
    gid = torch.cumsum(partition_starts_plain(keys, n, device)
                       .to(torch.int64), 0) - 1
    outs = []
    for c, kind in zip(values, kinds):
        present = torch.ones(n, dtype=torch.bool, device=device) \
            if kind == WIN_COUNT_ALL else c.validity
        cnt = torch.zeros(n, dtype=torch.int64, device=device).index_add_(
            0, gid, present.to(torch.int64))[gid]
        if kind in (WIN_COUNT, WIN_COUNT_ALL):
            outs.append(DeviceColumn(cnt, torch.ones_like(present),
                                     T.LONG))
            continue
        dt = torch.int64 if kind == WIN_SUM_I64 else torch.float64
        vals = torch.where(present, c.data, torch.zeros((), dtype=dt,
                                                        device=device))
        s = torch.zeros(n, dtype=dt, device=device).index_add_(
            0, gid, vals)[gid]
        if kind == WIN_MEAN:
            s = torch.where(cnt > 0, s / torch.clamp(cnt, min=1), 0.0)
        outs.append(DeviceColumn(s, cnt > 0, result_type(kind)))
    return outs


def _check_rank(keys: Sequence[DeviceColumn],
                order_keys: Sequence[DeviceColumn], kinds, n: int,
                device) -> None:
    if len(keys) + len(order_keys) > MAX_KEYS:
        raise NotImplementedError(
            f"K14 takes at most {MAX_KEYS} partition and order keys")
    for k in (*keys, *order_keys):
        if k.data_type not in KEY_CODES:
            raise NotImplementedError(
                f"a window key of {k.data_type} is not in the port yet "
                "(int, date, long, double and string keys are)")
        if k.row_count != n or k.device != device:
            raise ValueError("a key column of another length or device")
    for kind in kinds:
        if kind not in RANKING:
            raise ValueError(f"not a ranking kind: {kind}")


def window_rank(keys: Sequence[DeviceColumn],
                order_keys: Sequence[DeviceColumn], kinds, n: int,
                device: torch.device) -> List[DeviceColumn]:
    """K14's ranking pass: for ``n`` rows on ``device`` sorted by the
    partition ``keys`` and then the ``order_keys``, each ranking
    function's int32 result."""
    _check_rank(keys, order_keys, kinds, n, device)
    if device.type == "cpu":
        return window_rank_plain(keys, order_keys, kinds, n, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    outs = [DeviceColumn(torch.empty(n, dtype=torch.int32, device=device),
                         torch.ones(n, dtype=torch.bool, device=device),
                         T.INT, True) for _k in kinds]
    if n == 0 or not kinds:
        return outs
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    every = list(keys) + list(order_keys)
    by_kind = {k: o.data for k, o in zip(kinds, outs)}

    def empty(count):
        return torch.empty(count, dtype=torch.int64, device=device)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # scratch is held by name until the launch is queued: a tensor
        # freed at once would let the next one reuse its memory
        kdata = [k.data.contiguous() for k in every]
        kvalid = [None if k.all_valid else
                  k.validity.contiguous().view(torch.uint8) for k in every]
        part_rank, peer_rank = empty(n + 1), empty(n + 1)
        part_first, peer_first = empty(n), empty(n)
        scan_tiles = empty(-(-n // SCAN_TILE))
        check_launch(lib.srt_window_rank(
            len(keys), len(every),
            int32s([KEY_CODES[k.data_type] for k in every]),
            int32s([int(k.is_string and k.offsets.dtype == torch.int64)
                    for k in every]),
            pointers(kdata), pointers(kvalid),
            pointers([k.offsets for k in every]), n, part_rank.data_ptr(),
            peer_rank.data_ptr(), scan_tiles.data_ptr(),
            part_first.data_ptr(), peer_first.data_ptr(),
            *[by_kind[k].data_ptr() if k in by_kind else None
              for k in RANKING], stream), "K14 rank")
    global RANK_LAUNCHES
    RANK_LAUNCHES += 1
    return outs


def window_rank_plain(keys: Sequence[DeviceColumn],
                      order_keys: Sequence[DeviceColumn], kinds, n: int,
                      device: torch.device) -> List[DeviceColumn]:
    """The plain PyTorch version of K14's ranking pass: each row's
    partition and peer group start as cumulative maxima of the start
    positions, dense_rank from a cumulative sum of peer starts."""
    _check_rank(keys, order_keys, kinds, n, device)
    pos = torch.arange(n, dtype=torch.int64, device=device)
    values = {k: pos for k in RANKING}
    if n:
        part = partition_starts_plain(keys, n, device)
        peer = partition_starts_plain(list(keys) + list(order_keys), n,
                                      device)
        zero = torch.zeros_like(pos)
        pfirst = torch.cummax(torch.where(part, pos, zero), 0)[0]
        qfirst = torch.cummax(torch.where(peer, pos, zero), 0)[0]
        peers = torch.cumsum(peer.to(torch.int64), 0)
        values = {WIN_ROW_NUMBER: pos - pfirst + 1,
                  WIN_RANK: qfirst - pfirst + 1,
                  WIN_DENSE_RANK: peers - peers[pfirst] + 1}
    return [DeviceColumn(values[k].to(torch.int32),
                         torch.ones(n, dtype=torch.bool, device=device),
                         T.INT, True) for k in kinds]


def compute_windows(payload: Sequence[DeviceColumn],
                    keys: Sequence[DeviceColumn],
                    values: Sequence[Optional[DeviceColumn]], kinds,
                    n: int, device: torch.device, transfers,
                    order_keys: Sequence[DeviceColumn] = (),
                    orders: Sequence[Tuple[bool, bool]] = ()
                    ) -> Tuple[List[DeviceColumn], List[DeviceColumn]]:
    """``(payload sorted by the keys, one column per function)`` of ``n``
    rows on ``device``: K8 and K7 when there are keys, then K14's
    reduction, or its ranking pass when ``kinds`` are ranking kinds (over
    ``order_keys``, each with the ``(ascending, nulls_first)`` of
    ``orders``)."""
    every = list(keys) + list(order_keys)
    if every and n > 1:
        perm = sort_ops.sort_permutation(
            every, [sort_ops.SortOrder(i, True, True)
                    for i in range(len(keys))] +
            [sort_ops.SortOrder(len(keys) + j, a, nf)
             for j, (a, nf) in enumerate(orders)], transfers)
        # each distinct column is gathered once
        cols, slot = [], {}
        for c in list(payload) + every + list(values):
            if c is not None and id(c) not in slot:
                slot[id(c)] = len(cols)
                cols.append(c)
        moved = batch_ops.gather_columns(cols, perm, transfers, unique=True)

        def sorted_(c):
            return None if c is None else moved[slot[id(c)]]
        payload = [sorted_(c) for c in payload]
        keys = [sorted_(c) for c in keys]
        order_keys = [sorted_(c) for c in order_keys]
        values = [sorted_(c) for c in values]
    if kinds and all(k in RANKING for k in kinds):
        return list(payload), window_rank(keys, order_keys, kinds, n,
                                          device)
    if order_keys:
        raise NotImplementedError(
            "a window aggregate with ORDER BY (a running frame) is not in "
            "the port yet")
    return list(payload), window_reduce(keys, values, kinds, n, device)
