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

import dataclasses
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


# -- frames: K14s (running), K14b (bounded ROWS), K14o (offset, ntile) --

#: the min and max kinds of a frame (csrc/window.cu FrameKind kMin, kMax)
WIN_MIN, WIN_MAX = 8, 9
_C_KIND = {WIN_SUM_I64: 0, WIN_SUM_F64: 1, WIN_COUNT: 2, WIN_COUNT_ALL: 3,
           WIN_MEAN: 4, WIN_MIN: 5, WIN_MAX: 6}
#: csrc/window.cu ValueType of a min or max input
_VTYPE = {T.INT: 0, T.DATE: 0, T.LONG: 1, T.DOUBLE: 2}
MINMAX_TYPES = tuple(_VTYPE)
#: csrc/window.cu Take
TAKE_ROWS, TAKE_PEERS, TAKE_PARTITION = range(3)
#: bytes of one running state in K14s's scratch (csrc/window.cu
#: kStateBytes)
STATE_BYTES = 32
#: launches of K14s, K14b and K14o (wrapper calls that launch them;
#: K14o's offset, fill and ntile wrappers all count in OFFSET_LAUNCHES)
FRAME_LAUNCHES = 0
BOUNDED_LAUNCHES = 0
OFFSET_LAUNCHES = 0

_FRAME_SIGNATURES = {
    "srt_window_bounds": "iipppppqpppppp",
    "srt_window_running": "iippqppppiiqppppppp",
    "srt_window_bounded": "iippqppqqppp",
    "srt_window_offset": "qppqpp",
    "srt_window_ntile": "qppqpp",
    "srt_window_fill": "pqppiqp",
}


@dataclasses.dataclass(frozen=True)
class FrameAgg:
    """An aggregate over a frame: ``kind`` (a sum, count, mean, min or max
    kind) over ``frame`` ("rows" or "range") from ``lo`` to ``hi`` (row
    offsets; None is UNBOUNDED PRECEDING for ``lo``, UNBOUNDED FOLLOWING
    for ``hi``).  A RANGE frame is Spark's default, ``lo`` None and ``hi``
    0 (the row's last peer) or None."""
    kind: int
    frame: str = "rows"
    lo: Optional[int] = None
    hi: Optional[int] = 0

    @property
    def bounded(self) -> bool:
        return self.frame == "rows" and self.lo is not None and \
            self.hi is not None

    def running_form(self) -> Tuple[int, int, int]:
        """``(reverse, take, offset)`` of K14s for an unbounded frame."""
        if self.lo is None and self.hi is None:
            return 0, TAKE_PARTITION, 0
        if self.frame == "range":
            return 0, TAKE_PEERS, 0
        if self.lo is None:
            return 0, TAKE_ROWS, self.hi
        return 1, TAKE_ROWS, self.lo


@dataclasses.dataclass(frozen=True)
class NTileFn:
    """``ntile(n)``."""
    n: int


@dataclasses.dataclass(frozen=True)
class OffsetFn:
    """lag (a negative ``offset``) or lead (a positive one), with a scalar
    ``default`` for the rows whose source lies outside the partition."""
    offset: int
    default: object = None


def frame_result_type(func, value_type: Optional[T.DataType]
                      ) -> T.DataType:
    """The result type of a frame function over a ``value_type`` input."""
    if isinstance(func, NTileFn):
        return T.INT
    if isinstance(func, OffsetFn) or func.kind in (WIN_MIN, WIN_MAX):
        return value_type
    return result_type(func.kind)


def load_frame_library():
    """Builds (first call) and binds the frame kinds of ``csrc/
    window.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("window.frame.kinds", "csrc/window.cu",
                        lambda: load_cuda("window.cu", _FRAME_SIGNATURES))


def _check_frame_funcs(funcs, values, n, device) -> None:
    if len(values) != len(funcs):
        raise ValueError("one input per function")
    want = {WIN_SUM_I64: T.LONG, WIN_SUM_F64: T.DOUBLE, WIN_MEAN: T.DOUBLE}
    for f, c in zip(funcs, values):
        if f.kind not in _C_KIND:
            raise ValueError(f"unknown frame function kind {f.kind}")
        if f.frame not in ("rows", "range"):
            raise ValueError(f"unknown frame {f.frame}")
        if f.frame == "range" and not (f.lo is None and f.hi in (None, 0)):
            raise NotImplementedError(
                "bounded RANGE frames are not in the port (ROWS frames are)")
        if f.bounded and f.lo > f.hi:
            raise ValueError(f"an empty frame {f.lo}..{f.hi}")
        if f.kind in (WIN_MIN, WIN_MAX) and not f.bounded and \
                not (f.lo is None and f.hi in (None, 0)) and \
                not (f.lo == 0 and f.hi is None):
            raise NotImplementedError(
                f"min/max over the frame {f.frame} {f.lo} {f.hi} (the JAX "
                "program's _one_func refuses it too)")
        if f.kind == WIN_COUNT_ALL:
            continue
        if c is None or c.row_count != n or c.device != device:
            raise ValueError("a function input of the keys' rows and "
                             "device is needed")
        if f.kind in want and c.data_type != want[f.kind]:
            raise TypeError(f"frame kind {f.kind} takes a {want[f.kind]} "
                            f"input, got {c.data_type}")
        if f.kind in (WIN_MIN, WIN_MAX) and c.data_type not in _VTYPE:
            raise NotImplementedError(
                f"min/max of {c.data_type} over a window frame is not in "
                "the port (int, date, long and double are)")


def _frame_outputs(funcs, values, n, device) -> List[DeviceColumn]:
    outs = []
    for f, c in zip(funcs, values):
        rt = frame_result_type(f, None if c is None else c.data_type)
        outs.append(DeviceColumn(
            torch.empty(n, dtype=rt.torch_dtype, device=device),
            torch.empty(n, dtype=torch.bool, device=device), rt))
    return outs


class _CardBounds:
    """The ranks and first positions of ``srt_window_bounds`` (peers too
    when ``peers``), held until the launches that read them are queued."""

    def __init__(self, lib, keys, order_keys, n: int, device, peers: bool):
        from spark_rapids_tpu_torch.kernels.build import (check_launch,
                                                          int32s, pointers)
        every = list(keys) + list(order_keys)

        def empty(count):
            return torch.empty(count, dtype=torch.int64, device=device)
        self.kdata = [k.data.contiguous() for k in every]
        self.kvalid = [None if k.all_valid else
                       k.validity.contiguous().view(torch.uint8)
                       for k in every]
        self.part_rank, self.part_first = empty(n + 1), empty(max(n, 1))
        self.peer_rank = empty(n + 1) if peers else None
        self.peer_first = empty(max(n, 1)) if peers else None
        scratch = empty(max(-(-n // SCAN_TILE), 1))
        stream = torch.cuda.current_stream(device).cuda_stream
        check_launch(lib.srt_window_bounds(
            len(keys), len(every) if peers else len(keys),
            int32s([KEY_CODES[k.data_type] for k in every]),
            int32s([int(k.is_string and k.offsets.dtype == torch.int64)
                    for k in every]),
            pointers(self.kdata), pointers(self.kvalid),
            pointers([k.offsets for k in every]), n,
            self.part_rank.data_ptr(),
            None if self.peer_rank is None else self.peer_rank.data_ptr(),
            scratch.data_ptr(), self.part_first.data_ptr(),
            None if self.peer_first is None else self.peer_first.data_ptr(),
            stream), "K14 bounds")
        self.scratch = scratch

    def part(self):
        return self.part_rank.data_ptr(), self.part_first.data_ptr()

    def peer(self):
        if self.peer_rank is None:
            return None, None
        return self.peer_rank.data_ptr(), self.peer_first.data_ptr()


def _value_args(f, c):
    """(value type code, data, validity) of a frame function's input, held
    by the caller until its launch is queued."""
    if f.kind == WIN_COUNT_ALL or c is None:
        return 0, None, None
    vtype = _VTYPE.get(c.data_type, 0)
    data = None if f.kind == WIN_COUNT else c.data.contiguous()
    valid = None if c.all_valid else c.validity.contiguous().view(
        torch.uint8)
    return vtype, data, valid


def window_running(keys: Sequence[DeviceColumn],
                   order_keys: Sequence[DeviceColumn], funcs,
                   values: Sequence[Optional[DeviceColumn]], n: int,
                   device: torch.device) -> List[DeviceColumn]:
    """K14s's wrapper: for ``n`` rows on ``device`` sorted by the partition
    ``keys`` and then the ``order_keys``, each ``FrameAgg`` of an
    unbounded frame (running, the default RANGE frame, the whole
    partition, or one ending at UNBOUNDED FOLLOWING) over its input."""
    _check_rank(keys, order_keys, (), n, device)
    _check_frame_funcs(funcs, values, n, device)
    if any(f.bounded for f in funcs):
        raise ValueError("a bounded ROWS frame is K14b's (window_bounded)")
    if device.type == "cpu":
        return window_running_plain(keys, order_keys, funcs, values, n,
                                    device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    outs = _frame_outputs(funcs, values, n, device)
    if n == 0 or not funcs:
        return outs
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_frame_library()
    tiles = -(-n // TILE)
    peers = any(f.running_form()[1] == TAKE_PEERS for f in funcs)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        b = _CardBounds(lib, keys, order_keys, n, device, peers)
        run = torch.empty(n * STATE_BYTES, dtype=torch.uint8, device=device)
        run_start = torch.empty(n, dtype=torch.uint8, device=device)
        tile_piece = torch.empty(tiles * STATE_BYTES, dtype=torch.uint8,
                                 device=device)
        carry = torch.empty(tiles * STATE_BYTES, dtype=torch.uint8,
                            device=device)
        for f, c, out in zip(funcs, values, outs):
            vtype, data, valid = _value_args(f, c)
            rev, take, off = f.running_form()
            check_launch(lib.srt_window_running(
                _C_KIND[f.kind], vtype,
                None if data is None else data.data_ptr(),
                None if valid is None else valid.data_ptr(), n, *b.part(),
                *b.peer(), rev, take, off, out.data.data_ptr(),
                out.validity.view(torch.uint8).data_ptr(), run.data_ptr(),
                run_start.data_ptr(), tile_piece.data_ptr(),
                carry.data_ptr(), stream), "K14s running frame")
    global FRAME_LAUNCHES
    FRAME_LAUNCHES += 1
    return outs


def window_bounded(keys: Sequence[DeviceColumn], funcs,
                   values: Sequence[Optional[DeviceColumn]], n: int,
                   device: torch.device) -> List[DeviceColumn]:
    """K14b's wrapper: each ``FrameAgg`` of a ROWS frame with two finite
    bounds, over ``n`` rows sorted by the partition ``keys`` (and their
    order keys)."""
    _check_rank(keys, (), (), n, device)
    _check_frame_funcs(funcs, values, n, device)
    if not all(f.bounded for f in funcs):
        raise ValueError("K14b takes ROWS frames with two finite bounds")
    if device.type == "cpu":
        return window_bounded_plain(keys, funcs, values, n, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    outs = _frame_outputs(funcs, values, n, device)
    if n == 0 or not funcs:
        return outs
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_frame_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        b = _CardBounds(lib, keys, (), n, device, False)
        for f, c, out in zip(funcs, values, outs):
            vtype, data, valid = _value_args(f, c)
            check_launch(lib.srt_window_bounded(
                _C_KIND[f.kind], vtype,
                None if data is None else data.data_ptr(),
                None if valid is None else valid.data_ptr(), n, *b.part(),
                f.lo, f.hi, out.data.data_ptr(),
                out.validity.view(torch.uint8).data_ptr(), stream),
                "K14b bounded frame")
    global BOUNDED_LAUNCHES
    BOUNDED_LAUNCHES += 1
    return outs


def window_offset(keys: Sequence[DeviceColumn], offsets: Sequence[int],
                  n: int, device: torch.device) -> List[torch.Tensor]:
    """K14o's lag/lead: for each offset, each row's source row ``i +
    offset`` where it lies in the row's partition, else -1 (int64)."""
    _check_rank(keys, (), (), n, device)
    if device.type == "cpu":
        return window_offset_plain(keys, offsets, n, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    maps = [torch.empty(n, dtype=torch.int64, device=device)
            for _o in offsets]
    if n == 0 or not offsets:
        return maps
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_frame_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        b = _CardBounds(lib, keys, (), n, device, False)
        for off, m in zip(offsets, maps):
            check_launch(lib.srt_window_offset(n, *b.part(), int(off),
                                               m.data_ptr(), stream),
                         "K14o offset")
    global OFFSET_LAUNCHES
    OFFSET_LAUNCHES += 1
    return maps


def _check_fill(column: DeviceColumn, source: torch.Tensor) -> None:
    if column.is_string or column.data_type not in _VTYPE:
        raise NotImplementedError(
            f"a lag/lead default over {column.data_type} is not in the port "
            "(int, date, long and double are; the JAX program refuses a "
            "string one)")
    if source.shape[0] != column.row_count or \
            source.device != column.device:
        raise ValueError("a source map of the column's rows and device")


def _default_bits(value, dtype: T.DataType) -> int:
    import struct
    if dtype.is_floating:
        return struct.unpack("<q", struct.pack("<d", float(value)))[0]
    return int(value)


def window_fill(column: DeviceColumn, source: torch.Tensor, default
                ) -> DeviceColumn:
    """K14o's default: ``column`` (K7's gather through ``source``, a -1
    row null) with ``default`` in the rows whose source is -1."""
    _check_fill(column, source)
    if column.device.type == "cpu":
        return window_fill_plain(column, source, default)
    if column.device.type != "cuda":
        raise ValueError(f"unsupported device {column.device}")
    n = column.row_count
    out = DeviceColumn(column.data.clone(), column.validity.clone(),
                       column.data_type)
    if n == 0:
        return out
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_frame_library()
    src = source.contiguous()
    with torch.cuda.device(column.device):
        stream = torch.cuda.current_stream(column.device).cuda_stream
        check_launch(lib.srt_window_fill(
            src.data_ptr(), n, out.data.data_ptr(),
            out.validity.view(torch.uint8).data_ptr(),
            out.data.element_size(),
            _default_bits(default, column.data_type), stream),
            "K14o default")
    global OFFSET_LAUNCHES
    OFFSET_LAUNCHES += 1
    return out


def window_ntile(keys: Sequence[DeviceColumn], tiles: Sequence[int], n: int,
                 device: torch.device) -> List[DeviceColumn]:
    """K14o's ntile: for each tile count, each row's tile (int32, from 1;
    the first ``cnt % tiles`` tiles of a partition one row more)."""
    _check_rank(keys, (), (), n, device)
    if any(int(t) < 1 for t in tiles):
        raise ValueError(f"ntile needs n >= 1, got {list(tiles)}")
    if device.type == "cpu":
        return window_ntile_plain(keys, tiles, n, device)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    outs = [DeviceColumn(torch.empty(n, dtype=torch.int32, device=device),
                         torch.ones(n, dtype=torch.bool, device=device),
                         T.INT, True) for _t in tiles]
    if n == 0 or not tiles:
        return outs
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_frame_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        b = _CardBounds(lib, keys, (), n, device, False)
        for t, out in zip(tiles, outs):
            check_launch(lib.srt_window_ntile(n, *b.part(), int(t),
                                              out.data.data_ptr(), stream),
                         "K14o ntile")
    global OFFSET_LAUNCHES
    OFFSET_LAUNCHES += 1
    return outs


# -- the plain versions of K14s, K14b and K14o --

def _bounds_plain(keys, order_keys, n: int, device):
    """Each row's partition start and end, and its peer group's end."""
    pos = torch.arange(n, dtype=torch.int64, device=device)
    if n == 0:
        return pos, pos, pos

    def first_last(starts):
        first = torch.cummax(torch.where(starts, pos, 0), 0)[0]
        ends = torch.ones_like(starts)
        ends[:-1] = starts[1:]
        last = torch.flip(torch.cummin(torch.flip(
            torch.where(ends, pos, n - 1), [0]), 0)[0], [0])
        return first, last
    pstart, pend = first_last(partition_starts_plain(keys, n, device))
    qend = pend if not order_keys else first_last(partition_starts_plain(
        list(keys) + list(order_keys), n, device))[1]
    return pstart, pend, qend


def _present(f, c, n, device):
    if f.kind == WIN_COUNT_ALL:
        return torch.ones(n, dtype=torch.bool, device=device)
    return c.validity


def _finish(f, c, cnt, total, best, has, nan, real, device):
    """A frame function's column from its frame's count of present values
    and sum (sums, counts, means), or its best value and the presence of a
    value, a NaN and a non-NaN value (min, max)."""
    rt = frame_result_type(f, None if c is None else c.data_type)
    if f.kind in (WIN_COUNT, WIN_COUNT_ALL):
        return DeviceColumn(cnt, torch.ones_like(cnt, dtype=torch.bool),
                            T.LONG)
    if f.kind in (WIN_MIN, WIN_MAX):
        out = best
        if rt.is_floating:
            bad = nan if f.kind == WIN_MAX else ~real
            out = torch.where(bad, float("nan"), best)
        return DeviceColumn(torch.where(has, out, torch.zeros((), dtype=
                                                              out.dtype)),
                            has, rt)
    ok = cnt > 0
    zero = torch.zeros((), dtype=total.dtype, device=device)
    if f.kind == WIN_MEAN:
        total = torch.where(ok, total / cnt.clamp(min=1), zero)
    return DeviceColumn(torch.where(ok, total, zero), ok, rt)


def _extreme_fold(f, x, present, acc, got, nan, real, take):
    """One step of a min or max fold over the rows ``take`` selects."""
    isnan = torch.isnan(x) if x.dtype.is_floating_point else \
        torch.zeros_like(present)
    use = take & present & ~isnan
    better = (x > acc) if f.kind == WIN_MAX else (x < acc)
    acc = torch.where(use & (~real | better), x, acc)
    return (acc, got | (take & present), nan | (take & present & isnan),
            real | use)


def window_bounded_plain(keys, funcs, values, n: int, device
                         ) -> List[DeviceColumn]:
    """The plain PyTorch version of K14b: each offset of the frame in turn
    (the JAX program's unrolled gather, :305-321), folded in row order."""
    _check_rank(keys, (), (), n, device)
    _check_frame_funcs(funcs, values, n, device)
    pstart, pend, _q = _bounds_plain(keys, (), n, device)
    pos = torch.arange(n, dtype=torch.int64, device=device)
    outs = []
    for f, c in zip(funcs, values):
        present = _present(f, c, n, device)
        lo = torch.maximum(pos + f.lo, pstart)
        hi = torch.minimum(pos + f.hi, pend)
        x = None if c is None or f.kind in (WIN_COUNT, WIN_COUNT_ALL) else \
            (c.data.to(torch.int64) if f.kind == WIN_SUM_I64 else c.data)
        cnt = torch.zeros(n, dtype=torch.int64, device=device)
        total = torch.zeros(n, dtype=torch.float64 if x is not None and
                            x.dtype.is_floating_point else torch.int64,
                            device=device)
        best = None if x is None else torch.zeros_like(x)
        got, nan, real = (torch.zeros(n, dtype=torch.bool, device=device)
                          for _ in range(3))
        for d in range(f.lo, f.hi + 1):
            j = pos + d
            take = (j >= lo) & (j <= hi)
            js = j.clamp(0, max(n - 1, 0))
            pj = present[js] & take
            cnt = cnt + pj.to(torch.int64)
            if x is None:
                continue
            xj = x[js]
            if f.kind in (WIN_MIN, WIN_MAX):
                best, got, nan, real = _extreme_fold(
                    f, xj, present[js], best, got, nan, real, take)
            else:
                total = total + torch.where(pj, xj, 0).to(total.dtype)
        outs.append(_finish(f, c, cnt, total, best, got, nan, real, device))
    return outs


def _segment_scan_sum(x, starts):
    """The running sum of ``x`` restarted at each start (a cumulative sum
    less its value before the partition's start)."""
    cs = torch.cumsum(x, 0)
    before = cs - x
    pos = torch.arange(x.shape[0], device=x.device)
    first = torch.cummax(torch.where(starts, pos, 0), 0)[0]
    return cs - before[first]


def _segment_scan_doubling(x, starts):
    """The running sum of ``x`` restarted at each start, by doubling:
    step d adds the partial sum d rows back where that row lies in the
    partition, so each sum is a tree of the partition's own values (no
    prefix over earlier partitions, whose size would cost precision) and
    NaN and +-inf arise as IEEE adds give them."""
    n = x.shape[0]
    pos = torch.arange(n, device=x.device)
    first = torch.cummax(torch.where(starts, pos, 0), 0)[0]
    s, d = x, 1
    while d < n:
        back = pos - d
        s = torch.where(back >= first, s + s[back.clamp(min=0)], s)
        d *= 2
    return s


def _running_state(f, c, starts, n, device):
    """The running state of every row (restarted at ``starts``): count of
    present values and sum (a doubling scan of the partition's values),
    or best value, value, NaN and non-NaN presence."""
    present = _present(f, c, n, device)
    cnt = _segment_scan_sum(present.to(torch.int64), starts)
    if f.kind in (WIN_COUNT, WIN_COUNT_ALL):
        return cnt, None, None, None, None, None
    if f.kind in (WIN_MIN, WIN_MAX):
        x = c.data
        isnan = torch.isnan(x) if x.dtype.is_floating_point else \
            torch.zeros_like(present)
        real = present & ~isnan
        values, inv = torch.unique(torch.where(real, x, 0),
                                   return_inverse=True)
        u = values.shape[0]
        # a value's score orders it (higher is better); 0 is no value
        score = torch.where(real, (inv + 1) if f.kind == WIN_MAX
                            else (u - inv), 0)
        gid = torch.cumsum(starts.to(torch.int64), 0)
        top = torch.cummax(gid * (u + 1) + score, 0)[0] - gid * (u + 1)
        best = values[(top - 1 if f.kind == WIN_MAX else u - top)
                      .clamp(0, max(u - 1, 0))]
        has = _segment_scan_sum(present.to(torch.int64), starts) > 0
        nan = _segment_scan_sum((present & isnan).to(torch.int64),
                                starts) > 0
        return cnt, None, best, has, nan, top > 0
    x = c.data
    if x.dtype.is_floating_point:
        total = _segment_scan_doubling(torch.where(present, x, 0.0), starts)
    else:   # wrapping int64 sums are exact in any order
        total = _segment_scan_sum(torch.where(present, x, 0), starts)
    return cnt, total, None, None, None, None


def window_running_plain(keys, order_keys, funcs, values, n: int, device
                         ) -> List[DeviceColumn]:
    """The plain PyTorch version of K14s: each row's running state from
    cumulative sums rebased at its partition's start (a doubling scan for
    double sums; cumulative maxima of value ranks offset by the partition
    id for min and max),
    over the rows in reverse for a frame ending at UNBOUNDED FOLLOWING,
    gathered at the row the frame ends on."""
    _check_rank(keys, order_keys, (), n, device)
    _check_frame_funcs(funcs, values, n, device)
    pstart, pend, qend = _bounds_plain(keys, order_keys, n, device)
    pos = torch.arange(n, dtype=torch.int64, device=device)
    starts = pos == pstart
    outs = []
    for f, c in zip(funcs, values):
        rev, take, off = f.running_form()
        if n == 0:
            outs.append(_frame_outputs([f], [c], 0, device)[0])
            continue
        if rev:
            flip = (lambda t: None if t is None else torch.flip(t, [0]))
            rc = None if c is None else DeviceColumn(
                torch.flip(c.data, [0]), torch.flip(c.validity, [0]),
                c.data_type)
            state = [flip(t) for t in _running_state(
                f, rc, torch.flip(pos == pend, [0]), n, device)]
        else:
            state = list(_running_state(f, c, starts, n, device))
        empty = torch.zeros(n, dtype=torch.bool, device=device)
        if take == TAKE_PARTITION:
            at = pstart if rev else pend
        elif take == TAKE_PEERS:
            at = qend
        elif rev:
            empty = pos + off > pend
            at = torch.maximum(pos + off, pstart)
        else:
            empty = pos + off < pstart
            at = torch.minimum(pos + off, pend)
        at = at.clamp(0, n - 1)
        cnt, total, best, has, nan, real = (
            None if t is None else t[at] for t in state)
        cnt = torch.where(empty, 0, cnt)
        if has is not None:
            has, nan, real = has & ~empty, nan & ~empty, real & ~empty
        outs.append(_finish(f, c, cnt, total, best, has, nan, real, device))
    return outs


def window_offset_plain(keys, offsets, n: int, device) -> List[torch.Tensor]:
    """The plain PyTorch version of K14o's lag/lead maps."""
    _check_rank(keys, (), (), n, device)
    pstart, pend, _q = _bounds_plain(keys, (), n, device)
    pos = torch.arange(n, dtype=torch.int64, device=device)
    return [torch.where((pos + o >= pstart) & (pos + o <= pend), pos + o, -1)
            for o in offsets]


def window_fill_plain(column: DeviceColumn, source: torch.Tensor, default
                      ) -> DeviceColumn:
    """The plain PyTorch version of K14o's default."""
    _check_fill(column, source)
    out = source < 0
    value = torch.tensor(default, dtype=column.data.dtype,
                         device=column.device)
    return DeviceColumn(torch.where(out, value, column.data),
                        column.validity | out, column.data_type)


def window_ntile_plain(keys, tiles, n: int, device) -> List[DeviceColumn]:
    """The plain PyTorch version of K14o's ntile (JAX ``:189-198``)."""
    _check_rank(keys, (), (), n, device)
    pstart, pend, _q = _bounds_plain(keys, (), n, device)
    pos = torch.arange(n, dtype=torch.int64, device=device) - pstart
    cnt = pend - pstart + 1
    outs = []
    for t in tiles:
        base = torch.div(cnt, t, rounding_mode="floor")
        rem = cnt - base * t
        big = rem * (base + 1)
        tile = torch.where(
            pos < big, torch.div(pos, base + 1, rounding_mode="floor"),
            rem + torch.div(pos - big, base.clamp(min=1),
                            rounding_mode="floor"))
        outs.append(DeviceColumn((tile + 1).to(torch.int32),
                                 torch.ones(n, dtype=torch.bool,
                                            device=device), T.INT, True))
    return outs


def compute_windows(payload: Sequence[DeviceColumn],
                    keys: Sequence[DeviceColumn],
                    values: Sequence[Optional[DeviceColumn]], kinds,
                    n: int, device: torch.device, transfers,
                    order_keys: Sequence[DeviceColumn] = (),
                    orders: Sequence[Tuple[bool, bool]] = ()
                    ) -> Tuple[List[DeviceColumn], List[DeviceColumn]]:
    """``(payload sorted by the keys, one column per function)`` of ``n``
    rows on ``device``: K8 and K7 when there are keys, then, by kind, K14's
    reduction (an int kind of ``WIN_SUM_I64``..``WIN_MEAN``, the whole
    partition), its ranking pass (a ranking kind, over ``order_keys``, each
    with the ``(ascending, nulls_first)`` of ``orders``), K14s (a
    ``FrameAgg`` of an unbounded frame; its whole-partition sums, counts
    and means go to K14's reduction), K14b (a ``FrameAgg`` of a bounded
    ROWS frame), or K14o (``OffsetFn``: the source rows, K7's gather of
    the input, its default; ``NTileFn``)."""
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
    # each wrapper once, over the functions it takes, in their order
    groups = {}
    for j, (k, c) in enumerate(zip(kinds, values)):
        if isinstance(k, FrameAgg) and k.lo is None and k.hi is None and \
                k.kind in range(5):
            k = k.kind   # the whole partition: K14's reduction
        if isinstance(k, int):
            route = "rank" if k in RANKING else "reduce"
        elif isinstance(k, FrameAgg):
            route = "bounded" if k.bounded else "running"
        elif isinstance(k, OffsetFn):
            route = "offset"
        elif isinstance(k, NTileFn):
            route = "ntile"
        else:
            raise ValueError(f"unknown window function {k!r}")
        groups.setdefault(route, []).append((j, k, c))
    outs: List[Optional[DeviceColumn]] = [None] * len(kinds)

    def place(members, columns):
        for (j, _k, _c), col in zip(members, columns):
            outs[j] = col
    for route, members in groups.items():
        fs = [k for _j, k, _c in members]
        vs = [c for _j, _k, c in members]
        if route == "rank":
            place(members, window_rank(keys, order_keys, fs, n, device))
        elif route == "reduce":
            place(members, window_reduce(keys, vs, fs, n, device))
        elif route == "running":
            place(members, window_running(keys, order_keys, fs, vs, n,
                                          device))
        elif route == "bounded":
            place(members, window_bounded(keys, fs, vs, n, device))
        elif route == "ntile":
            place(members, window_ntile(keys, [f.n for f in fs], n, device))
        else:
            maps = window_offset(keys, [f.offset for f in fs], n, device)
            for (j, f, c), m in zip(members, maps):
                col, = batch_ops.gather_columns([c], m, transfers,
                                                nullable=True)
                outs[j] = col if f.default is None else \
                    window_fill(col, m, f.default)
    return list(payload), outs
