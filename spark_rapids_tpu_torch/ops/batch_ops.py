"""Row movement (the analog of ``spark_rapids_tpu/ops/batch_ops.py``): the
gather kernel (K7) and its wrappers.

``gather_columns`` is K7's wrapper (``gather_batch`` ``:45``; it also does the
gathers of ``join.gather`` ``ops/join_ops.py:335`` and of the fused stage and
sort programs). ``nullable=True`` lets the map hold -1, which gives a null row
(validity 0, data 0, length 0): a left outer join's unmatched rows, as
``gather_join_output`` null-extends them. On CUDA columns it launches
``csrc/gather.cu``: one launch for every fixed-width plane, then per string
column the offsets scan and the chars copy; on CPU columns it runs
``gather_columns_plain``. ``unique=True`` says no input row is taken twice (a
compaction, a permutation, one row per group), so a string's chars fit in its
input plane and no sync is needed to size them; otherwise the chars totals of
all string columns reach the host in one sync
(``TransferGateway.read_counts``).

``take_front`` (``:177``, LIMIT) is a slice with no launch.

``concat_batches`` (``:274``, kind ``batch.concat``, built ``:374``) is
K7c's wrapper: it joins several batches of one schema into one, the
partitions' partial aggregate rows before a FINAL merge and an Expand's
grouping-set batches before K9.  On CUDA columns it launches
``csrc/concat.cu`` once per column over all the batches (their planes'
pointers and row counts passed by value): fixed-width values and validity
at each batch's row offset; a string's offsets rebased by the chars
before it (computed on the card, so no sync) and its chars copied after
them.  The row counts are exact on the host, so every output is sized
exactly (a string's chars plane to the sum of the inputs' planes, which
may run past its last offset).  On CPU columns it runs
``concat_batches_plain``: ``torch.cat`` of the planes, the library call,
which is the plain version and no part of the card path."""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K7 (wrapper calls that launch it)
LAUNCHES = 0

#: fixed-width planes one launch takes (csrc/gather.cu kMaxPlanes)
MAX_PLANES = 32
#: values one scan tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024
#: launches of K7c (concat_batches calls that launch it)
CONCAT_LAUNCHES = 0
#: batches one K7c launch takes (csrc/concat.cu kMaxInputs)
MAX_CONCAT_INPUTS = 32

_SIGNATURES = {
    "srt_gather_fixed": "pqipppp",
    "srt_gather_string_offsets": "pqpippp",
    "srt_gather_string_chars": "pqpipppp",
}


def load_library():
    """Builds (first call) and binds ``csrc/gather.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("batch.gather", "csrc/gather.cu",
                        lambda: load_cuda("gather.cu", _SIGNATURES))


def _check(columns: Sequence[DeviceColumn], idx: torch.Tensor) -> None:
    if idx.dtype != torch.int64 or idx.dim() != 1:
        raise TypeError("the gather map must be a 1-D int64 tensor")
    for c in columns:
        if c.device != idx.device:
            raise ValueError("columns and gather map lie on different "
                             "devices")


def _empty(c: DeviceColumn, device) -> DeviceColumn:
    valid = torch.empty(0, dtype=torch.bool, device=device)
    if c.is_string:
        return DeviceColumn(torch.empty(0, dtype=torch.uint8, device=device),
                            valid, c.data_type, c.all_valid,
                            torch.zeros(1, dtype=torch.int64, device=device))
    return DeviceColumn(torch.empty((0,) + tuple(c.data.shape[1:]),
                                    dtype=c.data.dtype, device=device),
                        valid, c.data_type, c.all_valid)


def row_bytes(t: torch.Tensor) -> int:
    """Bytes a row of a fixed-width plane: 16 for a decimal128's [rows, 2]
    (hi, lo) plane."""
    return t.element_size() * (t.shape[1] if t.dim() == 2 else 1)


def fixed_plane(t: torch.Tensor) -> torch.Tensor:
    """A fixed-width plane as a kernel reads it: contiguous, and a
    16-byte plane (a decimal128's) on a 16-byte boundary, copied where a
    view starts between two."""
    t = t.contiguous()
    if row_bytes(t) == 16 and t.data_ptr() % 16:
        t = t.clone()
    return t


def empty_rows(t: torch.Tensor, n: int) -> torch.Tensor:
    """An uninitialised plane of ``n`` rows shaped like plane ``t``."""
    return torch.empty((n,) + tuple(t.shape[1:]), dtype=t.dtype,
                       device=t.device)


def gather_columns(columns: Sequence[DeviceColumn], idx: torch.Tensor,
                   transfers, unique: bool = False,
                   nullable: bool = False) -> List[DeviceColumn]:
    """K7's wrapper: output row i of each column is input row ``idx[i]``;
    with ``nullable``, ``idx[i]`` may be -1, which gives a null row."""
    _check(columns, idx)
    device = idx.device
    if device.type == "cpu":
        return gather_columns_plain(columns, idx, transfers, unique,
                                    nullable)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = idx.shape[0]
    if n == 0 or not columns:
        return [_empty(c, device) for c in columns]
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    idx = idx.contiguous()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        planes = []           # (source, destination, width)
        outs = []
        for c in columns:
            valid = torch.empty(n, dtype=torch.bool, device=device)
            planes.append((c.validity.contiguous().view(torch.uint8),
                           valid.view(torch.uint8), 1))
            data = None
            if not c.is_string:
                src = fixed_plane(c.data)
                data = empty_rows(src, n)
                planes.append((src, data, row_bytes(src)))
            outs.append([data, valid])
        for k in range(0, len(planes), MAX_PLANES):
            chunk = planes[k:k + MAX_PLANES]
            check_launch(lib.srt_gather_fixed(
                idx.data_ptr(), n, len(chunk),
                pointers([p[0] for p in chunk]),
                pointers([p[1] for p in chunk]),
                int32s([p[2] for p in chunk]), stream), "K7 gather")
        strings = [j for j, c in enumerate(columns) if c.is_string]
        tiles = torch.empty(-(-n // SCAN_TILE), dtype=torch.int64,
                            device=device)
        offsets = {}
        for j in strings:
            c = columns[j]
            dst_off = torch.empty(n + 1, dtype=torch.int64, device=device)
            check_launch(lib.srt_gather_string_offsets(
                idx.data_ptr(), n, c.offsets.data_ptr(),
                int(c.offsets.dtype == torch.int64), dst_off.data_ptr(),
                tiles.data_ptr(), stream), "K7 string offsets")
            offsets[j] = dst_off
        if unique:
            sizes = [columns[j].data.numel() for j in strings]
        else:
            sizes = transfers.read_counts([offsets[j][n] for j in strings]) \
                if strings else []
        for j, size in zip(strings, sizes):
            c = columns[j]
            chars = torch.empty(size, dtype=torch.uint8, device=device)
            check_launch(lib.srt_gather_string_chars(
                idx.data_ptr(), n, c.offsets.data_ptr(),
                int(c.offsets.dtype == torch.int64), c.data.data_ptr(),
                offsets[j].data_ptr(), chars.data_ptr(), stream),
                "K7 string chars")
            outs[j][0] = chars
    global LAUNCHES
    LAUNCHES += 1
    return [DeviceColumn(data, valid, c.data_type,
                         c.all_valid and not nullable, offsets.get(j))
            for j, ((data, valid), c) in enumerate(zip(outs, columns))]


def gather_columns_plain(columns: Sequence[DeviceColumn], idx: torch.Tensor,
                         transfers, unique: bool = False,
                         nullable: bool = False) -> List[DeviceColumn]:
    """The plain PyTorch version of K7 (a string's chars plane is sized
    exactly).  Like the kernel it reads the chars totals through the
    gateway unless ``unique``."""
    _check(columns, idx)
    n = idx.shape[0]
    out: List[DeviceColumn] = []
    strings = []
    null = idx < 0
    safe = torch.where(null, 0, idx)
    all_valid = not nullable

    def take(plane: torch.Tensor) -> torch.Tensor:
        """plane[idx], 0 where idx is -1."""
        shape = (n,) + tuple(plane.shape[1:])
        if not plane.numel():
            return torch.zeros(shape, dtype=plane.dtype, device=idx.device)
        rows = plane[safe]
        return torch.where(null.view((n,) + (1,) * (rows.dim() - 1)),
                           torch.zeros((), dtype=plane.dtype,
                                       device=idx.device), rows)

    for c in columns:
        valid = take(c.validity)
        if not c.is_string:
            out.append(DeviceColumn(take(c.data), valid, c.data_type,
                                    c.all_valid and all_valid))
            continue
        off = c.offsets.to(torch.int64)
        starts = take(off[:-1])
        lens = take(off[1:]) - starts
        dst = torch.zeros(n + 1, dtype=torch.int64, device=idx.device)
        torch.cumsum(lens, 0, out=dst[1:])
        strings.append((len(out), c, starts, lens, dst))
        out.append(None)
    totals = [int(s[4][-1]) for s in strings] if unique or not strings \
        else transfers.read_counts([s[4][-1] for s in strings])
    for (j, c, starts, lens, dst), total in zip(strings, totals):
        pos = torch.repeat_interleave(starts - dst[:-1], lens,
                                      output_size=total) + \
            torch.arange(total, dtype=torch.int64, device=idx.device)
        out[j] = DeviceColumn(c.data[pos], take(c.validity), T.STRING,
                              c.all_valid and all_valid, dst)
    return out


def gather_batch(batch: ColumnarBatch, idx: torch.Tensor, transfers,
                 unique: bool = False) -> ColumnarBatch:
    return ColumnarBatch(gather_columns(batch.columns, idx, transfers,
                                        unique),
                         idx.shape[0], batch.names)


def empty_batch(schema: T.StructType, device: torch.device
                ) -> ColumnarBatch:
    """A batch of no row of ``schema`` (views of empty planes, no
    launch)."""
    cols = []
    for dt in schema.types:
        valid = torch.empty(0, dtype=torch.bool, device=device)
        if isinstance(dt, T.StringType):
            cols.append(DeviceColumn(
                torch.empty(0, dtype=torch.uint8, device=device), valid, dt,
                True, torch.zeros(1, dtype=torch.int64, device=device)))
        else:
            wide = isinstance(dt, T.DecimalType) and dt.is_decimal128
            cols.append(DeviceColumn(torch.empty((0, 2) if wide else 0,
                                                 dtype=dt.torch_dtype,
                                                 device=device), valid, dt,
                                     True))
    return ColumnarBatch(cols, 0, schema.names)


def take_front(batch: ColumnarBatch, k: int) -> ColumnarBatch:
    """LIMIT ``k``: the first ``k`` rows, views with no launch."""
    return batch.front(k)


def load_concat_library():
    """Builds (first call) and binds ``csrc/concat.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build(
        "batch.concat", "csrc/concat.cu",
        lambda: load_cuda("concat.cu",
                          {"srt_concat_column": "iipppppqppppp"}))


def _check_concat(batches: Sequence[ColumnarBatch]) -> None:
    if not batches:
        raise ValueError("cannot concat zero batches")
    types = [c.data_type for c in batches[0].columns]
    for b in batches[1:]:
        if [c.data_type for c in b.columns] != types:
            raise TypeError("batches of different column types")
        if b.columns and b.device != batches[0].device:
            raise ValueError("batches lie on different devices")


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    """K7c's wrapper: the batches' rows, in order, as one batch (the
    first batch's names).  More than ``MAX_CONCAT_INPUTS`` batches are
    joined in groups first (a launch a group and column)."""
    _check_concat(batches)
    first = batches[0]
    if len(batches) == 1:
        return first
    if not first.columns or first.device.type == "cpu":
        return concat_batches_plain(batches)
    device = first.device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if len(batches) > MAX_CONCAT_INPUTS:
        return concat_batches([
            concat_batches(batches[k:k + MAX_CONCAT_INPUTS])
            for k in range(0, len(batches), MAX_CONCAT_INPUTS)])
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      int64s, pointers)
    lib = load_concat_library()
    n = sum(b.row_count for b in batches)
    rows = [b.row_count for b in batches]
    cols = []
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        for i, c0 in enumerate(first.columns):
            ins = [b.columns[i] for b in batches]
            # held by name until the launch is queued
            data = [c.data.contiguous() if c.is_string else
                    fixed_plane(c.data) for c in ins]
            valid = [None if c.all_valid else
                     c.validity.contiguous().view(torch.uint8) for c in ins]
            out_valid = torch.empty(n, dtype=torch.bool, device=device)
            all_valid = all(c.all_valid for c in ins)
            if c0.is_string:
                offsets = [c.offsets.contiguous() for c in ins]
                chars = torch.empty(sum(d.numel() for d in data),
                                    dtype=torch.uint8, device=device)
                out_off = torch.empty(n + 1, dtype=torch.int64,
                                      device=device)
                check_launch(lib.srt_concat_column(
                    len(ins), 0, pointers(data), pointers(valid),
                    pointers(offsets),
                    int32s([int(o.dtype == torch.int64) for o in offsets]),
                    int64s(rows), max(rows + [d.numel() for d in data]),
                    None, out_valid.data_ptr(), out_off.data_ptr(),
                    chars.data_ptr(), stream), "K7c concat (string)")
                cols.append(DeviceColumn(chars, out_valid, c0.data_type,
                                         all_valid, out_off))
                continue
            out = empty_rows(data[0], n)
            check_launch(lib.srt_concat_column(
                len(ins), row_bytes(out), pointers(data),
                pointers(valid), pointers([]), int32s([]), int64s(rows),
                max(rows), out.data_ptr(), out_valid.data_ptr(), None, None,
                stream), "K7c concat")
            cols.append(DeviceColumn(out, out_valid, c0.data_type,
                                     all_valid))
    global CONCAT_LAUNCHES
    CONCAT_LAUNCHES += 1
    return ColumnarBatch(cols, n, first.names)


def concat_batches_plain(batches: Sequence[ColumnarBatch]
                         ) -> ColumnarBatch:
    """The plain PyTorch version of K7c: ``torch.cat`` of each plane, a
    string's offsets rebased by the chars before it."""
    _check_concat(batches)
    first = batches[0]
    cols = []
    for i, c0 in enumerate(first.columns):
        ins = [b.columns[i] for b in batches]
        valid = torch.cat([c.validity for c in ins])
        all_valid = all(c.all_valid for c in ins)
        if not c0.is_string:
            cols.append(DeviceColumn(torch.cat([c.data for c in ins]), valid,
                                     c0.data_type, all_valid))
            continue
        pieces, chars, base = [], [], 0
        for c in ins:
            off = c.offsets.to(torch.int64)
            lo, hi = int(off[0]), int(off[-1])
            pieces.append(off[:-1] - lo + base)
            chars.append(c.data[lo:hi])
            base += hi - lo
        pieces.append(torch.full((1,), base, dtype=torch.int64,
                                 device=valid.device))
        cols.append(DeviceColumn(torch.cat(chars), valid, c0.data_type,
                                 all_valid, torch.cat(pieces)))
    return ColumnarBatch(cols, sum(b.row_count for b in batches),
                         first.names)


def slice_columns(columns: Sequence[DeviceColumn], start: int, length: int,
                  transfers, exact: bool = False) -> List[DeviceColumn]:
    """Rows ``[start, start + length)``: views of the fixed-width planes;
    a string column through K7 (its chars plane the input's size, or,
    with ``exact``, sized exactly after one sync)."""
    strings = [c for c in columns if c.is_string]
    taken = iter(gather_columns(
        strings, torch.arange(start, start + length, dtype=torch.int64,
                              device=strings[0].device),
        transfers, unique=not exact) if strings else [])
    end = start + length
    return [next(taken) if c.is_string else
            DeviceColumn(c.data[start:end], c.validity[start:end],
                         c.data_type, c.all_valid) for c in columns]


def slice_batch(batch: ColumnarBatch, start: int, length: int, transfers,
                exact: bool = False) -> ColumnarBatch:
    return ColumnarBatch(slice_columns(batch.columns, start, length,
                                       transfers, exact), length,
                         batch.names)


def row_pieces(batch: ColumnarBatch, max_bytes: int, transfers
               ) -> List[ColumnarBatch]:
    """The batch in row slices of about ``max_bytes`` each (at least one
    row; the batch itself when it fits), string columns sized exactly."""
    n, size = batch.row_count, batch.nbytes()
    if size <= max_bytes or n <= 1:
        return [batch]
    per = max(1, n * max_bytes // size)
    return [slice_batch(batch, s, min(per, n - s), transfers, exact=True)
            for s in range(0, n, per)]
