"""Row movement (the analog of ``spark_rapids_tpu/ops/batch_ops.py``): the
gather kernel (K7) and its wrappers.

``gather_columns`` is K7's wrapper (``gather_batch`` ``:45``; it also does
the gathers of ``join.gather`` ``ops/join_ops.py:335`` and of the fused
stage and sort programs).  On CUDA columns it launches
``csrc/gather.cu``: one launch for every fixed-width plane, then per string
column the offsets scan and the chars copy; on CPU columns it runs
``gather_columns_plain``.  ``unique=True`` says no input row is taken twice
(a compaction, a permutation, one row per group), so a string's chars fit
in its input plane and no sync is needed to size them; otherwise the chars
totals of all string columns reach the host in one sync
(``TransferGateway.read_counts``).

``take_front`` (``:177``, LIMIT) is a slice with no launch.
``concat_batches`` (``:274``) joins the partitions' one-row partial
aggregates before the final merge: torch glue over a handful of scalars;
its full-size form is still to port (ROADMAP queue 2, K7)."""

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
    return DeviceColumn(torch.empty(0, dtype=c.data.dtype, device=device),
                        valid, c.data_type, c.all_valid)


def gather_columns(columns: Sequence[DeviceColumn], idx: torch.Tensor,
                   transfers, unique: bool = False) -> List[DeviceColumn]:
    """K7's wrapper: output row i of each column is input row ``idx[i]``."""
    _check(columns, idx)
    device = idx.device
    if device.type == "cpu":
        return gather_columns_plain(columns, idx, transfers, unique)
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
                src = c.data.contiguous()
                data = torch.empty(n, dtype=src.dtype, device=device)
                planes.append((src, data, src.element_size()))
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
    return [DeviceColumn(data, valid, c.data_type, c.all_valid,
                         offsets.get(j))
            for j, ((data, valid), c) in enumerate(zip(outs, columns))]


def gather_columns_plain(columns: Sequence[DeviceColumn], idx: torch.Tensor,
                         transfers, unique: bool = False
                         ) -> List[DeviceColumn]:
    """The plain PyTorch version of K7 (a string's chars plane is sized
    exactly).  Like the kernel it reads the chars totals through the
    gateway unless ``unique``."""
    _check(columns, idx)
    n = idx.shape[0]
    out: List[DeviceColumn] = []
    strings = []
    for c in columns:
        valid = c.validity[idx]
        if not c.is_string:
            out.append(DeviceColumn(c.data[idx], valid, c.data_type,
                                    c.all_valid))
            continue
        off = c.offsets.to(torch.int64)
        starts = off[idx]
        lens = off[idx + 1] - starts
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
        out[j] = DeviceColumn(c.data[pos], c.validity[idx], T.STRING,
                              c.all_valid, dst)
    return out


def gather_batch(batch: ColumnarBatch, idx: torch.Tensor, transfers,
                 unique: bool = False) -> ColumnarBatch:
    return ColumnarBatch(gather_columns(batch.columns, idx, transfers,
                                        unique),
                         idx.shape[0], batch.names)


def take_front(batch: ColumnarBatch, k: int) -> ColumnarBatch:
    """LIMIT ``k``: the first ``k`` rows, views with no launch."""
    return batch.front(k)


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    if not batches:
        raise ValueError("cannot concat zero batches")
    first = batches[0]
    if len(batches) == 1:
        return first
    if any(c.is_string for c in first.columns):
        raise NotImplementedError(
            "concatenating string columns is not in the port yet")
    cols = []
    for i, c in enumerate(first.columns):
        cols.append(DeviceColumn(
            torch.cat([b.columns[i].data for b in batches]),
            torch.cat([b.columns[i].validity for b in batches]),
            c.data_type))
    return ColumnarBatch(cols, sum(b.row_count for b in batches),
                         first.names)
