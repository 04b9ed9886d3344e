"""Global reduction of aggregation buffers: kernel 2 (the analog of
``spark_rapids_tpu/ops/agg_ops.py``: ``_global_aggregate`` ``:223``,
``global_agg_trace`` ``:259``, ``_global_reduce`` ``:159``).

``global_reduce`` is the kernel's wrapper.  Its input is a table of 8-byte
words ``[n_rows, n_cols]`` (int64 as is, double as its bits) with a
validity table of the same shape, and one reduction kind per column; its
output is one word and one validity flag per column.  On a CUDA tensor it
launches ``csrc/global_reduce.cu`` (one block per column, a fixed-order
tree, no atomics); on a CPU tensor it runs ``global_reduce_plain``.

Kinds: sum (int64 wraps; double), count, and min / max with NaN greater
than every other value.  The other kinds of ``_global_reduce`` (first,
last, mean, m2, decimal sums) are not in this slice and raise.

Bound: the kernel reads each cell once (9 bytes) and writes 9 bytes per
column, so it is bound by device memory bytes; at the main path's sizes
(tens of thousands of rows) its launch latency dominates."""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

SUM_I64, SUM_F64, COUNT, MIN_I64, MAX_I64, MIN_F64, MAX_F64 = range(7)
#: columns one launch takes (the kind table is passed by value)
MAX_COLUMNS = 64

#: launches of kernel 2 (incremented only where the kernel is launched)
LAUNCHES = 0

INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1


def reduce_kind(kind: str, dtype: T.DataType) -> int:
    """Kernel kind for a buffer reduction ``kind`` over a ``dtype`` column."""
    if kind == "count":
        return COUNT
    if kind == "sum" and dtype.is_numeric:
        return SUM_F64 if dtype.is_floating else SUM_I64
    if kind in ("min", "max") and dtype.is_numeric:
        if dtype.is_floating:
            return MIN_F64 if kind == "min" else MAX_F64
        return MIN_I64 if kind == "min" else MAX_I64
    raise NotImplementedError(
        f"reduction {kind!r} over {dtype} is not in this port yet")


def _load_library():
    from spark_rapids_tpu_torch.kernels.build import build_shared_library
    lib = ctypes.CDLL(str(build_shared_library("global_reduce.cu")))
    fn = lib.srt_global_reduce
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def load_library():
    """Builds (first call) and returns the kernel's C entry point."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    return get_or_build("agg.global", "csrc/global_reduce.cu",
                        _load_library)


def _check(values: torch.Tensor, valid: torch.Tensor,
           kinds: Sequence[int]) -> None:
    if values.dtype != torch.int64 or values.dim() != 2:
        raise TypeError("values must be a 2-D int64 word table")
    if valid.shape != values.shape or valid.dtype not in (torch.bool,
                                                          torch.uint8):
        raise TypeError("valid must be a bool or uint8 table shaped like "
                        "values")
    if valid.device != values.device:
        raise ValueError("values and valid lie on different devices")
    if len(kinds) != values.shape[1]:
        raise ValueError(f"{len(kinds)} kinds for {values.shape[1]} columns")
    if any(k not in range(7) for k in kinds):
        raise ValueError(f"unknown reduction kind in {list(kinds)}")


def global_reduce(values: torch.Tensor, valid: torch.Tensor,
                  kinds: Sequence[int]) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 2's wrapper: ``(words[n_cols], valid[n_cols] bool)``."""
    _check(values, valid, kinds)
    if values.device.type == "cpu":
        return global_reduce_plain(values, valid, kinds)
    if values.device.type != "cuda":
        raise ValueError(f"unsupported device {values.device}")
    n_rows, n_cols = values.shape
    if not 0 < n_cols <= MAX_COLUMNS:
        raise ValueError(f"kernel 2 takes 1..{MAX_COLUMNS} columns, got "
                         f"{n_cols}")
    values = values.contiguous()
    valid = valid.contiguous()
    out = torch.empty(n_cols, dtype=torch.int64, device=values.device)
    out_valid = torch.empty(n_cols, dtype=torch.bool, device=values.device)
    fn = load_library()
    kind_arr = (ctypes.c_int32 * n_cols)(*kinds)
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        rc = fn(values.data_ptr(), valid.data_ptr(), n_rows, n_cols,
                kind_arr, out.data_ptr(), out_valid.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"kernel 2 (global_reduce) launch failed: CUDA "
                           f"error {rc}")
    global LAUNCHES
    LAUNCHES += 1
    return out, out_valid


def global_reduce_plain(values: torch.Tensor, valid: torch.Tensor,
                        kinds: Sequence[int]
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel 2 (same words in, same out)."""
    _check(values, valid, kinds)
    valid = valid.to(torch.bool)
    dev = values.device
    n_rows = values.shape[0]
    words: List[torch.Tensor] = []
    oks: List[torch.Tensor] = []
    for j, kind in enumerate(kinds):
        v = values[:, j]
        p = valid[:, j]
        if n_rows == 0:
            words.append(torch.zeros((), dtype=torch.int64, device=dev))
            oks.append(torch.tensor(kind == COUNT, device=dev))
            continue
        any_valid = p.any()
        if kind == SUM_I64:
            w = torch.where(p, v, 0).sum()
        elif kind == COUNT:
            w, any_valid = p.sum(), torch.ones((), dtype=torch.bool,
                                                device=dev)
        elif kind in (MIN_I64, MAX_I64):
            z = torch.where(p, v, INT64_MAX if kind == MIN_I64 else INT64_MIN)
            w = z.min() if kind == MIN_I64 else z.max()
        else:
            f = v.view(torch.float64)
            if kind == SUM_F64:
                r = torch.where(p, f, 0.0).sum()
            else:
                nan = p & torch.isnan(f)
                num = p & ~torch.isnan(f)
                if kind == MIN_F64:
                    r = torch.where(num, f, float("inf")).min()
                    to_nan = nan.any() & ~num.any()
                else:
                    r = torch.where(num, f, float("-inf")).max()
                    to_nan = nan.any()
                r = torch.where(to_nan, float("nan"), r)
            w = r.reshape(1).view(torch.int64)[0]
        words.append(w)
        oks.append(any_valid)
    return torch.stack(words), torch.stack(oks)


def pack_columns(columns: Sequence[DeviceColumn], specs
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """Word and validity tables for ``specs`` =
    ``[(ordinal, kind, count_valid_only, buffer dtype)]`` over columns."""
    words, valids, kinds = [], [], []
    for ordinal, kind, count_valid_only, _dt in specs:
        c = columns[ordinal]
        kinds.append(reduce_kind(kind, c.data_type))
        if c.data_type.is_floating:
            words.append(c.data.view(torch.int64))
        else:
            words.append(c.data.to(torch.int64))
        if kind == "count" and not count_valid_only:
            valids.append(torch.ones_like(c.validity))
        else:
            valids.append(c.validity)
    return torch.stack(words, 1), torch.stack(valids, 1), kinds


def unpack_row(words: torch.Tensor, valid: torch.Tensor,
               dtypes: Sequence[T.DataType], names: Sequence[str]
               ) -> ColumnarBatch:
    """A one-row batch from kernel 2's output words."""
    cols = []
    for j, dt in enumerate(dtypes):
        w = words[j:j + 1]
        data = w.view(torch.float64) if dt.is_floating \
            else w.to(dt.torch_dtype)
        cols.append(DeviceColumn(data, valid[j:j + 1], dt))
    return ColumnarBatch(cols, 1, names)


def global_aggregate(batch: ColumnarBatch, specs,
                     names: Sequence[str] = ()) -> ColumnarBatch:
    """One buffer row from all of ``batch``'s rows (kernel 2 on the card)."""
    values, valid, kinds = pack_columns(batch.columns, specs)
    words, ok = global_reduce(values, valid, kinds)
    names = list(names) or [f"a{j}" for j in range(len(specs))]
    return unpack_row(words, ok, [s[3] for s in specs], names)
