"""Aggregation kernels (the analog of ``spark_rapids_tpu/ops/agg_ops.py``):
the global reduction of aggregation buffers, kernel 2 (K3 in ROADMAP;
``_global_aggregate`` ``:223``, ``global_agg_trace`` ``:259``,
``_global_reduce`` ``:159``), and the keyed aggregation, K9
(``keyed_agg_trace`` ``:390``, ``_segment_reduce`` ``:52``,
``_masked_group_words`` ``:38``), below ``keyed_aggregate``, and the
distinct count, K15d (``collect_phase1/2`` ``:550``, ``:646`` with the
distinct flag), below ``count_distinct``, and collect_list and
collect_set, K15 (the same programs), below ``collect``.

``global_reduce`` is the kernel's wrapper.  Its input is a table of 8-byte
words ``[n_rows, n_cols]`` (int64 as is, double as its bits) with a
validity table of the same shape, and one reduction kind per column; its
output is one word and one validity flag per column.  On a CUDA tensor it
launches ``csrc/global_reduce.cu`` (one block per column, a fixed-order
tree, no atomics); on a CPU tensor it runs ``global_reduce_plain``.

Kinds: sum (int64 wraps; double), count, min / max (int, date and long
as their int64 words; doubles with NaN greater than every other value,
and -0.0 below 0.0, as the JAX device path's ``jnp.min`` gives them),
and first, last, first_valid and last_valid: the word of the first or
last row, or of the first or last valid row, in row order (the JAX merge
kinds over buffer rows, ``_global_reduce`` ``:196-208``: a ``first``
merge takes the first row even when its value is null).  A string
column's first/last is reduced over its row numbers (``pack_columns``)
and gathered by K7 (``global_aggregate``), as ``global_agg_trace``
``:293-310`` picks the row.  A decimal64 sum is the int64 sum of its
unscaled values; a decimal128 sum (``:166-180``) takes two word columns,
the hi words (``SUM_DEC128``) and the lo words (``DEC128_LO``), summed
as 128-bit integers, wrapping mod 2^128 as the JAX limb sums do.  The
other kinds of ``_global_reduce`` (mean, m2) are not in this port yet and
raise.

Bound: by device memory bytes.  Sum, min and max need each cell once (9
bytes), count its validity byte; first_valid and last_valid need the
validity bytes and the picked row, first and last the picked row alone;
9 bytes a column out.  At the main path's sizes (tens of thousands of
rows) its launch latency dominates."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops.join_ops import table_size

(SUM_I64, SUM_F64, COUNT, MIN_I64, MAX_I64, MIN_F64, MAX_F64, FIRST, LAST,
 FIRST_VALID, LAST_VALID, SUM_DEC128, DEC128_LO) = range(13)
#: kernel 2's kind of each row-order reduction
ROW_KINDS = {"first": FIRST, "last": LAST, "first_valid": FIRST_VALID,
             "last_valid": LAST_VALID}
#: the types min and max take (strings are refused, as on the JAX device
#: path, ``exec/aggregate.py:663``), and the types first and last take
MIN_MAX_TYPES = (T.INT, T.DATE, T.LONG, T.DOUBLE)
FIRST_LAST_TYPES = MIN_MAX_TYPES + (T.STRING,)
#: columns one launch takes (the kind table is passed by value)
MAX_COLUMNS = 64

#: launches of kernel 2 (incremented only where the kernel is launched),
#: and those with a decimal128 sum
LAUNCHES = 0
DECIMAL_LAUNCHES = 0

INT64_MIN = -(2 ** 63)
INT64_MAX = 2 ** 63 - 1
#: the quiet NaN a min or max of NaNs gives (its bits)
_NAN_WORD = 0x7ff8000000000000


def reduce_kind(kind: str, dtype: T.DataType) -> int:
    """Kernel kind for a buffer reduction ``kind`` over a ``dtype`` column."""
    if kind == "count":
        return COUNT
    if kind == "sum" and isinstance(dtype, T.DecimalType):
        return SUM_DEC128 if dtype.is_decimal128 else SUM_I64
    if kind == "sum" and dtype.is_numeric:
        return SUM_F64 if dtype.is_floating else SUM_I64
    if kind in ("min", "max") and dtype in MIN_MAX_TYPES:
        if dtype.is_floating:
            return MIN_F64 if kind == "min" else MAX_F64
        return MIN_I64 if kind == "min" else MAX_I64
    if kind in ROW_KINDS and dtype in FIRST_LAST_TYPES:
        return ROW_KINDS[kind]
    raise NotImplementedError(
        f"reduction {kind!r} over {dtype} is not in this port yet")


def load_library():
    """Builds (first call) and binds ``csrc/global_reduce.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build(
        "agg.global", "csrc/global_reduce.cu",
        lambda: load_cuda("global_reduce.cu",
                          {"srt_global_reduce": "ppqqpppp"}))


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
    if any(k not in range(13) for k in kinds):
        raise ValueError(f"unknown reduction kind in {list(kinds)}")
    for j, k in enumerate(kinds):
        if (k == SUM_DEC128) != (j + 1 < len(kinds) and
                                 kinds[j + 1] == DEC128_LO) or \
                (k == DEC128_LO and (j == 0 or kinds[j - 1] != SUM_DEC128)):
            raise ValueError("a decimal128 sum is a SUM_DEC128 column and "
                             "the DEC128_LO column after it")


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
    from spark_rapids_tpu_torch.kernels.build import check_launch, int32s
    lib = load_library()
    with torch.cuda.device(values.device):
        stream = torch.cuda.current_stream(values.device).cuda_stream
        check_launch(lib.srt_global_reduce(
            values.data_ptr(), valid.data_ptr(), n_rows, n_cols,
            int32s(kinds), out.data_ptr(), out_valid.data_ptr(), stream),
            "kernel 2 (global_reduce)")
    global LAUNCHES, DECIMAL_LAUNCHES
    LAUNCHES += 1
    DECIMAL_LAUNCHES += SUM_DEC128 in kinds
    return out, out_valid


def f64_order(bits: torch.Tensor) -> torch.Tensor:
    """A double's bits as an int64 that orders as the double does, -0.0
    below 0.0 (its own inverse)."""
    return bits ^ ((bits >> 63) & INT64_MAX)


def min_max_plain(v: torch.Tensor, p: torch.Tensor, kind: int
                  ) -> torch.Tensor:
    """The min or max word of the valid words ``v[p]`` under kernel 2's
    rules (an int64 word, or a double's bits)."""
    is_min = kind in (MIN_I64, MIN_F64)
    ident = v.new_full((1,), INT64_MAX if is_min else INT64_MIN)

    def fold(z):
        z = torch.cat([z, ident])
        return z.min() if is_min else z.max()
    if kind in (MIN_I64, MAX_I64):
        return fold(torch.where(p, v, ident))
    nan = p & torch.isnan(v.view(torch.float64))
    num = p & ~nan
    r = fold(torch.where(num, f64_order(v), ident))
    to_nan = nan.any() & ~num.any() if is_min else nan.any()
    return torch.where(to_nan, _NAN_WORD, f64_order(r))


def sum128_plain(hi: torch.Tensor, lo: torch.Tensor, p: torch.Tensor,
                 gid: Optional[torch.Tensor] = None, g: int = 1):
    """The 128-bit sums of the present (hi, lo) values, wrapping mod
    2^128, as ``_segment_reduce`` forms them: four 32-bit limb sums in
    int64, one carry pass; one sum, or one a group of ``gid``."""
    from spark_rapids_tpu_torch.expressions import decimal_math as DM
    limbs = DM.split(hi, lo)
    if gid is None:
        sums = [torch.where(p, x, 0).sum() for x in limbs]
    else:
        sums = [torch.zeros(g, dtype=torch.int64, device=hi.device)
                .index_add_(0, gid, torch.where(p, x, 0)) for x in limbs]
    norm, _carry = DM.normalize(sums)
    return DM.join(norm)


def row_pick_plain(n: int, p: torch.Tensor, kind: int) -> torch.Tensor:
    """The row a row-order kind picks (-1 for none): the first or last
    row, or the first or last valid one."""
    pos = torch.arange(n, dtype=torch.int64, device=p.device)
    none = pos.new_full((1,), -1)
    picked = pos if kind in (FIRST, LAST) else pos[p]
    if kind in (FIRST, FIRST_VALID):
        return torch.cat([picked, none])[0]
    return torch.cat([none, picked])[-1]


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
        if kind == DEC128_LO:
            continue   # written with the SUM_DEC128 column before it
        if kind == SUM_DEC128:
            hi, lo = sum128_plain(v, values[:, j + 1], p)
            words += [hi, lo]
            oks += [any_valid, any_valid]
            continue
        if kind == SUM_I64:
            w = torch.where(p, v, 0).sum()
        elif kind == COUNT:
            w, any_valid = p.sum(), torch.ones((), dtype=torch.bool,
                                                device=dev)
        elif kind == SUM_F64:
            r = torch.where(p, v.view(torch.float64), 0.0).sum()
            w = r.reshape(1).view(torch.int64)[0]
        elif kind in ROW_KINDS.values():
            r = row_pick_plain(n_rows, p, kind)
            at = r.clamp(min=0)
            w = torch.where(r >= 0, v[at], 0)
            any_valid = (r >= 0) & p[at]
        else:
            w = min_max_plain(v, p, kind)
        words.append(w)
        oks.append(any_valid)
    return torch.stack(words), torch.stack(oks)


def pack_columns(columns: Sequence[DeviceColumn], specs
                 ) -> Tuple[torch.Tensor, torch.Tensor, List[int]]:
    """Word and validity tables for ``specs`` =
    ``[(ordinal, kind, count_valid_only, buffer dtype)]`` over columns.  A
    string column (first/last only) gives its row numbers, which
    ``global_aggregate`` gathers by."""
    words, valids, kinds = [], [], []
    for ordinal, kind, count_valid_only, _dt in specs:
        c = columns[ordinal]
        kinds.append(reduce_kind(kind, c.data_type))
        if kinds[-1] == SUM_DEC128:
            # the hi words, then the lo words
            words += [c.data[:, 0], c.data[:, 1]]
            valids += [c.validity, c.validity]
            kinds.append(DEC128_LO)
            continue
        if c.is_string:
            words.append(torch.arange(c.row_count, dtype=torch.int64,
                                      device=c.device))
        elif c.data_type.is_floating:
            words.append(c.data.view(torch.int64))
        else:
            words.append(c.data.to(torch.int64))
        if kind == "count" and not count_valid_only:
            valids.append(torch.ones_like(c.validity))
        else:
            valids.append(c.validity)
    return torch.stack(words, 1), torch.stack(valids, 1), kinds


def unpack_row(words: torch.Tensor, valid: torch.Tensor,
               dtypes: Sequence[T.DataType], names: Sequence[str],
               picks=None, transfers=None) -> ColumnarBatch:
    """A one-row batch from kernel 2's output words.  Where ``picks[j]``
    is a column, word ``j`` is the row of it to take, which K7 gathers (a
    null where the word is not valid)."""
    cols = []
    at = 0   # the buffer's first word
    for j, dt in enumerate(dtypes):
        w = words[at:at + 1]
        at += 1
        if isinstance(dt, T.DecimalType) and dt.is_decimal128:
            cols.append(DeviceColumn(words[at - 1:at + 1].reshape(1, 2)
                                     .clone(), valid[at - 1:at], dt))
            at += 1
            continue
        if picks is not None and picks[j] is not None:
            from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
            rows = torch.where(valid[at - 1:at], w, -1)
            cols += gather_columns([picks[j]], rows, transfers,
                                   unique=True, nullable=True)
            continue
        data = w.view(torch.float64) if dt.is_floating \
            else w.to(dt.torch_dtype)
        cols.append(DeviceColumn(data, valid[at - 1:at], dt))
    return ColumnarBatch(cols, 1, names)


def global_aggregate(batch: ColumnarBatch, specs,
                     names: Sequence[str] = (),
                     transfers=None) -> ColumnarBatch:
    """One buffer row from all of ``batch``'s rows (kernel 2 on the card;
    K7 for a string first/last)."""
    values, valid, kinds = pack_columns(batch.columns, specs)
    words, ok = global_reduce(values, valid, kinds)
    names = list(names) or [f"a{j}" for j in range(len(specs))]
    strings = [batch.columns[s[0]] if batch.columns[s[0]].is_string
               else None for s in specs]
    return unpack_row(words, ok, [s[3] for s in specs], names, strings,
                      transfers)


# -- K9: keyed aggregation ----------------------------------------------------
#
# ``keyed_aggregate`` is K9's wrapper.  Rows are grouped by their key
# columns (int, date, long, double or string; a null is a value of its
# own; a double key groups -0.0 with 0.0 and every NaN together, by its
# normalised bits, as ``_masked_group_words`` over ``sortable_words``
# does) through a
# hash table (``csrc/keyed_agg.cu``); groups are numbered in order of first
# appearance, and each aggregate is folded over its group's rows in row
# order, so results do not depend on timing.  A double sum takes an int,
# long or double input, converting each row to double (an average's sum
# of ``Cast(child, DOUBLE)``); so does m2, the variance family's sum of
# squared deviations from the group's mean (``keyed_agg_trace``'s m2
# kind, ``:490-502``: the mean first, then the squares; 0.0 and valid for
# a group with no present value).  The host reads the group
# count once (one sync) to size the outputs.  ``keyed_aggregate_plain``
# does the same with torch ops: the same hash (``key_hash_plain``, which a
# test replaces to force collisions), linear probing in rounds, keys
# compared value by value and strings byte by byte.
#
# The merge kinds fold partial buffers (a FINAL aggregate, the JAX
# package's merge specs ``:340`` and ``fused.agg_merge_final``,
# ``exec/fused.py:468``): sums of sums and counts are the sum kinds over
# the buffer columns, and the joint Chan merge of (n, mean, m2) triples
# (``:466-487``) is ``KEYED_CHAN_MEAN`` and ``KEYED_CHAN_M2``, whose
# ``aux`` entry gives the triple's n and mean columns.
#
# Min and max (``_segment_reduce`` ``:82-109``) take an int, date, long or
# double input and keep its type: a double's NaN is greater than every
# other value (min skips NaN unless every present value is NaN; max is
# NaN if any present value is) and -0.0 is below 0.0, as the JAX device
# path's ``segment_min``/``segment_max`` give them.  First and last
# (``:110-125``) take the group's first or last row in row order, the
# ``_valid`` kinds its first or last present row; an int, date, long or
# double input keeps its type, and for a string input (``_lengths_reduce``
# ``:134``) K9 writes the row (-1 for a null), which K7 gathers.  A group
# with no present value of a min or max, or no row of a ``_valid`` kind,
# is null and holds 0.  The same kinds merge a FINAL aggregate's buffer
# rows, in the order the exchange delivers them.
#
# Decimal sums (``_segment_reduce`` ``:62-77``): a decimal64 sum is the
# long sum kind over its unscaled int64 values (wrapping); a decimal128
# sum (``KEYED_SUM_DEC128``) adds a decimal64 or decimal128 input as
# 128-bit integers, wrapping mod 2^128 as the JAX limb sums do, into a
# ``[groups, 2]`` (hi, lo) plane; both merge FINAL buffers as themselves.

#: K9 aggregate kinds (csrc/keyed_agg.cu AggKind)
(KEYED_SUM_I64, KEYED_SUM_F64, KEYED_COUNT, KEYED_COUNT_ALL, KEYED_M2,
 KEYED_CHAN_MEAN, KEYED_CHAN_M2, KEYED_MIN, KEYED_MAX, KEYED_FIRST,
 KEYED_LAST, KEYED_FIRST_VALID, KEYED_LAST_VALID,
 KEYED_SUM_DEC128) = range(14)
#: the Chan merge kinds (an (n, mean) aux pair each)
_KEYED_CHAN = (KEYED_CHAN_MEAN, KEYED_CHAN_M2)
#: the kinds whose result is a double
_KEYED_F64 = (KEYED_SUM_F64, KEYED_M2) + _KEYED_CHAN
#: the row-order kinds, and the kinds whose result keeps the input's type
KEYED_PICK = (KEYED_FIRST, KEYED_LAST, KEYED_FIRST_VALID, KEYED_LAST_VALID)
KEYED_KEEPS_TYPE = (KEYED_MIN, KEYED_MAX) + KEYED_PICK
#: K9's kind of each buffer kind that keeps its input's type
KEYED_KINDS = {"min": KEYED_MIN, "max": KEYED_MAX, "first": KEYED_FIRST,
               "last": KEYED_LAST, "first_valid": KEYED_FIRST_VALID,
               "last_valid": KEYED_LAST_VALID}
#: launches of K9 (wrapper calls that launch it)
KEYED_LAUNCHES = 0
#: those of K9's launches with a min, max, first or last slot, and those
#: with a decimal sum slot (decimal64 or decimal128)
KEYED_MIN_MAX_LAUNCHES = 0
KEYED_DECIMAL_LAUNCHES = 0
MAX_KEYS = 8
MAX_AGGS = 32
SCAN_TILE = 1024
RADIX_TILE = 256

#: key type codes (csrc/keys.cuh KeyType)
KEY_CODES = {T.INT: 0, T.DATE: 0, T.LONG: 1, T.DOUBLE: 2, T.STRING: 3}
KEYED_KEY_TYPES = tuple(KEY_CODES)
_IN_CODES = {T.INT: 0, T.DATE: 0, T.LONG: 1, T.DOUBLE: 2, T.STRING: 3}
#: K9's input code of a decimal128 (a [rows, 2] plane)
_IN_DEC128 = 4


def _in_code(c: Optional[DeviceColumn], kind: int) -> int:
    """K9's input type code of an aggregate input (csrc/keyed_agg.cu
    InType): a decimal64 is its int64, a decimal128 its own; a count
    reads no data, so its input's is 0."""
    if c is None or kind in (KEYED_COUNT, KEYED_COUNT_ALL):
        return 0
    if isinstance(c.data_type, T.DecimalType):
        return _IN_DEC128 if c.data_type.is_decimal128 else _IN_CODES[T.LONG]
    return _IN_CODES.get(c.data_type, 0)
#: the inputs of the sum kinds and m2
_SUM_TYPES = (T.INT, T.LONG, T.DOUBLE)

_KEYED_SIGNATURES = {
    "srt_agg_groups": "ipppppqpppqpppp",
    "srt_agg_reduce": "i" + "p" * 10 + "qq" + "p" * 13,
}


def load_keyed_library():
    """Builds (first call) and binds ``csrc/keyed_agg.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("agg.keyed", "csrc/keyed_agg.cu",
                        lambda: load_cuda("keyed_agg.cu", _KEYED_SIGNATURES))


def _check_keyed(keys: Sequence[DeviceColumn], inputs, kinds,
                 aux=None) -> None:
    if not 1 <= len(keys) <= MAX_KEYS:
        raise NotImplementedError(f"K9 takes 1..{MAX_KEYS} keys")
    if len(inputs) != len(kinds) or len(kinds) > MAX_AGGS:
        raise ValueError(f"one input per kind, at most {MAX_AGGS}")
    for j, kind in enumerate(kinds):
        if kind in _KEYED_CHAN:
            pair = None if aux is None else aux[j]
            if pair is None or any(c.data_type != T.DOUBLE or
                                   c.row_count != keys[0].row_count
                                   for c in pair + (inputs[j],)):
                raise ValueError("a Chan merge kind needs double (n, mean) "
                                 "columns of the keys' rows beside its "
                                 "double input")
    n = keys[0].row_count
    for k in keys:
        if k.data_type not in KEY_CODES:
            raise NotImplementedError(
                f"a grouping key of {k.data_type} is not in the port yet "
                "(int, date, long, double and string keys are)")
        if k.row_count != n:
            raise ValueError("key columns of different lengths")
    for c, kind in zip(inputs, kinds):
        if kind in _KEYED_CHAN:
            continue
        if kind not in range(14):
            raise ValueError(f"unknown keyed aggregate kind {kind}")
        if kind == KEYED_COUNT_ALL:
            continue
        if c is None or c.row_count != n:
            raise ValueError("an aggregate input of the keys' rows is "
                             "needed")
        if kind in (KEYED_MIN, KEYED_MAX):
            if c.is_string:
                raise NotImplementedError(
                    "min/max over strings not on device yet (as on the JAX "
                    "device path)")
            if c.data_type not in MIN_MAX_TYPES:
                raise NotImplementedError(
                    f"min/max over {c.data_type} is not in the port yet")
        elif kind in KEYED_PICK:
            if c.data_type not in FIRST_LAST_TYPES:
                raise NotImplementedError(
                    f"first/last over {c.data_type} is not in the port yet")
        elif kind == KEYED_SUM_DEC128:
            if not isinstance(c.data_type, T.DecimalType):
                raise TypeError("a decimal128 sum needs a decimal input")
        elif isinstance(c.data_type, T.DecimalType):
            if kind != KEYED_COUNT and (kind != KEYED_SUM_I64 or
                                        c.data_type.is_decimal128):
                raise NotImplementedError(
                    f"K9's kind {kind} over {c.data_type} is not in the "
                    "port yet (its sums and counts are)")
        elif kind != KEYED_COUNT and c.data_type not in _SUM_TYPES:
            raise NotImplementedError(
                f"a sum or m2 over {c.data_type} is not in the port yet")
        if kind == KEYED_SUM_I64 and c.data_type == T.DOUBLE:
            raise TypeError("a long sum needs an int or long input")


def keyed_out_dtype(kind: int, c: Optional[DeviceColumn]) -> torch.dtype:
    """The dtype of K9's output for aggregate ``kind`` over ``c``: the
    input's own for min, max and first/last (int64 rows for a string),
    double for the double sums, m2 and the Chan merge, else int64."""
    if kind in KEYED_KEEPS_TYPE:
        return torch.int64 if c.is_string else c.data.dtype
    return torch.float64 if kind in _KEYED_F64 else torch.int64


def keyed_aggregate(keys: Sequence[DeviceColumn], inputs, kinds,
                    transfers, row_groups: bool = False,
                    aux=None) -> Tuple:
    """K9's wrapper: ``(group_rep, [(values, valid) per aggregate])``.
    ``group_rep[g]`` is the first row of group ``g``; groups are numbered
    in order of first appearance.  ``inputs[j]`` is the column aggregate
    ``j`` folds (None for a count of rows; a Chan merge kind's own column,
    the partial means or m2s); a first/last of a string column gives the
    row to gather (-1 for a null).  ``aux[j]`` is a Chan merge kind's ``(n,
    mean)`` columns (None elsewhere).  With ``row_groups`` a third element
    is each row's group id (int64), for K15d over the same groups."""
    _check_keyed(keys, inputs, kinds, aux)
    aux = list(aux) if aux is not None else [None] * len(kinds)
    device = keys[0].device
    if device.type == "cpu":
        return keyed_aggregate_plain(keys, inputs, kinds, transfers,
                                     row_groups, aux)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_keyed_library()
    n = keys[0].row_count
    size = table_size(n)

    def valid_of(c):
        return None if c is None or c.all_valid else \
            c.validity.contiguous().view(torch.uint8)

    def empty(count, dtype=torch.int64):
        return torch.empty(count, dtype=dtype, device=device)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        kdata = [k.data.contiguous() for k in keys]
        kvalid = [valid_of(k) for k in keys]
        # scratch is held by name until the launches are queued: a tensor
        # freed at once would let the next one reuse its memory
        hashes, slots, rep = empty(n), empty(size), empty(size)
        slot_of, rank = empty(n), empty(n + 1)
        tiles = empty(-(-n // SCAN_TILE))
        check_launch(lib.srt_agg_groups(
            len(keys), int32s([KEY_CODES[k.data_type] for k in keys]),
            int32s([int(k.is_string and k.offsets.dtype == torch.int64)
                    for k in keys]),
            pointers(kdata), pointers(kvalid),
            pointers([k.offsets for k in keys]), n, hashes.data_ptr(),
            slots.data_ptr(), rep.data_ptr(), size, slot_of.data_ptr(),
            rank.data_ptr(), tiles.data_ptr(), stream), "K9 groups")
        n_groups, = transfers.read_counts([rank[n]])
        outs = [empty((n_groups, 2) if kind == KEYED_SUM_DEC128
                      else n_groups, keyed_out_dtype(kind, c))
                for kind, c in zip(kinds, inputs)]
        valids = [empty(n_groups, torch.bool) for _ in kinds]
        group_rep = empty(n_groups)
        idata = [None if c is None else c.data.contiguous() for c in inputs]
        ivalid = [valid_of(c) for c in inputs]
        aux_n = [None if a is None else a[0].data.contiguous() for a in aux]
        aux_n_valid = [None if a is None else valid_of(a[0]) for a in aux]
        aux_mean = [None if a is None else a[1].data.contiguous()
                    for a in aux]
        aux_mean_valid = [None if a is None else valid_of(a[1])
                          for a in aux]
        gid, counts, seg = empty(n), empty(n_groups), empty(n_groups + 1)
        perm, perm_tmp = empty(n), empty(n)
        hist = empty(256 * -(-n // RADIX_TILE), torch.int32)
        digit_total = empty(256)
        group_tiles = empty(max(1, -(-n_groups // SCAN_TILE)))
        check_launch(lib.srt_agg_reduce(
            len(kinds), int32s(list(kinds)),
            int32s([_in_code(c, k) for c, k in zip(inputs, kinds)]),
            pointers(idata), pointers(ivalid), pointers(outs),
            pointers(valids), pointers(aux_n), pointers(aux_n_valid),
            pointers(aux_mean), pointers(aux_mean_valid), n, n_groups,
            slot_of.data_ptr(),
            rep.data_ptr(), rank.data_ptr(), gid.data_ptr(),
            group_rep.data_ptr(), counts.data_ptr(), seg.data_ptr(),
            perm.data_ptr(), perm_tmp.data_ptr(), hist.data_ptr(),
            digit_total.data_ptr(), group_tiles.data_ptr(), stream),
            "K9 reduce")
    global KEYED_LAUNCHES, KEYED_MIN_MAX_LAUNCHES, KEYED_DECIMAL_LAUNCHES
    KEYED_LAUNCHES += 1
    if any(k in KEYED_KEEPS_TYPE for k in kinds):
        KEYED_MIN_MAX_LAUNCHES += 1
    if any(isinstance(c.data_type, T.DecimalType) and k not in
           (KEYED_COUNT, KEYED_COUNT_ALL)
           for c, k in zip(inputs, kinds) if c is not None):
        KEYED_DECIMAL_LAUNCHES += 1
    if row_groups:
        return group_rep, list(zip(outs, valids)), gid
    return group_rep, list(zip(outs, valids))


_MASK64 = (1 << 64) - 1


def _signed64(x: int) -> int:
    x &= _MASK64
    return x - (1 << 64) if x >= 1 << 63 else x


_SEED = _signed64(0x9e3779b97f4a7c15)
_NULL_WORD = _signed64(0x5bd1e9955bd1e995)
_FMIX1 = _signed64(0xff51afd7ed558ccd)
_FMIX2 = _signed64(0xc4ceb9fe1a85ec53)
_FNV_BASIS = _signed64(0xcbf29ce484222325)
_FNV_PRIME = 0x100000001b3


def _shr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int64 bit patterns."""
    return (x >> k) & ((1 << (64 - k)) - 1)


def _fmix64(h: torch.Tensor) -> torch.Tensor:
    h = h ^ _shr(h, 33)
    h = h * _FMIX1
    h = h ^ _shr(h, 33)
    h = h * _FMIX2
    return h ^ _shr(h, 33)


def _padded_chars(c: DeviceColumn) -> torch.Tensor:
    """A string column as a zero-padded ``[rows, longest]`` byte matrix."""
    off = c.offsets.to(torch.int64)
    lens = off[1:] - off[:-1]
    width = int(lens.max()) if lens.numel() else 0
    pos = torch.arange(width, dtype=torch.int64, device=off.device)
    inside = pos[None, :] < lens[:, None]
    at = torch.where(inside, off[:-1, None] + pos[None, :], 0)
    data = c.data if c.data.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=off.device)
    return torch.where(inside, data[at], 0)


def key_words_plain(c: DeviceColumn) -> torch.Tensor:
    """int64 words of a fixed-width key column, as ``csrc/keys.cuh
    key_word`` forms them: a double's bits with -0.0 as 0.0 and every NaN
    as one quiet NaN."""
    if c.data_type.is_floating:
        x = torch.where(c.data == 0, 0.0, c.data)
        x = torch.where(torch.isnan(x), float("nan"), x)
        return x.contiguous().view(torch.int64)
    return c.data.to(torch.int64)


def key_hash_plain(keys: Sequence[DeviceColumn]) -> torch.Tensor:
    """Each row's key hash as ``csrc/keys.cuh row_hash`` computes it:
    fmix64 chained over the columns; a string's bytes folded by FNV-1a."""
    n = keys[0].row_count
    h = torch.full((n,), _SEED, dtype=torch.int64, device=keys[0].device)
    for c in keys:
        if c.is_string:
            off = c.offsets.to(torch.int64)
            lens = off[1:] - off[:-1]
            mat = _padded_chars(c).to(torch.int64)
            x = torch.full((n,), _FNV_BASIS, dtype=torch.int64,
                           device=h.device)
            for j in range(mat.shape[1]):
                x = torch.where(j < lens, (x ^ mat[:, j]) * _FNV_PRIME, x)
        else:
            x = key_words_plain(c)
        x = torch.where(c.validity, x, _NULL_WORD)
        h = _fmix64(h ^ x)
    return h


def _keys_equal(keys, mats, a: torch.Tensor, b: torch.Tensor
                ) -> torch.Tensor:
    """Row ``a[i]`` has the keys of row ``b[i]``: nulls equal nulls,
    strings equal byte by byte."""
    eq = torch.ones(a.shape[0], dtype=torch.bool, device=a.device)
    for c, mat in zip(keys, mats):
        va, vb = c.validity[a], c.validity[b]
        if mat is None:
            w = key_words_plain(c)
            same = w[a] == w[b]
        else:
            off = c.offsets.to(torch.int64)
            lens = off[1:] - off[:-1]
            same = (lens[a] == lens[b]) & (mat[a] == mat[b]).all(dim=1)
        eq &= (va == vb) & (~va | same)
    return eq


def group_rows_plain(keys: Sequence[DeviceColumn], transfers
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(group id per row, first row per group)`` as K9 groups them:
    linear probing in a table of ``table_size(rows)`` slots from
    ``key_hash_plain``, one probe step per round; a slot is claimed by the
    lowest row that reaches it empty.  With ``transfers`` None the group
    count is not read (K15d's plain version, whose kernel reads none)."""
    n = keys[0].row_count
    device = keys[0].device
    h = key_hash_plain(keys)
    size = table_size(n)
    mask = size - 1
    mats = [_padded_chars(c) if c.is_string else None for c in keys]
    owner = torch.full((size,), n, dtype=torch.int64, device=device)
    pos = h & mask
    slot_of = torch.empty(n, dtype=torch.int64, device=device)
    todo = torch.arange(n, dtype=torch.int64, device=device)
    while todo.numel():
        s = pos[todo]
        free = owner[s] == n
        owner.scatter_reduce_(0, s[free], todo[free], reduce="amin")
        first = owner[s]
        eq = (h[first] == h[todo]) & _keys_equal(keys, mats, first, todo)
        slot_of[todo[eq]] = s[eq]
        todo = todo[~eq]
        pos[todo] = (pos[todo] + 1) & mask
    first = owner[slot_of]
    is_first = first == torch.arange(n, dtype=torch.int64, device=device)
    flags = is_first.to(torch.int64)
    rank = torch.cumsum(flags, 0) - flags
    # the group count sizes K9's outputs: read through the gateway, so the
    # plain path counts the sync the kernel's path makes
    if transfers is not None:
        transfers.read_counts([flags.sum()])
    return rank[first], torch.nonzero(is_first).flatten()


def _chan_plain(gid: torch.Tensor, g: int, kind: int, c: DeviceColumn,
                n_col: DeviceColumn, mean_col: DeviceColumn) -> torch.Tensor:
    """The Chan merge of each group's (n, mean, m2) rows: its mean, or its
    m2 (rows whose n is null are left out; a null mean or m2 is 0)."""
    zeros = torch.zeros(g, dtype=torch.float64, device=gid.device)
    pres = n_col.validity
    ni = torch.where(pres, n_col.data, 0.0)
    mi = torch.where(pres & mean_col.validity, mean_col.data, 0.0)
    tot = zeros.clone().index_add_(0, gid, ni)
    wsum = zeros.clone().index_add_(0, gid, ni * mi)
    mean = torch.where(tot > 0, wsum / torch.where(tot > 0, tot, 1.0), 0.0)
    if kind == KEYED_CHAN_MEAN:
        return mean
    m2i = torch.where(pres & c.validity, c.data, 0.0)
    d = mi - mean[gid]
    return zeros.index_add_(0, gid, torch.where(pres, m2i + ni * d * d,
                                                0.0))


def _min_max_plain(gid: torch.Tensor, g: int, kind: int,
                   c: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each group's min or max of its present values (a double's in
    ``f64_order``, NaN kept apart); 0 and null with none."""
    is_min = kind == KEYED_MIN
    ident = INT64_MAX if is_min else INT64_MIN
    present = c.validity
    reduce = "amin" if is_min else "amax"

    def flags(m):
        return torch.zeros(g, dtype=torch.int64, device=gid.device) \
            .index_add_(0, gid, m.to(torch.int64)) > 0
    ok = flags(present)
    if c.data_type.is_floating:
        nan = present & torch.isnan(c.data)
        num = present & ~nan
        o = f64_order(c.data.contiguous().view(torch.int64))
        red = torch.full((g,), ident, dtype=torch.int64, device=gid.device) \
            .scatter_reduce_(0, gid, torch.where(num, o, ident), reduce)
        to_nan = flags(nan) & (~flags(num) if is_min else ok)
        word = torch.where(to_nan, _NAN_WORD, f64_order(red))
        return torch.where(ok, word, 0).view(torch.float64), ok
    x = c.data.to(torch.int64)
    red = torch.full((g,), ident, dtype=torch.int64, device=gid.device) \
        .scatter_reduce_(0, gid, torch.where(present, x, ident), reduce)
    return torch.where(ok, red, 0).to(c.data.dtype), ok


def _pick_plain(gid: torch.Tensor, g: int, kind: int,
                c: DeviceColumn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each group's first or last row (its first or last present row for
    the ``_valid`` kinds) in row order: the value there (0 where there is
    none), or for a string the row (-1 for a null)."""
    n = gid.shape[0]
    pos = torch.arange(n, dtype=torch.int64, device=gid.device)
    cond = c.validity if kind in (KEYED_FIRST_VALID, KEYED_LAST_VALID) \
        else torch.ones_like(c.validity)
    if kind in (KEYED_FIRST, KEYED_FIRST_VALID):
        idx = torch.full((g,), n, dtype=torch.int64, device=gid.device) \
            .scatter_reduce_(0, gid, torch.where(cond, pos, n), "amin")
        found = idx < n
    else:
        idx = torch.full((g,), -1, dtype=torch.int64, device=gid.device) \
            .scatter_reduce_(0, gid, torch.where(cond, pos, -1), "amax")
        found = idx >= 0
    at = idx.clamp(0, max(n - 1, 0))
    ok = found & c.validity[at]
    if c.is_string:
        return torch.where(ok, idx, -1), ok
    zero = torch.zeros((), dtype=c.data.dtype, device=gid.device)
    return torch.where(found, c.data[at], zero), ok


def keyed_aggregate_plain(keys: Sequence[DeviceColumn], inputs, kinds,
                          transfers, row_groups: bool = False,
                          aux=None) -> Tuple:
    """The plain PyTorch version of K9 (same groups, same order)."""
    _check_keyed(keys, inputs, kinds, aux)
    aux = list(aux) if aux is not None else [None] * len(kinds)
    gid, group_rep = group_rows_plain(keys, transfers)
    g = group_rep.shape[0]
    device = gid.device
    out = []
    for c, kind, pair in zip(inputs, kinds, aux):
        if kind in _KEYED_CHAN:
            out.append((_chan_plain(gid, g, kind, c, *pair),
                        torch.ones(g, dtype=torch.bool, device=device)))
            continue
        if kind in KEYED_PICK:
            out.append(_pick_plain(gid, g, kind, c))
            continue
        if kind in (KEYED_MIN, KEYED_MAX):
            out.append(_min_max_plain(gid, g, kind, c))
            continue
        if kind == KEYED_SUM_DEC128:
            hi, lo = (c.data[:, 0], c.data[:, 1]) if c.data.dim() == 2 \
                else (c.data >> 63, c.data)
            cnt = torch.zeros(g, dtype=torch.int64, device=device) \
                .index_add_(0, gid, c.validity.to(torch.int64))
            out.append((torch.stack(sum128_plain(hi, lo, c.validity, gid,
                                                 g), 1), cnt > 0))
            continue
        present = torch.ones_like(gid, dtype=torch.bool) \
            if kind == KEYED_COUNT_ALL else c.validity
        cnt = torch.zeros(g, dtype=torch.int64, device=device).index_add_(
            0, gid, present.to(torch.int64))
        ones = torch.ones(g, dtype=torch.bool, device=device)
        if kind in (KEYED_COUNT, KEYED_COUNT_ALL):
            out.append((cnt, ones))
            continue
        dt = torch.float64 if kind in _KEYED_F64 else torch.int64
        vals = torch.where(present, c.data.to(dt), 0)
        s = torch.zeros(g, dtype=dt, device=device).index_add_(0, gid, vals)
        if kind == KEYED_M2:
            # the mean, then the sum of squared deviations from it
            mean = torch.where(cnt > 0, s / cnt.clamp(min=1), 0.0)
            d = torch.where(present, vals - mean[gid], 0.0)
            out.append((torch.zeros(g, dtype=dt, device=device)
                        .index_add_(0, gid, d * d), ones))
            continue
        out.append((s, cnt > 0))
    if row_groups:
        return group_rep, out, gid
    return group_rep, out


# -- K15d: count(DISTINCT) ----------------------------------------------------
#
# ``count_distinct`` is K15d's wrapper: the number of distinct present
# values of one column (int, date, long, double or string) in each group,
# the groups given by a group id per row (K9's, ``keyed_aggregate(...,
# row_groups=True)``) or, with none, one group of every row.  A null value
# is not counted; -0.0 and 0.0 are one value and so are all NaNs; strings
# compare byte for byte (``csrc/keys.cuh``).  On CUDA columns it launches
# ``csrc/distinct.cu`` (a hash set over (group, value), a group's count
# raised by each first insertion); the output size is the group count the
# caller knows, so it reads nothing back.  ``count_distinct_plain`` groups
# the rows by (group, value) with K9's plain grouping and counts, per
# group, the (group, value) groups whose value is present.

#: launches of K15d (wrapper calls that launch it)
DISTINCT_LAUNCHES = 0


def load_distinct_library():
    """Builds (first call) and binds ``csrc/distinct.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build(
        "agg.distinct", "csrc/distinct.cu",
        lambda: load_cuda("distinct.cu",
                          {"srt_count_distinct": "iipppp" + "qq" + "ppqpp"}))


def _check_distinct(values: DeviceColumn, gid: Optional[torch.Tensor],
                    n_groups: int) -> None:
    if values.data_type not in KEY_CODES:
        raise NotImplementedError(
            f"count(DISTINCT) of {values.data_type} is not in the port yet "
            "(int, date, long, double and string values are)")
    if gid is None:
        if n_groups != 1:
            raise ValueError("without group ids there is one group")
        return
    if gid.dtype != torch.int64 or gid.shape != (values.row_count,):
        raise ValueError("one int64 group id per row is needed")
    if gid.device != values.device:
        raise ValueError("values and group ids lie on different devices")
    if n_groups < 1:
        raise ValueError("at least one group is needed")


def count_distinct(values: DeviceColumn, gid: Optional[torch.Tensor] = None,
                   n_groups: int = 1) -> torch.Tensor:
    """K15d's wrapper: int64 ``[n_groups]``, the distinct present values
    of each group (``gid[i]`` is row i's group; None: one group)."""
    _check_distinct(values, gid, n_groups)
    device = values.device
    if device.type == "cpu":
        return count_distinct_plain(values, gid, n_groups)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_distinct_library()
    n = values.row_count
    size = table_size(n)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # held by name until the launch is queued
        data = values.data.contiguous()
        valid = None if values.all_valid else \
            values.validity.contiguous().view(torch.uint8)
        offsets = values.offsets.contiguous() if values.is_string else None
        groups = None if gid is None else gid.contiguous()
        hashes = torch.empty(n, dtype=torch.int64, device=device)
        slots = torch.empty(size, dtype=torch.int64, device=device)
        counts = torch.empty(n_groups, dtype=torch.int64, device=device)
        check_launch(lib.srt_count_distinct(
            KEY_CODES[values.data_type],
            int(values.is_string and offsets.dtype == torch.int64),
            data.data_ptr(), None if valid is None else valid.data_ptr(),
            None if offsets is None else offsets.data_ptr(),
            None if groups is None else groups.data_ptr(), n, n_groups,
            hashes.data_ptr(), slots.data_ptr(), size, counts.data_ptr(),
            stream), "K15d (count distinct)")
    global DISTINCT_LAUNCHES
    DISTINCT_LAUNCHES += 1
    return counts


def count_distinct_plain(values: DeviceColumn,
                         gid: Optional[torch.Tensor] = None,
                         n_groups: int = 1) -> torch.Tensor:
    """The plain PyTorch version of K15d."""
    _check_distinct(values, gid, n_groups)
    device = values.device
    n = values.row_count
    counts = torch.zeros(n_groups, dtype=torch.int64, device=device)
    if n == 0:
        return counts
    g = torch.zeros(n, dtype=torch.int64, device=device) if gid is None \
        else gid
    group_col = DeviceColumn(g, torch.ones(n, dtype=torch.bool,
                                           device=device), T.LONG)
    _pair, first = group_rows_plain([group_col, values], None)
    first = first[values.validity[first]]
    return counts.index_add_(0, g[first], torch.ones_like(first))


# -- K15: collect_list and collect_set -------------------------------------
#
# ``collect`` is K15's wrapper (``csrc/collect.cu``): the present values of
# each group into an array column of ``n_groups`` rows, every row valid
# (an empty group gives ``[]``).  List mode keeps every present row in row
# order; set mode each distinct (group, value) once, at its least row, in
# first-seen order.  On CUDA columns it launches the count (hash set in
# set mode, per-group counts, their scan), reads the total through the
# gateway (one counted sync) and launches the write (a stable radix sort
# by group, the gather).  ``collect_plain`` gives the same planes with
# stable ``torch.sort``s.

#: launches of K15 in list and in set mode (wrapper calls that launch it)
COLLECT_LAUNCHES = 0
COLLECT_SET_LAUNCHES = 0
#: the element types K15 collects (a string, binary, decimal128 or nested
#: element goes to the JAX package's host tier, and is refused here)
COLLECT_TYPES = (T.INT, T.DATE, T.LONG, T.DOUBLE, T.BOOLEAN)
_COLLECT_SIGNATURES = {
    "srt_collect_count": "iippp" + "qqi" + "ppqpppp" + "p",
    "srt_collect_write": "ippp" + "qqq" + "pppppp" + "p",
}


def collects(dt: T.DataType) -> bool:
    """K15 takes elements of ``dt``: int, date, long, double, boolean or
    decimal64."""
    return dt in COLLECT_TYPES or (isinstance(dt, T.DecimalType) and
                                   not dt.is_decimal128)


def load_collect_library():
    """Builds (first call) and binds ``csrc/collect.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("agg.collect", "csrc/collect.cu",
                        lambda: load_cuda("collect.cu", _COLLECT_SIGNATURES))


def _check_collect(values: DeviceColumn, gid: Optional[torch.Tensor],
                   n_groups: int) -> None:
    if values.is_string or values.is_array or not collects(values.data_type):
        raise NotImplementedError(
            f"collect_list/collect_set of {values.data_type} is not in the "
            "port (of int, date, long, double, boolean and decimal64 is; "
            "the JAX package runs the others on its host tier)")
    if gid is None:
        if n_groups != 1:
            raise ValueError("without group ids there is one group")
        return
    if gid.dtype != torch.int64 or gid.shape != (values.row_count,):
        raise ValueError("one int64 group id per row is needed")
    if gid.device != values.device:
        raise ValueError("values and group ids lie on different devices")
    if n_groups < 0:
        raise ValueError("a negative group count")


def _empty_arrays(values: DeviceColumn, n_groups: int) -> DeviceColumn:
    device = values.device
    return DeviceColumn(values.data[:0].clone(),
                        torch.ones(n_groups, dtype=torch.bool, device=device),
                        T.ArrayType(values.data_type, contains_null=False),
                        all_valid=True,
                        offsets=torch.zeros(n_groups + 1, dtype=torch.int64,
                                            device=device))


def collect(values: DeviceColumn, gid: Optional[torch.Tensor] = None,
            n_groups: int = 1, distinct: bool = False,
            transfers=None) -> DeviceColumn:
    """K15's wrapper: an array column of ``n_groups`` rows, row ``g`` the
    present values of the rows with ``gid == g`` (None: one group) in
    row order, each distinct value once at its first row with
    ``distinct``.  The total is read through ``transfers``."""
    _check_collect(values, gid, n_groups)
    device = values.device
    if device.type == "cpu":
        return collect_plain(values, gid, n_groups, distinct, transfers)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if transfers is None:
        raise ValueError("K15 reads its total through the transfer gateway")
    n = values.row_count
    if n_groups == 0:
        return _empty_arrays(values, 0)
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_collect_library()
    data = values.data.contiguous()
    width = data.element_size()
    tiles = max(1, -(-n // RADIX_TILE))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # held by name until the launches are queued
        raw = data.view(torch.uint8) if data.dtype == torch.bool else data
        valid = None if values.all_valid else \
            values.validity.contiguous().view(torch.uint8)
        groups = None if gid is None else gid.contiguous()
        words = torch.empty(max(n, 1), dtype=torch.int64, device=device)
        size = table_size(n) if distinct else 0
        slots = torch.empty(max(size, 1), dtype=torch.int64, device=device) \
            if distinct else None
        slot_of = torch.empty(max(n, 1), dtype=torch.int64, device=device) \
            if distinct else None
        keep = torch.empty(max(n, 1), dtype=torch.uint8, device=device)
        offsets = torch.empty(n_groups + 1, dtype=torch.int64, device=device)
        scratch = torch.empty(max(1, -(-n_groups // SCAN_TILE)),
                              dtype=torch.int64, device=device)
        check_launch(lib.srt_collect_count(
            width, int(values.data_type == T.DOUBLE), raw.data_ptr(),
            None if valid is None else valid.data_ptr(),
            None if groups is None else groups.data_ptr(), n, n_groups,
            int(distinct), words.data_ptr(),
            None if slots is None else slots.data_ptr(), size,
            None if slot_of is None else slot_of.data_ptr(),
            keep.data_ptr(), offsets.data_ptr(), scratch.data_ptr(),
            stream), "K15 count")
        total, = transfers.read_counts([offsets[n_groups]])
        out = torch.empty(total, dtype=data.dtype, device=device)
        perm = torch.empty(max(n, 1), dtype=torch.int64, device=device)
        perm_tmp = torch.empty(max(n, 1), dtype=torch.int64, device=device)
        hist = torch.empty(256 * tiles, dtype=torch.int32, device=device)
        digit_total = torch.empty(256, dtype=torch.int64, device=device)
        check_launch(lib.srt_collect_write(
            width, raw.data_ptr(),
            None if groups is None else groups.data_ptr(), keep.data_ptr(),
            n, n_groups, total, words.data_ptr(), perm.data_ptr(),
            perm_tmp.data_ptr(), hist.data_ptr(), digit_total.data_ptr(),
            (out.view(torch.uint8) if out.dtype == torch.bool
             else out).data_ptr(), stream), "K15 write")
    global COLLECT_LAUNCHES, COLLECT_SET_LAUNCHES
    if distinct:
        COLLECT_SET_LAUNCHES += 1
    else:
        COLLECT_LAUNCHES += 1
    return DeviceColumn(out, torch.ones(n_groups, dtype=torch.bool,
                                        device=device),
                        T.ArrayType(values.data_type, contains_null=False),
                        all_valid=True, offsets=offsets)


def collect_words_plain(values: DeviceColumn) -> torch.Tensor:
    """int64 words that equal values share (a double's -0.0 as 0.0, every
    NaN as one), as ``csrc/collect.cu`` makes them."""
    d = values.data
    if d.dtype == torch.float64:
        bits = d.view(torch.int64)
        bits = torch.where(d == 0.0, 0, bits)
        return torch.where(torch.isnan(d), _NAN_WORD, bits)
    return d.to(torch.int64)


def collect_plain(values: DeviceColumn, gid: Optional[torch.Tensor] = None,
                  n_groups: int = 1, distinct: bool = False,
                  transfers=None) -> DeviceColumn:
    """The plain PyTorch version of K15 (it reads the total through the
    gateway, as the kernel does, when one is given)."""
    _check_collect(values, gid, n_groups)
    device = values.device
    n = values.row_count
    if n_groups == 0:
        return _empty_arrays(values, 0)
    g = torch.zeros(n, dtype=torch.int64, device=device) if gid is None \
        else gid
    rows = torch.nonzero(values.validity).reshape(-1)
    if distinct and rows.numel():
        # stable sorts: by word, then by group; the first row of each
        # (group, word) run is its least row
        w = collect_words_plain(values)[rows]
        order = torch.sort(w, stable=True).indices
        order = order[torch.sort(g[rows][order], stable=True).indices]
        rw, rg = w[order], g[rows][order]
        first = torch.ones_like(rw, dtype=torch.bool)
        first[1:] = (rw[1:] != rw[:-1]) | (rg[1:] != rg[:-1])
        rows = torch.sort(rows[order][first]).values
    # the kept rows by group, in row order within a group
    rows = rows[torch.sort(g[rows], stable=True).indices]
    counts = torch.bincount(g[rows], minlength=n_groups)
    offsets = torch.zeros(n_groups + 1, dtype=torch.int64, device=device)
    torch.cumsum(counts, 0, out=offsets[1:])
    if transfers is not None and n:
        transfers.read_counts([offsets[n_groups]])
    return DeviceColumn(values.data[rows], torch.ones(
        n_groups, dtype=torch.bool, device=device),
        T.ArrayType(values.data_type, contains_null=False), all_valid=True,
        offsets=offsets)
