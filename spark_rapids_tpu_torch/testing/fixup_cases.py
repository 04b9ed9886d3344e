"""Inputs for K14c (``ops/window_ops.py running_fixup``): one sorted stream
of window rows cut into chunks, made from a seed, for the card tests and
``chip_smoke.py`` phase 2l, which hold the kernel against its plain
version chunk by chunk.

The stream's partition keys are an int (null in one group), a string of
0 to 40 bytes (null in some groups) and a long; its order key is a
double drawn from few values (peers cross chunk boundaries) with NaN,
+-inf, -0.0, 0.0 and nulls.  The chunks are ``sizes`` long (0 and 1
rows first), laid out so that the 1-row chunk starts a group that the
next chunk continues whole (K14c's ``L == n`` case), the chunk after it
begins with a new group (a boundary at row 0), and the last two chunks
meet inside one group and one peer run.  The window columns are random
values of each kind K14c carries: row_number, rank and dense_rank
(int32), double sums, counts, double minima and maxima (``KINDS_A``),
long sums, long minima and maxima and int minima (``KINDS_B``), doubles
with NaN, +-inf, -0.0 and nulls."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import window_ops as W

KINDS_A = (W.FIX_ROW_NUMBER, W.FIX_RANK, W.FIX_DENSE_RANK, W.FIX_SUM,
           W.FIX_COUNT, W.FIX_MIN, W.FIX_MAX)
TYPES_A = (T.INT, T.INT, T.INT, T.DOUBLE, T.LONG, T.DOUBLE, T.DOUBLE)
KINDS_B = (W.FIX_SUM, W.FIX_MIN, W.FIX_MAX, W.FIX_MIN)
TYPES_B = (T.LONG, T.LONG, T.LONG, T.INT)
#: the chunk sizes of phase 2l
SIZES = (0, 1, 1000, (1 << 20) + 3, 1000)

_SCHEMA = T.StructType([T.StructField("i", T.INT),
                        T.StructField("s", T.STRING),
                        T.StructField("l", T.LONG),
                        T.StructField("o", T.DOUBLE)])


def _doubles(rng, n):
    d = rng.standard_normal(n) * 100
    u = rng.random(n)
    d = np.where(u < 0.01, np.nan, d)
    d = np.where((u >= 0.01) & (u < 0.015), np.inf, d)
    d = np.where((u >= 0.015) & (u < 0.02), -np.inf, d)
    return np.where((u >= 0.02) & (u < 0.03), -0.0, d)


def _group_sizes(rng, sizes: Sequence[int]) -> List[int]:
    """Groups: one over the 1-row chunk and the next chunk whole, then
    runs of 1 to 40 rows from the next chunk's first row, one group over
    the last chunk boundary."""
    total = sum(sizes)
    head = sizes[0] + sizes[1] + sizes[2]
    out = [head]
    tail_start = total - sizes[-1] - 300
    pos = head
    while pos < tail_start:
        k = int(rng.integers(1, 41))
        out.append(k)
        pos += k
    out.append(total - pos)
    return out


def stream(rng, device, transfers, sizes: Sequence[int] = SIZES):
    """``(partition keys, order keys, window columns of KINDS_A, those of
    KINDS_B)`` over every row of the chunks, sorted by the keys."""
    groups = _group_sizes(rng, sizes)
    n = sum(groups)
    g = np.repeat(np.arange(len(groups)), groups)
    words = [""] + ["x" * k for k in (1, 7, 8, 15, 40)] + ["日本", "é"]
    s_of = [None if k % 7 == 3 else
            words[k % len(words)] + str(k) * int(k % 3)
            for k in range(len(groups))]
    i_of = [None if k == 1 else int(k * 3 % 11) for k in range(len(groups))]
    l_of = np.arange(len(groups), dtype=np.int64) * 3_000_000_007
    # order keys: few values, in runs, so peers cross the chunk bounds
    o_vals = np.array([np.nan, -np.inf, -1.5, -0.0, 0.0, 2.0, np.inf])
    o = np.repeat(o_vals[rng.integers(0, len(o_vals), n // 50 + 1)],
                  50)[:n]
    o_null = np.repeat(rng.random(n // 50 + 1) < 0.1, 50)[:n]
    host = batch_from_pydict({
        "i": [i_of[k] for k in g], "s": [s_of[k] for k in g],
        "l": l_of[g],
        "o": [None if z else float(x) for x, z in zip(o, o_null)]},
        _SCHEMA)
    cols = transfers.upload_batch(host).columns
    pkeys, okeys = cols[:3], cols[3:]

    def column(dt):
        valid = torch.from_numpy(rng.random(n) > 0.15).to(device)
        if dt == T.DOUBLE:
            data = torch.from_numpy(_doubles(rng, n))
        elif dt == T.LONG:
            data = torch.from_numpy(rng.integers(-1000, 1000, n) *
                                    3_000_000_000)
        else:
            data = torch.from_numpy(rng.integers(0, 1 << 20, n)
                                    .astype(np.int32))
        return DeviceColumn(data.to(device), valid, dt)

    def ranks():
        return DeviceColumn(torch.from_numpy(
            rng.integers(1, 1 << 20, n).astype(np.int32)).to(device),
            torch.ones(n, dtype=torch.bool, device=device), T.INT, True)
    outs_a = [ranks() if k in W.FIX_RANKING else column(dt)
              for k, dt in zip(KINDS_A, TYPES_A)]
    outs_b = [column(dt) for dt in TYPES_B]
    return pkeys, okeys, outs_a, outs_b


def chunks(columns: Sequence[DeviceColumn], transfers,
           sizes: Sequence[int] = SIZES) -> List[List[DeviceColumn]]:
    """``columns`` cut into chunks of ``sizes`` rows."""
    from spark_rapids_tpu_torch.ops.batch_ops import slice_columns
    out, start = [], 0
    for k in sizes:
        out.append(slice_columns(columns, start, k, transfers, exact=True)
                   if k else [DeviceColumn(c.data[:0], c.validity[:0],
                                           c.data_type, c.all_valid,
                                           None if c.offsets is None else
                                           c.offsets[:1]) for c in columns])
        start += k
    return out


def run_stream(fixup, pkeys, okeys, kinds, outs, transfers,
               sizes: Sequence[int] = SIZES) -> List[Tuple]:
    """``fixup`` (``running_fixup`` or its plain version) over each chunk
    in turn, the carry handed on: ``[(fixed columns, carry)]``."""
    keys = chunks(list(pkeys) + list(okeys), transfers, sizes)
    wins = chunks(outs, transfers, sizes)
    npk = len(pkeys)
    carry, got = None, []
    for k, cols, win in zip(sizes, keys, wins):
        fixed, carry = fixup(cols[:npk], cols[npk:], kinds, win, k, carry,
                             transfers)
        got.append((fixed, carry))
    return got
