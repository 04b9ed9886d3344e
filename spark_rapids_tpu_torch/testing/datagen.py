"""Seeded random columns (a copy of the generators of
``spark_rapids_tpu/testing/datagen.py`` that ScaleTest uses: ``LongGen``,
``IntegerGen``, ``DoubleGen``, ``StringGen``, ``DateGen``, ``gen_batch``
and ``gen_df``, ``:25-170, 240-255``).

For the same seed they give the JAX generators' values: one
``np.random.default_rng(seed)`` is shared by the columns in order, and
each generator draws from it what the JAX one draws, in the same order
(the values, then the specials, then the null mask).  The JAX generators
build a Python list per row; these build the numpy planes of a
``HostColumn`` directly, with one draw where the JAX code draws in a loop
(``rng.integers(0, k, size=m)`` gives the values that ``m`` scalar draws
of ``rng.integers(0, k)`` or ``rng.choice`` of ``k`` items give, and one
draw of every string's characters the values of a ``rng.choice`` a
row; ``tests/test_torch_scaletest.py`` holds each generator to the JAX
one's values)."""

from __future__ import annotations

import datetime
import string as _string
from typing import Optional, Sequence, Tuple

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
from spark_rapids_tpu_torch.columnar.column import INT32_CHARS, HostColumn


class DataGen:
    data_type: T.DataType = T.INT

    def __init__(self, nullable: bool = True, null_ratio: float = 0.08):
        self.nullable = nullable
        self.null_ratio = null_ratio if nullable else 0.0

    def _planes(self, n: int, rng: np.random.Generator):
        """``(data, offsets or None)`` of ``n`` values."""
        raise NotImplementedError

    def generate(self, n: int, rng: np.random.Generator) -> HostColumn:
        data, offsets = self._planes(n, rng)
        validity = None
        if self.null_ratio > 0:
            validity = ~(rng.random(n) < self.null_ratio)
        return HostColumn(data, validity, self.data_type, offsets)


class _IntegralGen(DataGen):
    lo: int = 0
    hi: int = 0
    specials: Tuple[int, ...] = ()

    def __init__(self, nullable=True, null_ratio=0.08, special_ratio=0.05,
                 min_val: Optional[int] = None,
                 max_val: Optional[int] = None):
        super().__init__(nullable, null_ratio)
        self.min_val = self.lo if min_val is None else min_val
        self.max_val = self.hi if max_val is None else max_val
        self.special_ratio = special_ratio

    def _planes(self, n, rng):
        vals = rng.integers(self.min_val, self.max_val, size=n,
                            endpoint=True, dtype=np.int64)
        if self.specials and self.special_ratio > 0:
            hits = np.flatnonzero(rng.random(n) < self.special_ratio)
            vals[hits] = np.array(self.specials, dtype=np.int64)[
                rng.integers(0, len(self.specials), size=len(hits))]
        return vals.astype(self.data_type.np_dtype), None


class IntegerGen(_IntegralGen):
    data_type = T.INT
    lo, hi = -(1 << 31), (1 << 31) - 1
    specials = (-(1 << 31), (1 << 31) - 1, 0)


class LongGen(_IntegralGen):
    data_type = T.LONG
    lo, hi = -(1 << 63), (1 << 63) - 1
    specials = (-(1 << 63), (1 << 63) - 1, 0)


class DoubleGen(DataGen):
    data_type = T.DOUBLE
    specials = (float("nan"), float("inf"), float("-inf"), -0.0, 0.0)

    def __init__(self, nullable=True, null_ratio=0.08, special_ratio=0.05,
                 no_nans: bool = False):
        super().__init__(nullable, null_ratio)
        self.special_ratio = special_ratio
        self.no_nans = no_nans

    def _planes(self, n, rng):
        out = rng.standard_normal(n) * 1e6
        specials = np.array([s for s in self.specials
                             if not (self.no_nans and s != s)])
        hits = np.flatnonzero(rng.random(n) < self.special_ratio)
        out[hits] = specials[rng.integers(0, len(specials), size=len(hits))]
        return out, None


class StringGen(DataGen):
    """Random strings from a charset; empty strings and unicode appear as
    specials in 3% of rows."""

    data_type = T.STRING
    SPECIALS = ("", "句読点テスト", "émoji🎉", " spaced  ")

    def __init__(self, nullable=True, null_ratio=0.08, min_len=0,
                 max_len=20,
                 charset: str = _string.ascii_letters + _string.digits,
                 unicode_specials: bool = True):
        super().__init__(nullable, null_ratio)
        self.min_len = min_len
        self.max_len = max_len
        self.charset = charset
        self.unicode_specials = unicode_specials

    def _planes(self, n, rng):
        lens = rng.integers(self.min_len, self.max_len, size=n,
                            endpoint=True)
        # every row's characters in one draw (the JAX generator's
        # rng.choice a row draws the same indices)
        picks = rng.integers(0, len(self.charset), size=int(lens.sum()))
        encoded = [ch.encode("utf-8") for ch in self.charset]
        widths = np.array([len(b) for b in encoded], dtype=np.int64)
        table = np.frombuffer(b"".join(encoded), dtype=np.uint8)
        before = np.cumsum(widths) - widths
        # the drawn characters' bytes, row after row
        char_bytes = widths[picks]
        within = np.arange(int(char_bytes.sum())) - np.repeat(
            np.cumsum(char_bytes) - char_bytes, char_bytes)
        drawn = table[np.repeat(before[picks], char_bytes) + within]
        row_bytes = np.bincount(np.repeat(np.arange(n), lens),
                                weights=char_bytes, minlength=n
                                ).astype(np.int64)
        kind = np.full(n, -1)
        if self.unicode_specials:
            hits = np.flatnonzero(rng.random(n) < 0.03)
            kind[hits] = rng.integers(0, len(self.SPECIALS), size=len(hits))
        special = [s.encode("utf-8") for s in self.SPECIALS]
        spec_len = np.array([len(b) for b in special], dtype=np.int64)
        final = np.where(kind >= 0, spec_len[np.maximum(kind, 0)],
                         row_bytes)
        offsets = np.zeros(n + 1, dtype=np.int64)
        np.cumsum(final, out=offsets[1:])
        chars = np.empty(int(offsets[-1]), dtype=np.uint8)
        # the rows that keep their drawn characters
        row_of_byte = np.repeat(np.arange(n), row_bytes)
        kept = kind[row_of_byte] < 0
        at = np.arange(len(drawn)) - np.repeat(
            np.cumsum(row_bytes) - row_bytes, row_bytes)
        chars[offsets[row_of_byte[kept]] + at[kept]] = drawn[kept]
        for k, raw in enumerate(special):
            rows = np.flatnonzero(kind == k)
            if len(rows) and raw:
                chars[(offsets[rows][:, None] +
                       np.arange(len(raw))).reshape(-1)] = np.tile(
                    np.frombuffer(raw, dtype=np.uint8), len(rows))
        if offsets[-1] <= INT32_CHARS:
            offsets = offsets.astype(np.int32)
        return chars, offsets


class DateGen(DataGen):
    data_type = T.DATE

    def __init__(self, nullable=True, null_ratio=0.08,
                 start=datetime.date(1940, 1, 1),
                 end=datetime.date(2100, 1, 1)):
        super().__init__(nullable, null_ratio)
        self.start = start
        self.days = (end - start).days

    def _planes(self, n, rng):
        days = rng.integers(0, self.days, n) + T.date_days(self.start)
        return days.astype(np.int32), None


def gen_batch(gens: Sequence[Tuple[str, DataGen]], n: int,
              seed: int = 0) -> HostColumnarBatch:
    """``(name, generator)`` pairs -> a host batch of ``n`` rows."""
    rng = np.random.default_rng(seed)
    cols = [g.generate(n, rng) for _nm, g in gens]
    return HostColumnarBatch(cols, n, [nm for nm, _g in gens])


def gen_df(session, gens: Sequence[Tuple[str, DataGen]], length: int = 2048,
           seed: int = 0, num_partitions: int = 1):
    """The reference's ``gen_df(spark, gen_list, length)``."""
    return session.create_dataframe(gen_batch(gens, length, seed),
                                    num_partitions=num_partitions)
