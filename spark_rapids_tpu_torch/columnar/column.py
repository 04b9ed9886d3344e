"""Host and device columns (the analog of ``spark_rapids_tpu/columnar/
column.py``).

A device column is a torch data tensor plus a bool validity tensor, both
sized to the exact row count.  The JAX package pads rows to power-of-two
buckets (``bucket_rows``) and defers row counts (``DeferredCount``) because
XLA wants static shapes and a TPU sync is slow; on a CUDA card neither
holds, so neither is carried over.

A string column is Arrow's layout, as cuDF keeps it: ``offsets`` (int32, or
int64 when the chars pass 2**31 bytes) of ``row_count + 1`` entries, and a
uint8 ``data`` plane of chars; row ``i`` is ``data[offsets[i]:offsets[i +
1]]`` and a null row has length 0.  ``offsets[0]`` is 0, and the chars plane
may run past ``offsets[-1]`` (a front slice or a compaction keeps the
plane it had).  The JAX package's padded ``uint8[bucket, width]`` planes
are a static-shape workaround and are not used.

A decimal column holds its unscaled values (``columnar/column.py:15-16``
of the JAX package): int64 for decimal64, an int64 ``[rows, 2]`` plane of
(hi word, lo word bits) for decimal128, on the host and on the card;
``to_pylist`` gives ``decimal.Decimal`` values, as the JAX package's rows
do."""

from __future__ import annotations

import decimal
from typing import List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

#: the largest chars plane int32 offsets address
INT32_CHARS = 2 ** 31 - 1


def is_decimal128(dt: T.DataType) -> bool:
    return isinstance(dt, T.DecimalType) and dt.is_decimal128


def unscaled_ints(data) -> List[int]:
    """Python ints of unscaled decimal values: an int64 array (decimal64)
    or a ``[rows, 2]`` (hi, lo bits) array (decimal128), exactly."""
    data = np.asarray(data)
    if data.ndim == 1:
        return data.tolist()
    return [(hi << 64) | (lo & _MASK64) for hi, lo in data.tolist()]


#: a context wide enough that no decimal of 38 digits rounds
EXACT = decimal.Context(prec=80)


def decimal_value(unscaled: int, scale: int) -> decimal.Decimal:
    """The ``Decimal`` of an unscaled integer at ``scale``, exactly."""
    return decimal.Decimal(unscaled).scaleb(-scale, EXACT)


def unscaled_of(value, scale: int) -> int:
    """The unscaled integer of a Decimal, int or float at ``scale`` (a
    float through its decimal repr), rounded HALF_UP."""
    d = value if isinstance(value, decimal.Decimal) else \
        decimal.Decimal(repr(value) if isinstance(value, float) else value)
    return int(d.scaleb(scale, EXACT).to_integral_value(
        decimal.ROUND_HALF_UP, EXACT))


def words_of(v: int) -> tuple:
    """A Python int below 2^127 in magnitude as signed (hi, lo) words."""
    lo = v & _MASK64
    return v >> 64, lo - (1 << 64) if lo >= 1 << 63 else lo


def decimal128_words(values: Sequence[int]) -> np.ndarray:
    """An int64 ``[rows, 2]`` (hi, lo bits) array of Python ints."""
    return np.array([words_of(v) for v in values],
                    dtype=np.int64).reshape(-1, 2)


_MASK64 = (1 << 64) - 1


def empty_data(n: int, dt: T.DataType, device) -> torch.Tensor:
    """An uninitialised data plane of ``n`` rows of fixed-width type
    ``dt`` (``[n, 2]`` for a decimal128)."""
    return torch.empty((n, 2) if is_decimal128(dt) else n,
                       dtype=dt.torch_dtype, device=device)


class HostColumn:
    """numpy data plane plus an optional bool validity plane (None: no
    nulls).  Values under a null slot are unspecified.  A string column
    also holds ``offsets``; its ``data`` is the chars plane."""

    __slots__ = ("data", "validity", "data_type", "offsets")

    def __init__(self, data: np.ndarray, validity: Optional[np.ndarray],
                 data_type: T.DataType,
                 offsets: Optional[np.ndarray] = None):
        data = np.asarray(data)
        wide = is_decimal128(data_type)
        if data.ndim != (2 if wide else 1) or \
                (wide and data.shape[1] != 2):
            raise ValueError(f"a {data_type} column's data must be "
                             f"{'[rows, 2]' if wide else '1-D'}, got "
                             f"{data.shape}")
        if isinstance(data_type, T.StringType):
            if offsets is None:
                raise ValueError("a string column needs offsets")
            offsets = np.asarray(offsets)
            if offsets.dtype not in (np.int32, np.int64) or \
                    offsets.ndim != 1 or len(offsets) < 1:
                raise TypeError("string offsets must be a 1-D int32 or "
                                "int64 array of rows + 1 entries")
            if data.dtype != np.uint8:
                raise TypeError("string chars must be uint8")
            n = len(offsets) - 1
        else:
            if offsets is not None:
                raise ValueError(f"a {data_type} column has no offsets")
            if data.dtype != data_type.np_dtype:
                data = data.astype(data_type.np_dtype)
            n = data.shape[0]
        if validity is not None:
            validity = np.asarray(validity, dtype=np.bool_)
            if validity.shape != (n,):
                raise ValueError(f"validity shape {validity.shape} does not "
                                 f"match {n} rows")
        self.data = data
        self.validity = validity
        self.data_type = data_type
        self.offsets = offsets

    @staticmethod
    def from_strings(values: Sequence) -> "HostColumn":
        """A string column of ``str`` and ``None`` values (Arrow's layout:
        int32 offsets unless the chars pass 2**31 bytes)."""
        encoded = [b"" if v is None else str(v).encode("utf-8")
                   for v in values]
        n = len(encoded)
        lengths = np.fromiter(map(len, encoded), dtype=np.int64, count=n)
        offsets = np.zeros(n + 1, dtype=np.int64 if lengths.sum() >
                           INT32_CHARS else np.int32)
        np.cumsum(lengths, out=offsets[1:])
        chars = np.frombuffer(b"".join(encoded), dtype=np.uint8).copy()
        valid = np.fromiter((v is not None for v in values),
                            dtype=np.bool_, count=n)
        return HostColumn(chars, None if valid.all() else valid, T.STRING,
                          offsets)

    def __len__(self) -> int:
        if self.offsets is not None:
            return int(self.offsets.shape[0]) - 1
        return int(self.data.shape[0])

    def slice(self, start: int, length: int) -> "HostColumn":
        end = start + length
        valid = None if self.validity is None else self.validity[start:end]
        if self.offsets is None:
            return HostColumn(self.data[start:end], valid, self.data_type)
        offs = self.offsets[start:end + 1]
        lo, hi = int(offs[0]), int(offs[-1])
        return HostColumn(self.data[lo:hi], valid, self.data_type,
                          offs - offs.dtype.type(lo))

    def to_pylist(self) -> List:
        """Python values: a date as ``datetime.date``, as the JAX
        package's rows give it."""
        if isinstance(self.data_type, T.DateType):
            values = [T.days_date(d) for d in self.data.tolist()]
        elif isinstance(self.data_type, T.DecimalType):
            values = [decimal_value(u, self.data_type.scale)
                      for u in unscaled_ints(self.data)]
        elif self.offsets is None:
            values = self.data.tolist()
        else:
            raw = self.data.tobytes()
            offs = self.offsets.tolist()
            values = [raw[offs[i]:offs[i + 1]].decode("utf-8")
                      for i in range(len(offs) - 1)]
        if self.validity is None:
            return values
        return [v if ok else None
                for v, ok in zip(values, self.validity.tolist())]


class DeviceColumn:
    """torch data plane plus a bool validity plane of the row count (and,
    for a string, its offsets).  ``all_valid`` marks a column known to hold
    no null (its validity plane is all true), so a kernel may skip reading
    the plane."""

    __slots__ = ("data", "validity", "data_type", "all_valid", "offsets")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 data_type: T.DataType, all_valid: bool = False,
                 offsets: Optional[torch.Tensor] = None):
        if isinstance(data_type, T.StringType):
            if offsets is None or offsets.dtype not in (torch.int32,
                                                        torch.int64) \
                    or offsets.dim() != 1 or offsets.shape[0] < 1:
                raise TypeError("a string column needs int32 or int64 "
                                "offsets of rows + 1 entries")
            if data.dtype != torch.uint8 or data.dim() != 1:
                raise TypeError("string chars must be a 1-D uint8 tensor")
            n = offsets.shape[0] - 1
        else:
            if offsets is not None:
                raise ValueError(f"a {data_type} column has no offsets")
            if data.dtype != data_type.torch_dtype:
                raise TypeError(f"{data_type} column needs "
                                f"{data_type.torch_dtype} data, got "
                                f"{data.dtype}")
            if data.dim() != (2 if is_decimal128(data_type) else 1) or \
                    (data.dim() == 2 and data.shape[1] != 2):
                raise TypeError(f"a {data_type} column needs "
                                f"{'[rows, 2]' if data.dim() == 2 else '1-D'}"
                                f" data, got {tuple(data.shape)}")
            n = data.shape[0]
        if validity.dtype != torch.bool or tuple(validity.shape) != (n,):
            raise TypeError("validity must be a bool tensor of one flag per "
                            "row")
        self.data = data
        self.validity = validity
        self.data_type = data_type
        self.all_valid = all_valid
        self.offsets = offsets

    @property
    def row_count(self) -> int:
        if self.offsets is not None:
            return int(self.offsets.shape[0]) - 1
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device

    @property
    def is_string(self) -> bool:
        return self.offsets is not None

    def front(self, k: int) -> "DeviceColumn":
        """The first ``k`` rows: views, no launch (a string keeps its chars
        plane)."""
        offsets = None if self.offsets is None else self.offsets[:k + 1]
        data = self.data if self.offsets is not None else self.data[:k]
        return DeviceColumn(data, self.validity[:k], self.data_type,
                            self.all_valid, offsets)
