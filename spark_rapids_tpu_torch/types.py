"""Data types of the port: the subset of ``spark_rapids_tpu/types.py`` that
the port's queries need, each with its numpy (host) and torch (device)
dtype.  A string has neither: its column is Arrow offsets plus a uint8
chars plane (``columnar/column.py``).  A date is int32 days since the
epoch (``types.py:131``), as the JAX package keeps it."""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DataType", "NullType", "BooleanType", "IntegerType", "LongType",
    "DoubleType", "StringType", "DateType", "StructField", "StructType",
    "NULL", "BOOLEAN", "INT", "LONG", "DOUBLE", "STRING", "DATE",
    "from_numpy_dtype", "common_type", "date_days", "days_date",
]


class DataType:
    """Base class of the logical type lattice."""

    #: dtype of the host data plane
    np_dtype: Optional[np.dtype] = None
    #: dtype of the device data plane
    torch_dtype: Optional[torch.dtype] = None

    @property
    def simple_name(self) -> str:
        return type(self).__name__.replace("Type", "").lower()

    @property
    def is_numeric(self) -> bool:
        return isinstance(self, (IntegerType, LongType, DoubleType))

    @property
    def is_integral(self) -> bool:
        return isinstance(self, (IntegerType, LongType))

    @property
    def is_floating(self) -> bool:
        return isinstance(self, DoubleType)

    def __eq__(self, other) -> bool:
        return type(self) is type(other)

    def __hash__(self) -> int:
        return hash(type(self).__name__)

    def __repr__(self) -> str:
        return type(self).__name__

    __str__ = __repr__


class NullType(DataType):
    pass


class BooleanType(DataType):
    np_dtype = np.dtype(np.bool_)
    torch_dtype = torch.bool


class IntegerType(DataType):
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32


class LongType(DataType):
    np_dtype = np.dtype(np.int64)
    torch_dtype = torch.int64


class DoubleType(DataType):
    np_dtype = np.dtype(np.float64)
    torch_dtype = torch.float64


class StringType(DataType):
    """UTF-8 text of any length (``spark_rapids_tpu/types.py:115``)."""


class DateType(DataType):
    """Days since the unix epoch, int32 (``spark_rapids_tpu/types.py:131``;
    Spark's DateType).  It orders and compares as its int32, and is not
    numeric: it takes no arithmetic."""
    np_dtype = np.dtype(np.int32)
    torch_dtype = torch.int32


NULL = NullType()
BOOLEAN = BooleanType()
INT = IntegerType()
LONG = LongType()
DOUBLE = DoubleType()
STRING = StringType()
DATE = DateType()

_FROM_NUMPY = {np.dtype(np.bool_): BOOLEAN, np.dtype(np.int32): INT,
               np.dtype(np.int64): LONG, np.dtype(np.float64): DOUBLE,
               np.dtype("datetime64[D]"): DATE}

_EPOCH = datetime.date(1970, 1, 1)


def date_days(value: datetime.date) -> int:
    """A ``datetime.date`` as days since the epoch."""
    if isinstance(value, datetime.datetime) or \
            not isinstance(value, datetime.date):
        raise TypeError(f"a date needs a datetime.date, got {value!r}")
    return (value - _EPOCH).days


def days_date(days: int) -> datetime.date:
    """Days since the epoch as a ``datetime.date``."""
    return _EPOCH + datetime.timedelta(days=int(days))

#: numeric widening order (Spark's findTightestCommonType over this subset)
_PROMOTION_ORDER = [INT, LONG, DOUBLE]


def from_numpy_dtype(dt) -> DataType:
    dt = np.dtype(dt)
    if dt not in _FROM_NUMPY:
        raise NotImplementedError(
            f"numpy dtype {dt} has no type in this port yet")
    return _FROM_NUMPY[dt]


def common_type(a: DataType, b: DataType) -> DataType:
    """Least common numeric promotion."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if a.is_numeric and b.is_numeric:
        return _PROMOTION_ORDER[max(_PROMOTION_ORDER.index(a),
                                    _PROMOTION_ORDER.index(b))]
    raise TypeError(f"no common type for {a} and {b}")


@dataclasses.dataclass(frozen=True)
class StructField:
    name: str
    data_type: DataType
    nullable: bool = True


@dataclasses.dataclass(frozen=True)
class StructType:
    fields: Tuple[StructField, ...]

    def __init__(self, fields):
        object.__setattr__(self, "fields", tuple(fields))

    @property
    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    @property
    def types(self) -> List[DataType]:
        return [f.data_type for f in self.fields]

    def field_index(self, name: str) -> int:
        for i, f in enumerate(self.fields):
            if f.name == name:
                return i
        raise KeyError(f"no column {name!r} in {self.names}")

    def __len__(self) -> int:
        return len(self.fields)
