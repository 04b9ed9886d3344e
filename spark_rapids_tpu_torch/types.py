"""Data types of the port: the subset of ``spark_rapids_tpu/types.py`` that
the port's queries need, each with its numpy (host) and torch (device)
dtype.  A string has neither: its column is Arrow offsets plus a uint8
chars plane (``columnar/column.py``).  A date is int32 days since the
epoch (``types.py:131``), as the JAX package keeps it.  A decimal
(``DecimalType``, ``types.py:142-172``) is its unscaled integer: int64 up
to 18 digits (decimal64), an int64 ``[rows, 2]`` (hi, lo) pair past them
(decimal128), as the JAX package's device columns hold it."""

from __future__ import annotations

import dataclasses
import datetime
from typing import List, Optional, Tuple

import numpy as np
import torch

__all__ = [
    "DataType", "NullType", "BooleanType", "IntegerType", "LongType",
    "DoubleType", "StringType", "DateType", "DecimalType", "StructField",
    "StructType",
    "NULL", "BOOLEAN", "INT", "LONG", "DOUBLE", "STRING", "DATE",
    "from_numpy_dtype", "common_type", "date_days", "days_date",
    "from_arrow", "to_arrow", "integral_decimal",
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
        return isinstance(self, (IntegerType, LongType, DoubleType,
                                 DecimalType))

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


class DecimalType(DataType):
    """Fixed-point decimal(precision, scale) (``spark_rapids_tpu/types.py
    :142``): the unscaled value, int64 for a precision up to
    ``MAX_LONG_DIGITS`` (decimal64), an int64 ``[rows, 2]`` (hi word, lo
    word bits) pair up to ``MAX_PRECISION`` (decimal128).  It is numeric
    but neither integral nor floating: its arithmetic and comparisons are
    ``expressions/decimal_math.py``'s."""

    MAX_PRECISION = 38
    MAX_LONG_DIGITS = 18
    torch_dtype = torch.int64

    def __init__(self, precision: int = 10, scale: int = 0):
        if not 0 < precision <= self.MAX_PRECISION:
            raise ValueError(f"decimal precision out of range: {precision}")
        if not 0 <= scale <= precision:
            raise ValueError(f"decimal scale {scale} out of range for "
                             f"precision {precision}")
        self.precision = int(precision)
        self.scale = int(scale)

    @property
    def np_dtype(self):
        return np.dtype(np.int64)

    @property
    def is_decimal128(self) -> bool:
        return self.precision > self.MAX_LONG_DIGITS

    @property
    def simple_name(self) -> str:
        return f"decimal({self.precision},{self.scale})"

    def __eq__(self, other) -> bool:
        return isinstance(other, DecimalType) and \
            (self.precision, self.scale) == (other.precision, other.scale)

    def __hash__(self) -> int:
        return hash(("decimal", self.precision, self.scale))

    def __repr__(self) -> str:
        return f"DecimalType({self.precision},{self.scale})"

    def __str__(self) -> str:
        return self.simple_name


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


def from_arrow(at) -> DataType:
    """The port's type of an Arrow type (a parquet column's, as pyarrow
    reads it): the value type of a dictionary; int8, int16 and int32 are
    INT, float32 and float64 DOUBLE (the port has no byte, short or
    float type); a type the port has no column for is refused by
    name."""
    import pyarrow as pa
    if pa.types.is_dictionary(at):
        at = at.value_type
    if pa.types.is_boolean(at):
        return BOOLEAN
    if pa.types.is_int8(at) or pa.types.is_int16(at) or \
            pa.types.is_int32(at):
        return INT
    if pa.types.is_int64(at):
        return LONG
    if pa.types.is_float32(at) or pa.types.is_float64(at):
        return DOUBLE
    if pa.types.is_string(at) or pa.types.is_large_string(at):
        return STRING
    if pa.types.is_date32(at):
        return DATE
    if pa.types.is_null(at):
        return NULL
    if pa.types.is_decimal128(at):
        return DecimalType(at.precision, at.scale)
    raise NotImplementedError(f"an Arrow {at} column is not in the port "
                              "yet")


def to_arrow(dt: DataType):
    """The Arrow type of a port type (the parquet writer's)."""
    import pyarrow as pa
    if isinstance(dt, DecimalType):
        return pa.decimal128(dt.precision, dt.scale)
    arrow = {BooleanType: pa.bool_(), IntegerType: pa.int32(),
             LongType: pa.int64(), DoubleType: pa.float64(),
             StringType: pa.string(), DateType: pa.date32(),
             NullType: pa.null()}
    return arrow[type(dt)]


def common_type(a: DataType, b: DataType) -> DataType:
    """Least common numeric promotion.  Two decimals widen to the
    decimal that holds both (Spark's ``DecimalPrecision.widerDecimalType``),
    a decimal and an int or long to the decimal that holds the integer's
    digits too, a decimal and a double to double."""
    if a == b:
        return a
    if isinstance(a, NullType):
        return b
    if isinstance(b, NullType):
        return a
    if isinstance(a, DecimalType) or isinstance(b, DecimalType):
        if a.is_floating or b.is_floating:
            return DOUBLE
        da, db = integral_decimal(a), integral_decimal(b)
        if da is None or db is None:
            raise TypeError(f"no common type for {a} and {b}")
        scale = max(da.scale, db.scale)
        digits = max(da.precision - da.scale, db.precision - db.scale)
        return DecimalType(min(digits + scale, DecimalType.MAX_PRECISION),
                           scale)
    if a.is_numeric and b.is_numeric:
        return _PROMOTION_ORDER[max(_PROMOTION_ORDER.index(a),
                                    _PROMOTION_ORDER.index(b))]
    raise TypeError(f"no common type for {a} and {b}")


def integral_decimal(dt: DataType) -> Optional[DecimalType]:
    """The decimal view of a decimal, int or long (Spark's widening of an
    integral operand: int as decimal(10,0), long as decimal(19,0)); None
    for any other type."""
    if isinstance(dt, DecimalType):
        return dt
    if isinstance(dt, IntegerType):
        return DecimalType(10, 0)
    if isinstance(dt, LongType):
        return DecimalType(19, 0)
    return None


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
