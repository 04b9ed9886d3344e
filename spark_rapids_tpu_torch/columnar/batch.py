"""Columnar batches (the analog of ``spark_rapids_tpu/columnar/batch.py``).

``batch_from_numpy`` is where state crosses from the JAX package: it takes
per column the ``(data, validity)`` numpy planes that the JAX package's
``HostColumn`` holds, so the tests feed one seeded set of arrays to both
engines.  ``batch_from_pydict`` takes what the JAX package's
``create_dataframe`` takes: numpy arrays (``datetime64[D]`` is a date
column), object arrays of ``str`` and ``None``, and lists (of
``datetime.date`` for a date column).  ``batch_from_arrow`` takes what a
parquet scan reads; a host batch's column is then a ``HostColumn`` or,
kept encoded, a ``columnar/encoding.py HostDictionaryColumn``."""

from __future__ import annotations

import datetime
import decimal
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    HostColumn,
                                                    decimal128_words,
                                                    unscaled_of)


class HostColumnarBatch:
    def __init__(self, columns: Sequence[HostColumn], row_count: int,
                 names: Sequence[str]):
        self.columns = list(columns)
        self.row_count = int(row_count)
        self.names = list(names)
        if len(self.names) != len(self.columns):
            raise ValueError("one name per column is needed")
        for c in self.columns:
            if len(c) != self.row_count:
                raise ValueError(f"column of {len(c)} rows in a batch of "
                                 f"{self.row_count}")

    @property
    def schema(self) -> T.StructType:
        return T.StructType([T.StructField(n, c.data_type, True)
                             for n, c in zip(self.names, self.columns)])

    def slice(self, start: int, length: int) -> "HostColumnarBatch":
        return HostColumnarBatch([c.slice(start, length)
                                  for c in self.columns], length, self.names)

    def to_pydict(self) -> Dict[str, list]:
        return {n: c.to_pylist() for n, c in zip(self.names, self.columns)}

    def nbytes(self) -> int:
        """Bytes of the columns' planes (a dictionary column's codes and
        its dictionary)."""
        total = 0
        for c in self.columns:
            arrow = getattr(c, "arrow", None)
            if arrow is not None:
                total += arrow.nbytes
                continue
            total += c.data.nbytes
            if c.validity is not None:
                total += c.validity.nbytes
            if c.offsets is not None:
                total += c.offsets.nbytes
        return total

    def take(self, idx: np.ndarray) -> "HostColumnarBatch":
        """The rows ``idx`` in that order (through Arrow's take)."""
        import pyarrow as pa
        out = batch_from_arrow(self.to_arrow().take(pa.array(idx)))
        out.names = list(self.names)
        return out

    def to_arrow(self):
        """The batch as a pyarrow Table (a dictionary column decoded)."""
        import pyarrow as pa
        from spark_rapids_tpu_torch.io.multifile import host_arrow
        return pa.Table.from_arrays([host_arrow(c) for c in self.columns],
                                    names=self.names)

    def to_rows(self) -> List[dict]:
        d = self.to_pydict()
        return [dict(zip(d.keys(), row)) for row in zip(*d.values())]


class ColumnarBatch:
    """A batch of device columns, all on one device."""

    def __init__(self, columns: Sequence[DeviceColumn], row_count: int,
                 names: Sequence[str]):
        self.columns = list(columns)
        self.row_count = int(row_count)
        self.names = list(names)
        for c in self.columns:
            if c.row_count != self.row_count:
                raise ValueError(f"column of {c.row_count} rows in a batch "
                                 f"of {self.row_count}")

    @property
    def device(self) -> torch.device:
        return self.columns[0].device

    @property
    def schema(self) -> T.StructType:
        return T.StructType([T.StructField(n, c.data_type, True)
                             for n, c in zip(self.names, self.columns)])

    def select(self, ordinals: Sequence[int],
               names: Sequence[str]) -> "ColumnarBatch":
        """Some columns, renamed: no copy, no launch."""
        return ColumnarBatch([self.columns[i] for i in ordinals],
                             self.row_count, names)

    def front(self, k: int) -> "ColumnarBatch":
        """The first ``k`` rows (views)."""
        k = min(k, self.row_count)
        return ColumnarBatch([c.front(k) for c in self.columns], k,
                             self.names)

    def nbytes(self) -> int:
        """Bytes of the columns' planes on the device (a string's whole
        chars plane; a dictionary column's codes, not its shared
        dictionary): what the memory runtime accounts for the batch."""
        total = 0
        for c in self.columns:
            total += c.data.numel() * c.data.element_size() + \
                c.validity.numel()
            if c.offsets is not None:
                total += c.offsets.numel() * c.offsets.element_size()
        return total


def _is_text(values) -> bool:
    if isinstance(values, np.ndarray) and values.dtype != object:
        # a typed array says so without a look at its values
        return values.dtype.kind in ("U", "S")
    return any(isinstance(v, str) for v in values if v is not None)


def decimal_column(values, dt: T.DecimalType,
                   validity: Optional[np.ndarray] = None) -> HostColumn:
    """A decimal host column of unscaled values: an int64 array (cents
    under a DECIMAL(7,2), say), an object array of Python ints, or a
    ``[rows, 2]`` (hi, lo) array for a decimal128; exact, never through
    a float."""
    arr = np.asarray(values)
    if dt.is_decimal128 and not (arr.ndim == 2 and arr.dtype == np.int64):
        arr = decimal128_words([int(v) for v in arr.tolist()])
    elif not dt.is_decimal128 and arr.dtype != np.int64:
        arr = np.array([int(v) for v in arr.tolist()], dtype=np.int64)
    return HostColumn(arr, validity, dt)


def host_column(values, dt: Optional[T.DataType] = None) -> HostColumn:
    """One host column from a numpy array (no nulls unless it holds
    ``None`` objects) or a list (``None`` is a null); a ``HostColumn`` as
    it is.  A decimal column takes ``decimal.Decimal`` values (a list of
    them with no ``dt`` is decimal(38,18), as pyspark infers it), or,
    with a ``DecimalType`` ``dt``, an int64 array of unscaled values."""
    if isinstance(values, HostColumn):
        return values
    if isinstance(dt, T.StringType) or (dt is None and _is_text(values)):
        return HostColumn.from_strings(list(values))
    if isinstance(dt, T.ArrayType) or (
            not isinstance(values, np.ndarray) or values.dtype == object) \
            and any(isinstance(v, (list, tuple, np.ndarray))
                    for v in values):
        raise NotImplementedError(
            "an array input column is not in the port yet (an array is an "
            "output of collect_list and collect_set only)")
    if dt is None and not isinstance(values, np.ndarray) and \
            any(isinstance(v, decimal.Decimal) for v in values):
        dt = T.DecimalType(38, 18)
    if isinstance(dt, T.DecimalType):
        if isinstance(values, np.ndarray) and values.dtype != object:
            return decimal_column(values, dt)
        values = list(values)
        valid = np.array([v is not None for v in values], dtype=bool)
        data = [0 if v is None else unscaled_of(v, dt.scale)
                for v in values]
        return decimal_column(np.array(data, dtype=object), dt,
                              None if valid.all() else valid)
    if isinstance(values, np.ndarray) and values.dtype != object:
        return HostColumn(values, None,
                          dt or T.from_numpy_dtype(values.dtype))
    values = list(values)
    valid = np.array([v is not None for v in values], dtype=bool)
    present = [v for v in values if v is not None]
    if dt is None:
        dt = T.DATE if present and isinstance(present[0], datetime.date) \
            else T.from_numpy_dtype(np.asarray(present).dtype) if present \
            else T.LONG
    if isinstance(dt, T.DateType):
        values = [None if v is None else T.date_days(v) for v in values]
    data = np.array([0 if v is None else v for v in values],
                    dtype=dt.np_dtype)
    return HostColumn(data, None if valid.all() else valid, dt)


def batch_from_pydict(d: Dict[str, object],
                      schema: Optional[T.StructType] = None
                      ) -> HostColumnarBatch:
    """Columns from numpy arrays (no nulls), object arrays or lists of
    ``str`` (``None`` is a null), or Python lists, typed by ``schema``
    where given, else by their values."""
    cols, names = [], []
    for name, values in d.items():
        dt = None if schema is None else \
            schema.types[schema.field_index(name)]
        cols.append(host_column(values, dt))
        names.append(name)
    n = len(cols[0]) if cols else 0
    return HostColumnarBatch(cols, n, names)


def batch_from_numpy(columns: Sequence[Tuple[np.ndarray,
                                             Optional[np.ndarray]]],
                     schema: T.StructType) -> HostColumnarBatch:
    """A host batch from per-column ``(data, validity)`` planes in schema
    order; ``validity`` is a bool array (True = present) or None.  A string
    column's data is a sequence of ``str``."""
    if len(columns) != len(schema):
        raise ValueError(f"{len(columns)} columns for a schema of "
                         f"{len(schema)}")
    cols = []
    for (data, validity), f in zip(columns, schema.fields):
        if isinstance(f.data_type, T.StringType):
            values = list(data) if validity is None else \
                [v if ok else None for v, ok in zip(data, validity)]
            cols.append(HostColumn.from_strings(values))
        elif isinstance(f.data_type, T.DecimalType):
            cols.append(decimal_column(data, f.data_type, validity))
        else:
            cols.append(HostColumn(data, validity, f.data_type))
    n = len(cols[0]) if cols else 0
    return HostColumnarBatch(cols, n, schema.names)


def batch_from_arrow(table) -> HostColumnarBatch:
    """A host batch of a pyarrow Table or RecordBatch (the JAX package's
    ``batch_from_arrow``): a dictionary-typed column stays encoded as a
    ``columnar/encoding.py HostDictionaryColumn``; every other column
    becomes numpy planes."""
    from spark_rapids_tpu_torch.columnar.encoding import (
        HostDictionaryColumn, host_column_from_arrow)
    import pyarrow as pa
    cols = []
    for name in table.column_names:
        arr = table.column(name)
        if isinstance(arr, pa.ChunkedArray):
            arr = arr.combine_chunks() if arr.num_chunks != 1 \
                else arr.chunk(0)
        if pa.types.is_dictionary(arr.type):
            cols.append(HostDictionaryColumn(arr))
        else:
            cols.append(host_column_from_arrow(arr))
    return HostColumnarBatch(cols, table.num_rows, table.column_names)
