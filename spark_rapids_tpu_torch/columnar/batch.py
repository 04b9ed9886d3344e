"""Columnar batches (the analog of ``spark_rapids_tpu/columnar/batch.py``).

``batch_from_numpy`` is where state crosses from the JAX package: it takes
per column the ``(data, validity)`` numpy planes that the JAX package's
``HostColumn`` holds, so the tests feed one seeded set of arrays to both
engines.  ``batch_from_pydict`` takes what the JAX package's
``create_dataframe`` takes: numpy arrays (``datetime64[D]`` is a date
column), object arrays of ``str`` and ``None``, and lists (of
``datetime.date`` for a date column)."""

from __future__ import annotations

import datetime
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn


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


def _is_text(values) -> bool:
    if isinstance(values, np.ndarray) and values.dtype.kind in ("U", "S"):
        return True
    return any(isinstance(v, str) for v in values if v is not None)


def host_column(values, dt: Optional[T.DataType] = None) -> HostColumn:
    """One host column from a numpy array (no nulls unless it holds
    ``None`` objects) or a list (``None`` is a null)."""
    if isinstance(dt, T.StringType) or (dt is None and _is_text(values)):
        return HostColumn.from_strings(list(values))
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
        else:
            cols.append(HostColumn(data, validity, f.data_type))
    n = len(cols[0]) if cols else 0
    return HostColumnarBatch(cols, n, schema.names)
