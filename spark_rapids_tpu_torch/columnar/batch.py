"""Columnar batches (the analog of ``spark_rapids_tpu/columnar/batch.py``).

``batch_from_numpy`` is where state crosses from the JAX package: it takes
per column the ``(data, validity)`` numpy planes that the JAX package's
``HostColumn`` holds, so the tests feed one seeded set of arrays to both
engines."""

from __future__ import annotations

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


def batch_from_pydict(d: Dict[str, object],
                      schema: Optional[T.StructType] = None
                      ) -> HostColumnarBatch:
    """Columns from numpy arrays (no nulls) or Python lists (``None`` is a
    null), typed by ``schema`` where given, else by the numpy dtype."""
    cols, names = [], []
    for name, values in d.items():
        dt = None if schema is None else \
            schema.types[schema.field_index(name)]
        if isinstance(values, np.ndarray):
            cols.append(HostColumn(values, None,
                                   dt or T.from_numpy_dtype(values.dtype)))
        else:
            values = list(values)
            valid = np.array([v is not None for v in values], dtype=bool)
            if dt is None:
                present = [v for v in values if v is not None]
                dt = T.from_numpy_dtype(np.asarray(present).dtype) \
                    if present else T.LONG
            data = np.array([0 if v is None else v for v in values],
                            dtype=dt.np_dtype)
            cols.append(HostColumn(data, None if valid.all() else valid, dt))
        names.append(name)
    n = len(cols[0]) if cols else 0
    return HostColumnarBatch(cols, n, names)


def batch_from_numpy(columns: Sequence[Tuple[np.ndarray,
                                             Optional[np.ndarray]]],
                     schema: T.StructType) -> HostColumnarBatch:
    """A host batch from per-column ``(data, validity)`` planes in schema
    order; ``validity`` is a bool array (True = present) or None."""
    if len(columns) != len(schema):
        raise ValueError(f"{len(columns)} columns for a schema of "
                         f"{len(schema)}")
    cols = [HostColumn(data, validity, f.data_type)
            for (data, validity), f in zip(columns, schema.fields)]
    n = len(cols[0]) if cols else 0
    return HostColumnarBatch(cols, n, schema.names)
