"""Batch glue (the analog of ``spark_rapids_tpu/ops/batch_ops.py``).

On this slice ``concat_batches`` only joins the partitions' one-row
partial aggregates before the final merge: torch glue over a handful of
scalars.  Its full-size form (``batch.concat``, ``:274``) gets a kernel in
the next slice."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn


def concat_batches(batches: Sequence[ColumnarBatch]) -> ColumnarBatch:
    if not batches:
        raise ValueError("cannot concat zero batches")
    first = batches[0]
    if len(batches) == 1:
        return first
    cols = []
    for i, c in enumerate(first.columns):
        cols.append(DeviceColumn(
            torch.cat([b.columns[i].data for b in batches]),
            torch.cat([b.columns[i].validity for b in batches]),
            c.data_type))
    return ColumnarBatch(cols, sum(b.row_count for b in batches),
                         first.names)
