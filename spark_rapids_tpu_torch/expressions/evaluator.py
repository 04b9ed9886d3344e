"""Projection of a batch with the plain PyTorch evaluator (the analog of
``spark_rapids_tpu/expressions/evaluator.py``).

It runs only the final projection of a global aggregate:
``If(cnt > 0, sum, NULL)`` over one row, a handful of scalars.  The
full-size form, ``eval_exprs_tpu``, is K6 (``exec/fused.py
fused_project``)."""

from __future__ import annotations

from typing import List, Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.base import (Col, EvalContext,
                                                     Expression, output_name)


def batch_cols(batch: ColumnarBatch) -> List[Col]:
    return [Col(c.data, c.validity, c.offsets) for c in batch.columns]


def eval_exprs(exprs: Sequence[Expression], batch: ColumnarBatch
               ) -> ColumnarBatch:
    ctx = EvalContext(batch_cols(batch), batch.row_count, batch.device)
    cols = []
    for e in exprs:
        c = e.eval(ctx)
        cols.append(DeviceColumn(c.data.to(e.data_type.torch_dtype),
                                 c.valid, e.data_type))
    return ColumnarBatch(cols, batch.row_count,
                         [output_name(e) for e in exprs])
