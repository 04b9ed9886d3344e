"""Expand (the analog of ``spark_rapids_tpu/exec/expand.py``:
``TpuExpandExec`` ``:78``): each input batch yields one output batch per
projection, over the same resident input, as ROLLUP's grouping sets need
(``session.py GroupedData``: one projection per set, the keys a set does
not group as null literals, then the grouping id, then the child columns
the aggregates read).

A projection here holds column references and literals only, so it
launches nothing: a column passed through is the input column itself (a
view), a null literal an all-null plane of its type (zeros under a false
validity; a string's offsets all 0 and no chars), another literal (the
grouping id) a plane filled with its value.  The JAX package evaluates
each projection as one program (``eval_exprs_tpu``) and carries every
child column; the port's planner passes on only the columns the
aggregate reads, whose rows the keyed aggregate then concatenates
(K7c)."""

from __future__ import annotations

from typing import List, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                     Expression, Literal)
from spark_rapids_tpu_torch.plan.base import ExecContext, Partitions, \
    UnaryExec


def constant_column(value, dtype: T.DataType, n: int,
                    device: torch.device) -> DeviceColumn:
    """``n`` rows of one literal (a null of any type, or a number such as
    the grouping id): a null is zeros under a false validity (a string:
    offsets all 0, no chars)."""
    valid = torch.full((n,), value is not None, dtype=torch.bool,
                       device=device)
    if isinstance(dtype, T.StringType):
        if value is not None:
            raise NotImplementedError(
                "a string literal in an Expand is not in the port yet")
        return DeviceColumn(torch.empty(0, dtype=torch.uint8, device=device),
                            valid, dtype, False,
                            torch.zeros(n + 1, dtype=torch.int32,
                                        device=device))
    if value is None:
        return DeviceColumn(torch.zeros(n, dtype=dtype.torch_dtype,
                                        device=device), valid, dtype)
    return DeviceColumn(torch.full((n,), value, dtype=dtype.torch_dtype,
                                   device=device), valid, dtype, True)


class TorchExpandExec(UnaryExec):
    def __init__(self, projections: Sequence[Sequence[Expression]],
                 schema: T.StructType, child):
        super().__init__(child)
        for p in projections:
            for e in p:
                if not isinstance(e, (BoundReference, Literal)):
                    raise NotImplementedError(
                        f"an Expand projection of {e.sql()} is not in the "
                        "port yet (column references and literals are)")
        self.projections = [list(p) for p in projections]
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def node_string(self):
        return f"TorchExpand[{len(self.projections)} projections]"

    def project(self, batch: ColumnarBatch,
                projection: List[Expression]) -> ColumnarBatch:
        n = batch.row_count
        cols = [batch.columns[e.ordinal] if isinstance(e, BoundReference)
                else constant_column(e.value, e.data_type, n, batch.device)
                for e in projection]
        return ColumnarBatch(cols, n, self._schema.names)

    def execute(self, ctx: ExecContext) -> Partitions:
        return [[self.project(b, p) for b in part for p in self.projections]
                for part in self.child.execute(ctx)]
