"""ORDER BY over one partition (the analog of ``spark_rapids_tpu/exec/
sort.py``: ``SortSpec`` and ``TpuSortExec`` ``:221``).

``TorchSortExec`` sorts its one batch with K8 and gathers it with K7
(``ops/sort_ops.py sort_batch``).  Keys must be columns of the child (a
sort by a computed expression, several partitions or several batches are
refused by name)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                     Expression)
from spark_rapids_tpu_torch.ops.sort_ops import (SORT_KEY_TYPES, SortOrder,
                                                 sort_batch)
from spark_rapids_tpu_torch.plan.base import (ExecContext, Partitions,
                                              UnaryExec)


@dataclasses.dataclass
class SortSpec:
    """A sort key at the expression level (Spark's SortOrder)."""
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # default: asc first, desc last

    @property
    def effective_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None \
            else self.nulls_first

    def sql(self) -> str:
        return (f"{self.expr.sql()} {'ASC' if self.ascending else 'DESC'} "
                f"NULLS {'FIRST' if self.effective_nulls_first else 'LAST'}")


class TorchSortExec(UnaryExec):
    def __init__(self, specs: Sequence[SortSpec], child):
        super().__init__(child)
        self.specs = list(specs)
        for s in self.specs:
            if not isinstance(s.expr, BoundReference):
                raise NotImplementedError(
                    f"a sort by an expression ({s.expr.sql()}) is not in the "
                    "port yet")
            if s.expr.data_type not in SORT_KEY_TYPES:
                raise NotImplementedError(
                    f"a sort key of {s.expr.data_type} is not in the port "
                    "yet (int, long and double keys are)")
        if child.num_partitions != 1:
            raise NotImplementedError(
                "a sort over several partitions is not in the port yet")
        self.orders = [SortOrder(s.expr.ordinal, s.ascending,
                                 s.effective_nulls_first)
                       for s in self.specs]

    def node_string(self):
        return f"TorchSort[{', '.join(s.sql() for s in self.specs)}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        out = []
        for part in self.child.execute(ctx):
            if len(part) > 1:
                raise NotImplementedError(
                    "a sort over several batches is not in the port yet")
            out.append([sort_batch(b, self.orders, ctx.transfers)
                        for b in part])
        return out
