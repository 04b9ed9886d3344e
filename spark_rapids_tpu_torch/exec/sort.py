"""ORDER BY (the analog of ``spark_rapids_tpu/exec/sort.py``: ``SortSpec``
and ``TpuSortExec`` ``:221``).

``TorchSortExec`` sorts each partition's batch with K8 and gathers it
with K7.  A key that computes (the JAX package's hidden ``_ord`` columns
of ``TakeOrderedAndProject``; q36 orders by a ``CASE WHEN``) is computed
by K6 beside the keys that are columns; K8 sorts the key columns and K7
gathers the child's columns alone, so the computed keys never join the
output.  Over several partitions the planner puts a range exchange
(K11r) below it (``CpuSortExec(global_sort=True)`` over
``RangePartitioning``), so the sorted partitions come out in range
order; several batches of one partition are joined first (K7c)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from spark_rapids_tpu_torch.expressions.base import Expression
from spark_rapids_tpu_torch.ops import sort_ops
from spark_rapids_tpu_torch.ops.sort_ops import SORT_KEY_TYPES, SortOrder
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
        from spark_rapids_tpu_torch.exec.fused import StageProgram
        super().__init__(child)
        self.specs = list(specs)
        for s in self.specs:
            if s.expr.data_type not in SORT_KEY_TYPES:
                raise NotImplementedError(
                    f"a sort key of {s.expr.data_type} is not in the port "
                    "yet (int, date, long, double and string keys are)")
        # the key columns: K6 computes those that are not columns
        self.keys = StageProgram([("project", [s.expr for s in self.specs])],
                                 child.schema, 0)
        self.orders = [SortOrder(j, s.ascending, s.effective_nulls_first)
                       for j, s in enumerate(self.specs)]

    def node_string(self):
        return f"TorchSort[{', '.join(s.sql() for s in self.specs)}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        return [[self.sort_batch(concat_batches(part), ctx.transfers)]
                if part else [] for part in self.child.execute(ctx)]

    def sort_batch(self, batch, transfers):
        """The batch in SQL order: K6 for the computed keys, K8, then K7
        through the permutation."""
        from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                       project_batch)
        from spark_rapids_tpu_torch.ops.batch_ops import gather_batch
        if batch.row_count == 0:
            return batch
        keys = project_batch(self.keys, batch, LiteralArgs([]),
                             [f"_ord{j}" for j in range(len(self.specs))])
        perm = sort_ops.sort_permutation(keys.columns, self.orders,
                                         transfers)
        return gather_batch(batch, perm, transfers, unique=True)
