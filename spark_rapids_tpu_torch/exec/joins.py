"""Inner equi-join over one partition (the analog of
``spark_rapids_tpu/exec/joins.py``: ``TpuShuffledHashJoinExec`` ``:596`` and
``TpuSubPartitionHashJoinExec`` ``:878``, device core ``_join_device``
``:389``).

The join builds its hash table on the side with fewer rows, as Spark's
shuffled hash join on the GPU chooses (a TPC-DS star join puts the small
filtered dimension on one side and the fact table on the other; building
on the fact table would make a table thousands of times larger).  Row
counts are exact on the host, so the choice needs no sync.  K10
(``ops/join_ops.py``) gives the matching row pairs; K7 gathers each side's
columns through them.  Output columns stay left then right whichever side
was built (JAX ``:400-404``).

Refused by name when the plan is built: other join types, a condition
beyond the keys, several key columns, keys other than int or long, and
children of several partitions."""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                     Expression)
from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
from spark_rapids_tpu_torch.ops.join_ops import KEY_TYPES, join_pairs
from spark_rapids_tpu_torch.plan.base import Exec, ExecContext, Partitions

INNER = "inner"


def check_join(how: str, left_keys: Sequence[Expression],
               right_keys: Sequence[Expression], left, right) -> None:
    """Raises NotImplementedError, naming it, for a join the port cannot
    run yet."""
    if how != INNER:
        raise NotImplementedError(
            f"{how} joins are not in the port yet (inner joins are)")
    if len(left_keys) != 1 or len(right_keys) != 1:
        raise NotImplementedError(
            f"a join on {len(left_keys)} key columns is not in the port yet "
            "(one key column is)")
    for k in (*left_keys, *right_keys):
        if not isinstance(k, BoundReference):
            raise NotImplementedError(
                f"a join key that is an expression ({k.sql()}) is not in "
                "the port yet")
        if not isinstance(k.data_type, KEY_TYPES):
            raise NotImplementedError(
                f"a join key of {k.data_type} is not in the port yet (int "
                "and long keys are)")
    if left.num_partitions != 1 or right.num_partitions != 1:
        raise NotImplementedError(
            "a join of several partitions is not in the port yet")


class TorchHashJoinExec(Exec):
    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], left, right,
                 how: str = INNER):
        check_join(how, left_keys, right_keys, left, right)
        super().__init__([left, right])
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def num_partitions(self):
        return 1

    @property
    def schema(self):
        return T.StructType(list(self.left.schema.fields) +
                            list(self.right.schema.fields))

    def node_string(self):
        return (f"TorchHashJoin[{self.how}, "
                f"{self.left_keys[0].sql()} = {self.right_keys[0].sql()}]")

    @staticmethod
    def _one_batch(parts: Partitions, side: str) -> ColumnarBatch:
        batches = [b for part in parts for b in part]
        if len(batches) != 1:
            raise NotImplementedError(
                f"a join whose {side} side holds {len(batches)} batches is "
                "not in the port yet")
        return batches[0]

    def join_batches(self, lb: ColumnarBatch, rb: ColumnarBatch,
                     transfers) -> ColumnarBatch:
        lkey = lb.columns[self.left_keys[0].ordinal]
        rkey = rb.columns[self.right_keys[0].ordinal]
        build_left = lb.row_count < rb.row_count
        if build_left:
            ridx, lidx = join_pairs(lkey, rkey, transfers)
        else:
            lidx, ridx = join_pairs(rkey, lkey, transfers)
        cols = gather_columns(lb.columns, lidx, transfers) + \
            gather_columns(rb.columns, ridx, transfers)
        return ColumnarBatch(cols, lidx.shape[0], self.schema.names)

    def execute(self, ctx: ExecContext) -> Partitions:
        lb = self._one_batch(self.left.execute(ctx), "left")
        rb = self._one_batch(self.right.execute(ctx), "right")
        return [[self.join_batches(lb, rb, ctx.transfers)]]
