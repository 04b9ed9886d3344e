"""Inner, left outer, left semi and left anti equi-joins over one
partition (the analog of ``spark_rapids_tpu/exec/joins.py``:
``TpuShuffledHashJoinExec`` ``:596`` and ``TpuSubPartitionHashJoinExec``
``:878``, device core ``_join_device`` ``:389``).

An inner join builds its hash table on the side with fewer rows, as
Spark's shuffled hash join on the GPU chooses (a TPC-DS star join puts
the small filtered dimension on one side and the fact table on the
other; building on the fact table would make a table thousands of times
larger).  Row counts are exact on the host, so the choice needs no sync.
A left outer join builds on the right side whatever the sizes: the left
side is preserved, so it probes (JAX ``:528-535``).  K10
(``ops/join_ops.py``) gives the row pairs, in its outer mode a left row
with no match paired with build row -1; K7 gathers each side's columns
through them and writes a null row for -1.  Output columns stay left
then right whichever side was built (JAX ``:400-404``).  A left semi or
anti join (JAX ``:433-513``) builds on the right side whatever the sizes,
K10's semi or anti mode gives the kept left rows in order, with no pair
expansion whatever the right side's duplicates, and K7 gathers the left
columns alone: its output is the left schema.  Anti keeps a row whose
key is null, as the JAX package's plain anti join does (its analyzer
plans ``NOT IN`` so, ``sql/analyzer.py:24-26``; Spark's null-aware anti
join would drop it).

Keys are one to eight column pairs of int, date or long (q17 joins
store_sales to store_returns on customer, item and ticket); a row with a
null in any of its key columns never matches.

Refused by name when the plan is built: right, full and cross joins, a
condition beyond the keys, keys other than int, date or long (string and
double keys), and children of several partitions."""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                     Expression)
from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
from spark_rapids_tpu_torch.ops.join_ops import (KEY_TYPES, MAX_KEYS,
                                                 join_pairs)
from spark_rapids_tpu_torch.plan.base import (Exec, ExecContext, Partitions,
                                              join_schema)

INNER = "inner"
LEFT_OUTER = "left_outer"
LEFT_SEMI = "left_semi"
LEFT_ANTI = "left_anti"

_HOW = {"inner": INNER, "left": LEFT_OUTER, "leftouter": LEFT_OUTER,
        "semi": LEFT_SEMI, "leftsemi": LEFT_SEMI,
        "anti": LEFT_ANTI, "leftanti": LEFT_ANTI}
#: K10's mode of each existence join
_EXISTENCE = {LEFT_SEMI: "semi", LEFT_ANTI: "anti"}


def normalize_how(how: str) -> str:
    """A join type's canonical name (JAX ``_normalize_how``, ``:58``);
    raises NotImplementedError, naming it, for a type not in the port."""
    h = how.lower().replace("_", "").replace(" ", "")
    if h not in _HOW:
        raise NotImplementedError(
            f"{how} joins are not in the port yet (inner, left outer, "
            "left semi and left anti joins are)")
    return _HOW[h]


def check_join(how: str, left_keys: Sequence[Expression],
               right_keys: Sequence[Expression], left, right) -> None:
    """Raises NotImplementedError, naming it, for a join the port cannot
    run yet."""
    normalize_how(how)
    if len(left_keys) != len(right_keys):
        raise ValueError(f"{len(left_keys)} left keys for "
                         f"{len(right_keys)} right keys")
    if not 1 <= len(left_keys) <= MAX_KEYS:
        raise NotImplementedError(
            f"a join on {len(left_keys)} key columns is not in the port yet "
            f"(1 to {MAX_KEYS} key columns are)")
    for k in (*left_keys, *right_keys):
        if not isinstance(k, BoundReference):
            raise NotImplementedError(
                f"a join key that is an expression ({k.sql()}) is not in "
                "the port yet")
        if not isinstance(k.data_type, KEY_TYPES):
            raise NotImplementedError(
                f"a join key of {k.data_type} is not in the port yet (int, "
                "date and long keys are)")
    if left.num_partitions != 1 or right.num_partitions != 1:
        raise NotImplementedError(
            "a join of several partitions is not in the port yet")


def _keys_of(batch: ColumnarBatch, keys: Sequence[BoundReference]):
    """K10's key argument: the key column alone, or the list of them."""
    cols = [batch.columns[k.ordinal] for k in keys]
    return cols[0] if len(cols) == 1 else cols


class TorchHashJoinExec(Exec):
    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], left, right,
                 how: str = INNER):
        check_join(how, left_keys, right_keys, left, right)
        super().__init__([left, right])
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = normalize_how(how)

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
        return join_schema(self.left.schema, self.right.schema, self.how)

    def node_string(self):
        keys = ", ".join(f"{a.sql()} = {b.sql()}"
                         for a, b in zip(self.left_keys, self.right_keys))
        return f"TorchHashJoin[{self.how}, {keys}]"

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
        lkey, rkey = _keys_of(lb, self.left_keys), _keys_of(rb,
                                                          self.right_keys)
        if self.how in _EXISTENCE:
            lidx, _none = join_pairs(rkey, lkey, transfers,
                                     mode=_EXISTENCE[self.how])
            cols = gather_columns(lb.columns, lidx, transfers, unique=True)
            return ColumnarBatch(cols, lidx.shape[0], self.schema.names)
        outer = self.how == LEFT_OUTER
        if outer:
            lidx, ridx = join_pairs(rkey, lkey, transfers, outer=True)
        elif lb.row_count < rb.row_count:
            ridx, lidx = join_pairs(lkey, rkey, transfers)
        else:
            lidx, ridx = join_pairs(rkey, lkey, transfers)
        cols = gather_columns(lb.columns, lidx, transfers) + \
            gather_columns(rb.columns, ridx, transfers, nullable=outer)
        return ColumnarBatch(cols, lidx.shape[0], self.schema.names)

    def execute(self, ctx: ExecContext) -> Partitions:
        lb = self._one_batch(self.left.execute(ctx), "left")
        rb = self._one_batch(self.right.execute(ctx), "right")
        return [[self.join_batches(lb, rb, ctx.transfers)]]
