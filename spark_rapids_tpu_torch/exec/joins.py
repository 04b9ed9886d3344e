"""Inner, left, right and full outer, left semi and left anti equi-joins
(the analog of
``spark_rapids_tpu/exec/joins.py``: ``CpuShuffledHashJoinExec`` ``:577``,
``TpuShuffledHashJoinExec`` ``:596`` and ``TpuSubPartitionHashJoinExec``
``:878``, device core ``_join_device`` ``:389``).

Over several partitions the planner (``session.py join``) hash-exchanges
both sides on their keys to ``max(l, r)`` partitions, an int key hashed
as a long where its partner is a long, so equal keys meet in one
partition; the join then runs once per partition pair, each side one
batch (K7c joins a partition's batches).

An inner join builds its hash table on the side with fewer rows, as
Spark's shuffled hash join on the GPU chooses (a TPC-DS star join puts
the small filtered dimension on one side and the fact table on the
other; building on the fact table would make a table thousands of times
larger).  Row counts are exact on the host, so the choice needs no sync.
A left outer join builds on the right side whatever the sizes: the left
side is preserved, so it probes (JAX ``:528-535``); a right outer join
is the same with the sides swapped, built on the left side and probed
with the right; a full outer join builds on the right side, as the JAX
package does, and K10f (K10's full mode) gives the left outer pairs,
then each right row no left row matched (a null key included) with left
row -1: the build side's matched flags span the partition's one probe
batch, so its unmatched rows come out once, after it (JAX ``:499-502``,
``:544-551``).  Over several partitions each side is hash-exchanged
first, so a preserved side is never broadcast.  K10
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

Keys are one to eight column pairs of int, date, long or string (q17
joins store_sales to store_returns on customer, item and ticket; q6 joins
its facts to the average price by ``i_category``); a string key meets a
string key; a row with a null in any of its key columns never matches,
unless the join is null-safe (``null_safe``, SQL's ``<=>``, as the JAX
package's INTERSECT plans it, ``session.py:495``): a null is then a value
that equals a null, in every mode (K10's null-safe mode).

A cross join (``TorchBroadcastNestedLoopJoinExec``, the JAX package's
``TpuBroadcastNestedLoopJoinExec`` ``:714`` with no condition, driven from
``:271`` and ``:493``) pairs every left row with every right row: K10x
(``ops/join_ops.py cross_pairs``) gives the probe-major pairs, the left
side probing, sized on the host with no sync, and K7 gathers both sides;
its columns are the left ones, then the right ones, and it is empty when
either side is (q28 joins six one-row aggregates so).

A cross join over several partitions broadcasts its right side: K7c
joins all its partitions into one batch, which every left partition
meets (the left side's partitions are the output's).

With USING keys (``DataFrame.join(on=names)``) a right outer join gives
the right side's key columns and a full outer join their coalesce (JAX
``session.py`` ``join``): the join exec then writes, for each key pair,
the left key of its pairs and the right key of its unmatched right rows,
joined by K7c (``coalesce_keys``).

Refused by name when the plan is built: a condition beyond the keys (a
cross join's too), and keys other than int, date, long or string (double
keys)."""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.base import (BoundReference,
                                                     Expression)
from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
from spark_rapids_tpu_torch.ops.join_ops import (KEY_TYPES, MAX_KEYS,
                                                 cross_pairs, join_pairs,
                                                 null_safe_flags)
from spark_rapids_tpu_torch.plan.base import (Exec, ExecContext, Partitions,
                                              join_schema)

INNER = "inner"
CROSS = "cross"
LEFT_OUTER = "left_outer"
RIGHT_OUTER = "right_outer"
FULL_OUTER = "full_outer"
LEFT_SEMI = "left_semi"
LEFT_ANTI = "left_anti"

_HOW = {"inner": INNER, "cross": CROSS, "left": LEFT_OUTER,
        "leftouter": LEFT_OUTER, "right": RIGHT_OUTER,
        "rightouter": RIGHT_OUTER, "full": FULL_OUTER,
        "fullouter": FULL_OUTER, "outer": FULL_OUTER,
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
            f"{how} joins are not in the port (inner, cross, left, right "
            "and full outer, left semi and left anti joins are)")
    return _HOW[h]


def check_join(how: str, left_keys: Sequence[Expression],
               right_keys: Sequence[Expression], left, right) -> None:
    """Raises NotImplementedError, naming it, for a join the port cannot
    run yet."""
    if normalize_how(how) == CROSS:
        raise ValueError("a cross join has no keys "
                         "(TorchBroadcastNestedLoopJoinExec)")
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
                "date, long and string keys are)")
    for a, b in zip(left_keys, right_keys):
        if isinstance(a.data_type, T.StringType) != \
                isinstance(b.data_type, T.StringType):
            raise TypeError(f"the join key {a.sql()} of {a.data_type} "
                            f"cannot meet {b.sql()} of {b.data_type}")
    if left.num_partitions != right.num_partitions:
        raise ValueError(
            f"a join of {left.num_partitions} partitions with "
            f"{right.num_partitions} (the planner exchanges both sides to "
            "one count)")


def hash_as_long(left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression]) -> list:
    """Per key pair, whether both sides hash the key as a long: an int or
    date key whose partner is a long, so equal keys land in one partition
    (the JAX analyzer casts both to the wider type, ``sql/analyzer.py:
    388-401 _coerce_pair``)."""
    return [isinstance(a.data_type, T.LongType) !=
            isinstance(b.data_type, T.LongType)
            for a, b in zip(left_keys, right_keys)]


def _one_batch(part, schema, device) -> ColumnarBatch:
    """A partition's rows as one batch (K7c joins several)."""
    from spark_rapids_tpu_torch.ops.batch_ops import (concat_batches,
                                                      empty_batch)
    return concat_batches(part) if part else empty_batch(schema, device)


def _keys_of(batch: ColumnarBatch, keys: Sequence[BoundReference]):
    """K10's key argument: the key column alone, or the list of them."""
    cols = [batch.columns[k.ordinal] for k in keys]
    return cols[0] if len(cols) == 1 else cols


class _JoinExec(Exec):
    """A join of two children of one partition count: ``execute`` hands
    each partition pair, one batch a side, to ``join_batches``."""

    def __init__(self, left, right, how: str):
        super().__init__([left, right])
        self.how = how

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    @property
    def num_partitions(self):
        return self.left.num_partitions

    @property
    def schema(self):
        return join_schema(self.left.schema, self.right.schema, self.how)

    def right_partitions(self, ctx: ExecContext) -> Partitions:
        return self.right.execute(ctx)

    def execute(self, ctx: ExecContext) -> Partitions:
        lparts = self.left.execute(ctx)
        rparts = self.right_partitions(ctx)
        if len(rparts) == 1 < len(lparts):
            rparts = rparts * len(lparts)
        out = []
        for lp, rp in zip(lparts, rparts):
            lb = _one_batch(lp, self.left.schema, ctx.device)
            rb = _one_batch(rp, self.right.schema, ctx.device)
            out.append([self.join_batches(lb, rb, ctx.transfers)])
        return out


class TorchHashJoinExec(_JoinExec):
    """``coalesce_keys`` (a full outer join with USING keys): each left key
    column of the output holds the left key of the pairs and the right key
    of the unmatched right rows."""

    def __init__(self, left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], left, right,
                 how: str = INNER, coalesce_keys: bool = False,
                 null_safe=False):
        check_join(how, left_keys, right_keys, left, right)
        super().__init__(left, right, normalize_how(how))
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        #: per key pair, whether a null equals a null (``<=>``)
        self.null_safe = null_safe_flags(null_safe, len(self.left_keys))
        if coalesce_keys and (self.how != FULL_OUTER or any(
                a.data_type != b.data_type
                for a, b in zip(self.left_keys, self.right_keys))):
            raise TypeError("coalesced USING keys need a full outer join "
                            "on keys of one type a pair")
        self.coalesce_keys = coalesce_keys

    def node_string(self):
        keys = ", ".join(f"{a.sql()} {'<=>' if safe else '='} {b.sql()}"
                         for a, b, safe in zip(self.left_keys,
                                               self.right_keys,
                                               self.null_safe))
        return f"TorchHashJoin[{self.how}, {keys}]"

    def join_batches(self, lb: ColumnarBatch, rb: ColumnarBatch,
                     transfers) -> ColumnarBatch:
        lkey, rkey = _keys_of(lb, self.left_keys), _keys_of(rb,
                                                          self.right_keys)
        # K10's null-safe mode only where a key asks for it
        safe = {"null_safe": self.null_safe} if any(self.null_safe) else {}
        if self.how in _EXISTENCE:
            lidx, _none = join_pairs(rkey, lkey, transfers,
                                     mode=_EXISTENCE[self.how],
                                     **safe)
            cols = gather_columns(lb.columns, lidx, transfers, unique=True)
            return ColumnarBatch(cols, lidx.shape[0], self.schema.names)
        if self.how == RIGHT_OUTER:
            # the left outer join with the sides swapped
            ridx, lidx = join_pairs(lkey, rkey, transfers, outer=True,
                                    **safe)
            cols = gather_columns(lb.columns, lidx, transfers,
                                  nullable=True) + \
                gather_columns(rb.columns, ridx, transfers)
            return ColumnarBatch(cols, lidx.shape[0], self.schema.names)
        if self.how == FULL_OUTER:
            lidx, ridx, pairs = join_pairs(rkey, lkey, transfers,
                                           mode="full", **safe)
            cols = gather_columns(lb.columns, lidx, transfers,
                                  nullable=True) + \
                gather_columns(rb.columns, ridx, transfers, nullable=True)
            if self.coalesce_keys:
                self._coalesce(cols, lb, rb, lidx, ridx, pairs, transfers)
            return ColumnarBatch(cols, lidx.shape[0], self.schema.names)
        outer = self.how == LEFT_OUTER
        if outer:
            lidx, ridx = join_pairs(rkey, lkey, transfers, outer=True,
                                    **safe)
        elif lb.row_count < rb.row_count:
            ridx, lidx = join_pairs(lkey, rkey, transfers, **safe)
        else:
            lidx, ridx = join_pairs(rkey, lkey, transfers, **safe)
        cols = gather_columns(lb.columns, lidx, transfers) + \
            gather_columns(rb.columns, ridx, transfers, nullable=outer)
        return ColumnarBatch(cols, lidx.shape[0], self.schema.names)


    def _coalesce(self, cols, lb, rb, lidx, ridx, pairs: int,
                  transfers) -> None:
        """Each left key column of ``cols``: the left key of the first
        ``pairs`` rows (K7), then the right key of the unmatched right rows
        after them (K7), joined by K7c."""
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        lk = [lb.columns[k.ordinal] for k in self.left_keys]
        rk = [rb.columns[k.ordinal] for k in self.right_keys]
        head = gather_columns(lk, lidx[:pairs], transfers)
        tail = gather_columns(rk, ridx[pairs:], transfers)
        names = [f"_k{j}" for j in range(len(lk))]
        joined = concat_batches([
            ColumnarBatch(head, pairs, names),
            ColumnarBatch(tail, lidx.shape[0] - pairs, names)])
        for k, c in zip(self.left_keys, joined.columns):
            cols[k.ordinal] = c


class TorchBroadcastNestedLoopJoinExec(_JoinExec):
    """A cross join: every left row with every right row (K10x, then K7
    for each side); the right side's partitions are joined into one batch
    (K7c) that meets every left partition."""

    def __init__(self, left, right):
        super().__init__(left, right, CROSS)

    def right_partitions(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        batches = [b for part in self.right.execute(ctx) for b in part]
        return [[concat_batches(batches)] if batches else []]

    def node_string(self):
        return "TorchBroadcastNestedLoopJoin[cross]"

    def join_batches(self, lb: ColumnarBatch, rb: ColumnarBatch,
                     transfers) -> ColumnarBatch:
        lidx, ridx = cross_pairs(lb.row_count, rb.row_count, lb.device)
        cols = gather_columns(lb.columns, lidx, transfers) + \
            gather_columns(rb.columns, ridx, transfers)
        return ColumnarBatch(cols, lidx.shape[0], self.schema.names)
