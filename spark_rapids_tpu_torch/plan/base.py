"""Plan nodes (the analog of ``spark_rapids_tpu/plan/base.py``).

Two trees: the logical plan a DataFrame builds (``Scan``, ``Filter``,
``Project``, ``Aggregate``, ``Exchange``, ``Join``, ``Union``, ``Sort``,
``Limit``, ``CteCache``, ``Window``, ``Expand``),
and the physical ``Exec`` tree
the planner (``plan/overrides.py``) turns it into.  An exec's ``execute``
returns its output partitions, each a list of device batches."""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   HostColumnarBatch)
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.expressions.base import Expression, output_name

Partitions = List[List[ColumnarBatch]]


class ExecContext:
    """What one action runs with: its device and the transfer gateway."""

    def __init__(self, device: torch.device, transfers: TransferGateway):
        self.device = device
        self.transfers = transfers


class _Node:
    children: List

    def node_string(self) -> str:
        return type(self).__name__

    def tree_string(self, depth: int = 0) -> str:
        lines = ["  " * depth + ("+- " if depth else "") + self.node_string()]
        lines += [c.tree_string(depth + 1) for c in self.children]
        return "\n".join(lines)


class Exec(_Node):
    def __init__(self, children: Sequence["Exec"] = ()):
        self.children: List[Exec] = list(children)

    @property
    def schema(self) -> T.StructType:
        raise NotImplementedError

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions

    def execute(self, ctx: ExecContext) -> Partitions:
        raise NotImplementedError(f"{type(self).__name__}.execute")

    def transform_up(self, fn: Callable[["Exec"], "Exec"]) -> "Exec":
        if self.children:
            kids = [c.transform_up(fn) for c in self.children]
            if any(k is not c for k, c in zip(kids, self.children)):
                self.children = kids
        return fn(self)


class UnaryExec(Exec):
    def __init__(self, child: Exec):
        super().__init__([child])

    @property
    def child(self) -> Exec:
        return self.children[0]

    @property
    def schema(self):
        return self.child.schema


class LeafExec(Exec):
    def __init__(self):
        super().__init__([])


# -- logical plan ------------------------------------------------------------

class LogicalPlan(_Node):
    def __init__(self, children: Sequence["LogicalPlan"] = ()):
        self.children: List[LogicalPlan] = list(children)

    @property
    def schema(self) -> T.StructType:
        return self.children[0].schema

    @property
    def num_partitions(self) -> int:
        return self.children[0].num_partitions


class Scan(LogicalPlan):
    """In-memory host partitions.  ``device_cache`` keeps their device copy
    after the first action, keyed by device, so the table stays resident
    across actions."""

    def __init__(self, partitions: Sequence[Sequence[HostColumnarBatch]],
                 schema: T.StructType):
        super().__init__()
        self.partitions = [list(p) for p in partitions]
        self._schema = schema
        self.device_cache: Dict[str, Partitions] = {}

    @property
    def schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return len(self.partitions)

    def node_string(self):
        rows = sum(b.row_count for p in self.partitions for b in p)
        return f"Scan[{self.num_partitions}p, {rows} rows]"


class Filter(LogicalPlan):
    def __init__(self, condition: Expression, child: LogicalPlan):
        super().__init__([child])
        self.condition = condition

    def node_string(self):
        return f"Filter[{self.condition.sql()}]"


class Project(LogicalPlan):
    def __init__(self, exprs: Sequence[Expression], child: LogicalPlan):
        super().__init__([child])
        self.exprs = list(exprs)

    @property
    def schema(self):
        return T.StructType([T.StructField(output_name(e), e.data_type,
                                           e.nullable) for e in self.exprs])

    def node_string(self):
        return f"Project[{', '.join(e.sql() for e in self.exprs)}]"


class Aggregate(LogicalPlan):
    """One stage of an aggregation: ``mode`` is partial, final or
    complete (exec/aggregate.py)."""

    def __init__(self, layout, mode: str, child: LogicalPlan):
        super().__init__([child])
        self.layout = layout
        self.mode = mode

    @property
    def schema(self):
        from spark_rapids_tpu_torch.exec.aggregate import PARTIAL
        return self.layout.buffer_schema if self.mode == PARTIAL \
            else self.layout.result_schema

    @property
    def num_partitions(self):
        return self.children[0].num_partitions

    def node_string(self):
        aggs = ", ".join(a.out_name for a in self.layout.aggs)
        return f"Aggregate[{self.mode}, keys={self.layout.num_keys}, {aggs}]"


class Exchange(LogicalPlan):
    """Moves the child's rows to the partitions ``partitioning``
    (``plan/partitioning.py``) gives them: one partition, by hash or by
    range."""

    def __init__(self, partitioning, child: LogicalPlan):
        super().__init__([child])
        self.partitioning = partitioning

    @property
    def num_partitions(self):
        return self.partitioning.num_partitions

    def node_string(self):
        return f"Exchange[{self.partitioning.desc()}]"


def join_schema(left: T.StructType, right: T.StructType,
                how: str) -> T.StructType:
    """A join's columns: the left ones, then the right ones; a left or
    full outer join makes the right ones nullable, a right or full outer
    join the left ones; a left semi or anti join has the left ones alone
    (JAX ``exec/joins.py:122-133``)."""
    if how in ("left_semi", "left_anti"):
        return left

    def side(schema, null):
        return [T.StructField(f.name, f.data_type, True) if null else f
                for f in schema.fields]
    return T.StructType(side(left, how in ("right_outer", "full_outer")) +
                        side(right, how in ("left_outer", "full_outer")))


class Join(LogicalPlan):
    """An equi-join (``how`` is ``inner``, ``left_outer``,
    ``right_outer``, ``full_outer``, ``left_semi`` or ``left_anti``), or a
    cross join with no keys (``cross``); its output is the left columns,
    then the right (the left alone for semi and anti).  With
    ``coalesce_keys`` (a full outer join with USING keys) the left key
    columns hold the coalesce of the two sides' keys.  With ``null_safe``
    a null key equals a null key (``<=>``)."""

    def __init__(self, left: LogicalPlan, right: LogicalPlan,
                 left_keys: Sequence[Expression],
                 right_keys: Sequence[Expression], how: str,
                 coalesce_keys: bool = False, null_safe: bool = False):
        super().__init__([left, right])
        self.left_keys = list(left_keys)
        self.right_keys = list(right_keys)
        self.how = how
        self.coalesce_keys = coalesce_keys
        self.null_safe = null_safe

    @property
    def schema(self):
        return join_schema(self.children[0].schema, self.children[1].schema,
                           self.how)

    @property
    def num_partitions(self):
        return max(c.num_partitions for c in self.children)

    def node_string(self):
        op = "<=>" if self.null_safe else "="
        keys = ", ".join(f"{a.sql()} {op} {b.sql()}"
                         for a, b in zip(self.left_keys, self.right_keys))
        return f"Join[{self.how}, {keys}]"


class Union(LogicalPlan):
    """UNION ALL: the children's partitions one after another, the first
    child's schema (a column is nullable if it is in any child)."""

    @property
    def schema(self):
        first = self.children[0].schema
        return T.StructType([
            T.StructField(f.name, f.data_type,
                          any(c.schema.fields[j].nullable
                              for c in self.children))
            for j, f in enumerate(first.fields)])

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def node_string(self):
        return f"Union[{len(self.children)}]"


class Sort(LogicalPlan):
    """A global sort by ``specs`` (``exec/sort.py SortSpec``)."""

    def __init__(self, specs, child: LogicalPlan):
        super().__init__([child])
        self.specs = list(specs)

    def node_string(self):
        return f"Sort[{', '.join(s.sql() for s in self.specs)}]"


class Limit(LogicalPlan):
    """The first ``n`` rows, of the child's partitions in order: one
    partition."""

    def __init__(self, n: int, child: LogicalPlan):
        super().__init__([child])
        self.n = int(n)

    @property
    def num_partitions(self):
        return 1

    def node_string(self):
        return f"Limit[{self.n}]"


class CteCache(LogicalPlan):
    """A plan that several branches of one query read (a ``WITH`` name used
    twice, as the JAX package's analyzer wraps it, ``sql/analyzer.py:351``):
    planned once, its child runs once per action."""

    def node_string(self):
        return "CteCache"


class Expand(LogicalPlan):
    """One output batch per projection over each input batch, all of one
    schema (``names``): a grouping-set query's fan-out (the JAX package's
    ``exec/expand.py``); each projection holds column references and
    literals."""

    def __init__(self, projections, names, child: LogicalPlan):
        super().__init__([child])
        self.projections = [list(p) for p in projections]
        self.names = list(names)

    @property
    def schema(self):
        first = self.projections[0]
        return T.StructType([
            T.StructField(name, e.data_type,
                          any(p[j].nullable for p in self.projections))
            for j, (name, e) in enumerate(zip(self.names, first))])

    def node_string(self):
        return f"Expand[{len(self.projections)} projections]"


class Window(LogicalPlan):
    """Window columns that share one partition and order spec, appended to
    the child's columns: ``window_cols`` is ``[(name, WindowExpression)]``
    (``session.py`` extracts them from a projection, as the JAX package's
    ``_plan_windows`` does)."""

    def __init__(self, window_cols, child: LogicalPlan):
        super().__init__([child])
        self.window_cols = list(window_cols)

    @property
    def schema(self):
        return T.StructType(list(self.children[0].schema.fields) + [
            T.StructField(name, w.data_type, True)
            for name, w in self.window_cols])

    def node_string(self):
        cols = ", ".join(f"{w.sql()} AS {name}"
                         for name, w in self.window_cols)
        return f"Window[{cols}]"
