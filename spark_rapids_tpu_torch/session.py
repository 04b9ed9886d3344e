"""Session, DataFrame and GroupedData (the analog of
``spark_rapids_tpu/session.py``, for the recipes the port runs: in-memory
tables, ``filter``, ``select`` and ``with_column`` (``:460``; with window
expressions, extracted as ``_plan_windows`` ``:392`` does), ``join``
(``:637``; inner, left outer, left semi and left anti, on one or several
key columns), ``group_by`` (``:729``), ``rollup`` (``:736``; lowered to
an Expand and a group-by, ``_expand_for_grouping_sets`` ``:973``) and
``agg`` (``count_distinct`` in COMPLETE mode only), ``distinct``
(``:771``), ``order_by`` (``:602``), ``limit`` (``:515``) and
``collect``). A join, a group-by, a window, a sort and a limit run over
one partition.

A session runs on ``cuda:0`` unless it is given ``device="cpu"``; without a
CUDA device and without that, it is refused."""

from __future__ import annotations

from typing import Dict, List, Optional, Union

import torch

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                   batch_from_pydict)
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression,
                                                     bind_references, col)
from spark_rapids_tpu_torch.memory.device_manager import resolve_device
from spark_rapids_tpu_torch.plan import base as L


def _to_expr(e) -> Expression:
    return col(e) if isinstance(e, str) else e


class TorchSession:
    def __init__(self, conf: Optional[Union[C.TorchConf, Dict]] = None,
                 device: Optional[Union[str, torch.device]] = None):
        self.conf = conf if isinstance(conf, C.TorchConf) \
            else C.TorchConf(conf)
        self.device: torch.device = resolve_device(device)
        self.transfers = TransferGateway(self.device)

    def create_dataframe(self, data, num_partitions: int = 1,
                         schema: Optional[T.StructType] = None
                         ) -> "DataFrame":
        if isinstance(data, dict):
            hb = batch_from_pydict(data, schema)
        elif isinstance(data, HostColumnarBatch):
            hb = data
        else:
            raise TypeError(f"cannot create a DataFrame from {type(data)}")
        if num_partitions < 1:
            raise ValueError("num_partitions must be at least 1")
        n = hb.row_count
        per = -(-n // num_partitions) if n else 1
        parts = [[hb.slice(i * per, min(per, n - i * per))]
                 for i in range(num_partitions) if i * per < n] or [[hb]]
        return DataFrame(L.Scan(parts, hb.schema), self)


class DataFrame:
    """A lazy logical plan; actions plan it and run it on the device."""

    def __init__(self, plan: L.LogicalPlan, session: TorchSession):
        self._plan = plan
        self._session = session

    @property
    def schema(self) -> T.StructType:
        return self._plan.schema

    @property
    def columns(self) -> List[str]:
        return self.schema.names

    def filter(self, condition) -> "DataFrame":
        cond = bind_references(_to_expr(condition), self.schema)
        if _windows_in(cond):
            raise ValueError(
                "window expressions are not allowed in filter(); compute "
                "them in a select()/with_column() first")
        return DataFrame(L.Filter(cond, self._plan), self._session)

    where = filter

    def select(self, *exprs) -> "DataFrame":
        bound = [bind_references(_to_expr(e), self.schema) for e in exprs]
        plan, bound = self._plan_windows(bound)
        return DataFrame(L.Project(bound, plan), self._session)

    def with_column(self, name: str, expr) -> "DataFrame":
        """Every column, with ``name`` replaced by (or appended as)
        ``expr``."""
        exprs = [Alias(_to_expr(expr), name) if f.name == name else
                 col(f.name) for f in self.schema.fields]
        if name not in self.columns:
            exprs.append(Alias(_to_expr(expr), name))
        return self.select(*exprs)

    def _plan_windows(self, bound):
        """One logical ``Window`` per (partition, order) spec group of the
        window expressions in ``bound``, each appending its columns; then
        ``bound`` rewritten to read them (the JAX package's
        ``_plan_windows``, ``session.py:392``)."""
        found = [w for e in bound for w in _windows_in(e)]
        if not found:
            return self._plan, bound
        groups = {}
        for w in found:
            groups.setdefault(w.spec.group_key(), []).append(w)
        plan = self._plan
        replacement = {}
        for ws in groups.values():
            base = len(plan.schema)
            plan = L.Window([(f"_w{base + i}", w) for i, w in enumerate(ws)],
                            plan)
            for i, w in enumerate(ws):
                replacement[id(w)] = BoundReference(base + i, w.data_type,
                                                    True, f"_w{base + i}")

        def rewrite(e):
            # top down by identity: transform_up copies nodes first
            if id(e) in replacement:
                return replacement[id(e)]
            if not e.children:
                return e
            return e.with_children([rewrite(c) for c in e.children])

        return plan, [rewrite(e) for e in bound]

    def agg(self, *agg_exprs) -> "DataFrame":
        """Global aggregation (no grouping keys)."""
        return GroupedData(self, []).agg(*agg_exprs)

    def group_by(self, *cols) -> "GroupedData":
        return GroupedData(self, cols)

    groupBy = group_by

    def rollup(self, *cols) -> "GroupedData":
        """GROUP BY ROLLUP(k1..kn): the grouping sets (k1..kn),
        (k1..kn-1), ..., (), as the JAX package's ``rollup`` (``:736``)."""
        sets = [tuple(range(i)) for i in range(len(cols), -1, -1)]
        return GroupedData(self, cols, grouping_sets=sets)

    def distinct(self) -> "DataFrame":
        """The distinct rows: a group-by of every column with no aggregate
        (K9, then K7 for the keys)."""
        return self.group_by(*self.columns).agg()

    drop_duplicates = distinct

    def join(self, other: "DataFrame", on=None, how: str = "inner",
             condition=None) -> "DataFrame":
        """Equi-join on column names with USING semantics, as the JAX
        package's ``join``: the key columns once (the left side's), then
        the other left columns, then the other right columns.  ``how`` is
        ``inner``, ``left_outer`` (``left``, ``leftouter``), ``semi``
        (``leftsemi``, ``left_semi``) or ``anti`` (``leftanti``,
        ``left_anti``); a semi or anti join gives the left columns alone,
        a row each time its key has a match (semi) or none (anti; a null
        key has none, as the JAX package plans ``NOT IN``)."""
        if on is None or condition is not None:
            raise NotImplementedError(
                "a join without keys or with a condition beyond them is not "
                "in the port yet")
        from spark_rapids_tpu_torch.exec.joins import normalize_how
        how = normalize_how(how)
        names = [on] if isinstance(on, str) else list(on)
        lschema, rschema = self.schema, other.schema
        lkeys = [bind_references(col(n), lschema) for n in names]
        rkeys = [bind_references(col(n), rschema) for n in names]
        plan = L.Join(self._plan, other._plan, lkeys, rkeys, how)
        if how in ("left_semi", "left_anti"):
            return DataFrame(plan, self._session)
        out = plan.schema
        nl = len(lschema)

        def ref(i: int, name: str) -> Expression:
            f = out.fields[i]
            return Alias(BoundReference(i, f.data_type, f.nullable, name),
                         name)

        key_l = {lschema.field_index(n) for n in names}
        key_r = {rschema.field_index(n) for n in names}
        exprs = [ref(lschema.field_index(n), n) for n in names]
        exprs += [ref(i, f.name) for i, f in enumerate(lschema.fields)
                  if i not in key_l]
        exprs += [ref(nl + i, f.name) for i, f in enumerate(rschema.fields)
                  if i not in key_r]
        return DataFrame(L.Project(exprs, plan), self._session)

    def order_by(self, *cols, ascending: bool = True) -> "DataFrame":
        """A global sort: names or expressions (``ascending`` applies), or
        ``functions.asc``/``desc`` specs."""
        from spark_rapids_tpu_torch.exec.sort import SortSpec
        specs = []
        for c in cols:
            if isinstance(c, SortSpec):
                specs.append(SortSpec(bind_references(c.expr, self.schema),
                                      c.ascending, c.nulls_first))
            else:
                specs.append(SortSpec(
                    bind_references(_to_expr(c), self.schema), ascending))
        return DataFrame(L.Sort(specs, self._plan), self._session)

    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self._session)

    def executed_plan(self) -> L.Exec:
        from spark_rapids_tpu_torch.plan.overrides import TorchOverrides
        return TorchOverrides().apply(self._plan)

    def explain(self) -> str:
        return "== Logical ==\n" + self._plan.tree_string() + \
            "\n== Physical ==\n" + self.executed_plan().tree_string()

    def collect_batch(self) -> HostColumnarBatch:
        s = self._session
        ctx = L.ExecContext(s.device, s.transfers)
        batches = [b for part in self.executed_plan().execute(ctx)
                   for b in part]
        if len(batches) != 1:
            raise NotImplementedError(
                f"collecting {len(batches)} batches is not in the port yet")
        return s.transfers.download_batch(batches[0])

    def collect(self) -> List[dict]:
        return self.collect_batch().to_rows()


def _windows_in(e: Expression) -> List[Expression]:
    """The window expressions in ``e``'s tree."""
    from spark_rapids_tpu_torch.expressions.window_exprs import \
        WindowExpression
    if isinstance(e, WindowExpression):
        return [e]
    return [w for c in e.children for w in _windows_in(c)]


class GroupedData:
    """Grouping keys of a DataFrame; ``grouping_sets`` (tuples of key
    indices, from ``rollup``) lowers ``agg`` to an Expand and a group-by
    on the keys and the grouping id, as the JAX package's
    ``_agg_grouping_sets`` (``:1111``) does."""

    def __init__(self, df: DataFrame, keys, grouping_sets=None):
        self._df = df
        self._keys = [bind_references(_to_expr(k), df.schema) for k in keys]
        self._grouping_sets = grouping_sets

    def agg(self, *agg_exprs) -> DataFrame:
        from spark_rapids_tpu_torch.exec.aggregate import (COMPLETE, FINAL,
                                                           PARTIAL,
                                                           _AggLayout)
        from spark_rapids_tpu_torch.expressions.aggregates import (
            AggregateExpression, AggregateFunction)
        schema = self._df.schema
        aggs = []
        for e in agg_exprs:
            name = None
            if isinstance(e, Alias):
                name, e = e.alias_name, e.children[0]
            if not isinstance(e, AggregateFunction):
                raise TypeError(f"not an aggregate expression: {e}")
            e = bind_references(e, schema)
            aggs.append(AggregateExpression(e, name or e.sql()))
        if self._grouping_sets is not None:
            return self._agg_grouping_sets(aggs)
        layout = _AggLayout(self._keys, aggs)
        child = self._df._plan
        if child.num_partitions == 1:
            plan = L.Aggregate(layout, COMPLETE, child)
        else:
            partial = L.Aggregate(layout, PARTIAL, child)
            plan = L.Aggregate(layout, FINAL, L.Exchange([partial]))
        return DataFrame(plan, self._df._session)

    def _agg_grouping_sets(self, aggs) -> DataFrame:
        """One Expand projection per grouping set -- each key, or a null
        of its type where the set does not group it; the grouping id
        (LONG; bit ``n - 1 - i`` set when key ``i`` is not grouped, Spark's
        order); then the child columns the aggregates read -- and a
        group-by on the keys and the grouping id, so a null the rollup
        makes never merges with a real null key; the grouping id is then
        dropped (``_expand_for_grouping_sets``, ``:973``)."""
        from spark_rapids_tpu_torch.exec.aggregate import (COMPLETE,
                                                           _AggLayout)
        from spark_rapids_tpu_torch.expressions.aggregates import \
            AggregateExpression
        from spark_rapids_tpu_torch.expressions.base import (Literal,
                                                             output_name)
        child = self._df._plan
        schema = child.schema
        keys = self._keys
        nk = len(keys)
        used = sorted({e.ordinal for a in aggs for e in _refs_in(a.func)})
        moved = {o: nk + 1 + j for j, o in enumerate(used)}
        projections = []
        for s in self._grouping_sets:
            gid = sum(1 << (nk - 1 - i) for i in range(nk) if i not in s)
            proj = [keys[i] if i in s else Literal(None, keys[i].data_type)
                    for i in range(nk)]
            proj.append(Literal(gid, T.LONG))
            proj += [BoundReference(o, schema.types[o],
                                    schema.fields[o].nullable,
                                    schema.names[o]) for o in used]
            projections.append(proj)
        names = [output_name(k) for k in keys] + ["__grouping_id"] + \
            [schema.names[o] for o in used]
        expand = L.Expand(projections, names, child)
        es = expand.schema
        new_keys = [BoundReference(i, es.types[i], True, es.names[i])
                    for i in range(nk + 1)]

        def rebind(node):
            if isinstance(node, BoundReference):
                return BoundReference(moved[node.ordinal], node.data_type,
                                      node.nullable, node.ref_name)
            return node
        aggs = [AggregateExpression(a.func.transform_up(rebind), a.out_name)
                for a in aggs]
        if child.num_partitions != 1:
            raise NotImplementedError(
                "a rollup over several partitions is not in the port yet")
        plan = L.Aggregate(_AggLayout(new_keys, aggs), COMPLETE, expand)
        out = plan.schema
        keep = [i for i in range(len(out)) if i != nk]
        return DataFrame(L.Project(
            [Alias(BoundReference(i, out.types[i], out.fields[i].nullable,
                                  out.names[i]), out.names[i])
             for i in keep], plan), self._df._session)


def _refs_in(e: Expression) -> List[BoundReference]:
    """The column references in ``e``'s tree."""
    if isinstance(e, BoundReference):
        return [e]
    return [r for c in e.children for r in _refs_in(c)]
