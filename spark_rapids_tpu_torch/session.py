"""Session, DataFrame and GroupedData (the analog of
``spark_rapids_tpu/session.py``, for the recipes the port runs: in-memory
tables and parquet files (``read.parquet``, ``:217``), ``filter``,
``select`` and ``with_column`` (``:460``; with window
expressions, extracted as ``_plan_windows`` ``:392`` does), ``join``
(``:637``; inner, left, right and full outer, left semi and left anti, on
one or several key columns, and cross), ``group_by`` (``:729``), ``rollup`` (``:736``;
lowered to an Expand and a group-by, ``_expand_for_grouping_sets``
``:973``) and ``agg`` (``grouping()`` after a rollup) or ``count``
(``:1253``), ``distinct``
(``:771``), ``order_by`` (``:602``), ``limit`` (``:515``), ``union``
(``:539``), ``intersect`` (``:495``; a null-safe semi join), ``collect``
and ``scalar``).

Over several partitions each operator is planned behind an exchange
(``plan/partitioning.py``, ``exec/exchange.py``), as the JAX package
plans it: a group-by as PARTIAL, a hash exchange on the keys (one
partition without keys) and FINAL (``:1095-1108``; a rollup so over its
Expand, with the grouping id among the keys, ``:1110-1131``); a
``count(DISTINCT)``, which needs COMPLETE mode, behind a hash exchange
of the raw rows by the keys, or one partition without keys
(``:1083-1094``); a join with both sides hash-exchanged on their keys
(``:677-690``); a sort behind a range exchange (``:610-626``); a window
behind a hash exchange on its partition keys (``:416-425``).  A limit
takes the partitions in order.

A session runs on ``cuda:0`` unless it is given ``device="cpu"``; without a
CUDA device and without that, it is refused.  The first session of a
process initializes the memory runtime (``memory/device_manager.py``)
with its conf's pool; the out-of-core paths of the sort, the window and
the FINAL group-by read its headroom."""

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
from spark_rapids_tpu_torch.memory.device_manager import (initialize,
                                                          resolve_device)
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
        # the process's memory runtime: the first session shapes it
        initialize(self.conf, self.device)

    @property
    def read(self) -> "_Reader":
        """File readers: ``session.read.parquet(*paths, columns=None)``."""
        return _Reader(self)

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
        for name, dt in zip(hb.names, hb.schema.types):
            if isinstance(dt, T.ArrayType):
                raise NotImplementedError(
                    f"an {dt} input column ({name}) is not in the port yet "
                    "(an array is an output of collect_list and "
                    "collect_set only)")
        n = hb.row_count
        per = -(-n // num_partitions) if n else 1
        parts = [[hb.slice(i * per, min(per, n - i * per))]
                 for i in range(num_partitions) if i * per < n] or [[hb]]
        return DataFrame(L.Scan(parts, hb.schema), self)


class _Reader:
    """``TorchSession.read`` (the JAX package's ``session.py:217``)."""

    def __init__(self, session: TorchSession):
        self._s = session

    def parquet(self, *paths, columns=None) -> "DataFrame":
        """Parquet files, directories or globs, read by the strategy of
        ``spark.rapids.sql.format.parquet.reader.type``; ``columns``
        prunes the read.  With ``spark.rapids.sql.encoding.enabled`` their
        string columns reach the card as dictionary codes."""
        from spark_rapids_tpu_torch.io.parquet import CpuParquetScan
        conf = self._s.conf
        scan = CpuParquetScan(
            list(paths), columns,
            batch_rows=conf.get_int(C.MAX_READER_BATCH_SIZE_ROWS),
            reader_type=conf.get(C.READER_TYPE),
            num_threads=conf.get_int(C.MULTITHREADED_READ_NUM_THREADS))
        return DataFrame(L.FileScan(scan), self._s)


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
        from spark_rapids_tpu_torch.plan.partitioning import (
            HashPartitioning, SinglePartitioning)
        groups = {}
        for w in found:
            groups.setdefault(w.spec.group_key(), []).append(w)
        plan = self._plan
        replacement = {}
        for ws in groups.values():
            n = plan.num_partitions
            if n > 1:
                keys = ws[0].spec.partition_exprs
                plan = L.Exchange(HashPartitioning(keys, n) if keys
                                  else SinglePartitioning(), plan)
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
             condition=None, null_safe: bool = False) -> "DataFrame":
        """Equi-join on column names with USING semantics, as the JAX
        package's ``join``: the key columns once (the left side's; the
        right side's for a right outer join, their coalesce for a full
        one), then the other left columns, then the other right columns.
        ``how`` is ``inner``, ``left_outer`` (``left``, ``leftouter``),
        ``right_outer`` (``right``, ``rightouter``), ``full_outer``
        (``full``, ``fullouter``, ``outer``), ``semi`` (``leftsemi``,
        ``left_semi``) or ``anti`` (``leftanti``, ``left_anti``); a semi or
        anti join gives the left columns alone, a row each time its key
        has a match (semi) or none (anti; a null key has none, as the JAX
        package plans ``NOT IN``).  ``on`` may also be ``(left name, right
        name)`` pairs: SQL's ``ON l1 = r1 AND ...``, every left column
        then every right column, whose names must differ.
        ``how="cross"`` takes no keys: every left row with every right
        row, the left columns then the right ones (``from a, b``).  With
        ``null_safe`` every key compares with ``<=>``: a null equals a
        null (K10's null-safe mode)."""
        from spark_rapids_tpu_torch.exec.joins import (CROSS, hash_as_long,
                                                       normalize_how)
        from spark_rapids_tpu_torch.plan.partitioning import \
            HashPartitioning
        if condition is not None:
            raise NotImplementedError(
                "a join with a condition beyond its keys is not in the port "
                "yet")
        how = normalize_how(how)
        if how == CROSS:
            if on is not None:
                raise ValueError("a cross join takes no keys")
            return DataFrame(L.Join(self._plan, other._plan, [], [], how),
                             self._session)
        if on is None:
            raise NotImplementedError(
                f"a {how} join without keys is not in the port yet (a "
                "cross join is)")
        names = [on] if isinstance(on, str) else list(on)
        pairs = all(isinstance(n, tuple) for n in names)
        if pairs != any(isinstance(n, tuple) for n in names):
            raise ValueError("join keys are all names or all pairs")
        if pairs:
            lnames = [a for a, _b in names]
            rnames = [b for _a, b in names]
            clash = set(self.columns) & set(other.columns)
            if clash and how not in ("left_semi", "left_anti"):
                raise ValueError(f"a join ON key pairs keeps both sides' "
                                 f"columns: rename {sorted(clash)}")
        else:
            lnames = rnames = names
        lschema, rschema = self.schema, other.schema
        lkeys = [bind_references(col(n), lschema) for n in lnames]
        rkeys = [bind_references(col(n), rschema) for n in rnames]
        coalesce = how == "full_outer" and not pairs
        if how in ("right_outer", "full_outer") and not pairs:
            for n, a, b in zip(names, lkeys, rkeys):
                if a.data_type != b.data_type:
                    raise TypeError(
                        f"join key type mismatch on {n}: {a.data_type} vs "
                        f"{b.data_type}; add explicit casts")
        lplan, rplan = self._plan, other._plan
        nparts = max(lplan.num_partitions, rplan.num_partitions)
        if nparts > 1:
            wide = hash_as_long(lkeys, rkeys)
            lplan = L.Exchange(HashPartitioning(lkeys, nparts, wide), lplan)
            rplan = L.Exchange(HashPartitioning(rkeys, nparts, wide), rplan)
        plan = L.Join(lplan, rplan, lkeys, rkeys, how, coalesce,
                      bool(null_safe))
        if how in ("left_semi", "left_anti") or pairs:
            return DataFrame(plan, self._session)
        out = plan.schema
        nl = len(lschema)

        def ref(i: int, name: str) -> Expression:
            f = out.fields[i]
            return Alias(BoundReference(i, f.data_type, f.nullable, name),
                         name)

        key_l = {lschema.field_index(n) for n in names}
        key_r = {rschema.field_index(n) for n in names}
        # a right outer join's keys are the right side's; a full one's are
        # the coalesce its join exec writes into the left key columns
        exprs = [ref(nl + rschema.field_index(n), n)
                 if how == "right_outer" else ref(lschema.field_index(n), n)
                 for n in names]
        exprs += [ref(i, f.name) for i, f in enumerate(lschema.fields)
                  if i not in key_l]
        exprs += [ref(nl + i, f.name) for i, f in enumerate(rschema.fields)
                  if i not in key_r]
        return DataFrame(L.Project(exprs, plan), self._session)

    def union(self, other: "DataFrame") -> "DataFrame":
        """UNION ALL (the JAX package's ``union``, ``:539``): the rows of
        both, ``self``'s partitions then ``other``'s, with ``self``'s
        column names; the columns match by position and type.  No device
        work (``exec/basic.py TorchUnionExec``)."""
        if [f.data_type for f in self.schema.fields] != \
                [f.data_type for f in other.schema.fields]:
            raise TypeError(f"a union of {self.schema.types} and "
                            f"{other.schema.types}: add explicit casts")
        return DataFrame(L.Union([self._plan, other._plan]), self._session)

    def intersect(self, other: "DataFrame") -> "DataFrame":
        """INTERSECT (DISTINCT), as the JAX package plans it (``:495``):
        the distinct rows of ``self``, then a null-safe left semi join
        with ``other`` on every column by name (K9, K7, then K10's
        null-safe semi mode)."""
        return self.distinct().join(other, on=list(self.columns),
                                    how="left_semi", null_safe=True)

    def order_by(self, *cols, ascending: bool = True) -> "DataFrame":
        """A global sort: names or expressions (``ascending`` applies), or
        ``functions.asc``/``desc`` specs; over several partitions behind a
        range exchange, so the partitions come out in order."""
        from spark_rapids_tpu_torch.exec.sort import SortSpec
        from spark_rapids_tpu_torch.plan.partitioning import \
            RangePartitioning
        specs = []
        for c in cols:
            if isinstance(c, SortSpec):
                specs.append(SortSpec(bind_references(c.expr, self.schema),
                                      c.ascending, c.nulls_first))
            else:
                specs.append(SortSpec(
                    bind_references(_to_expr(c), self.schema), ascending))
        plan = self._plan
        if plan.num_partitions > 1:
            plan = L.Exchange(RangePartitioning(specs,
                                                plan.num_partitions), plan)
        return DataFrame(L.Sort(specs, plan), self._session)

    sort = order_by

    def limit(self, n: int) -> "DataFrame":
        return DataFrame(L.Limit(n, self._plan), self._session)

    def executed_plan(self) -> L.Exec:
        from spark_rapids_tpu_torch.plan.overrides import TorchOverrides
        return TorchOverrides(self._session.conf).apply(self._plan)

    def explain(self) -> str:
        return "== Logical ==\n" + self._plan.tree_string() + \
            "\n== Physical ==\n" + self.executed_plan().tree_string()

    def collect_batch(self) -> HostColumnarBatch:
        """The rows of every partition in order, joined on the device
        (K7c) and downloaded once."""
        from spark_rapids_tpu_torch.ops.batch_ops import (concat_batches,
                                                          empty_batch)
        from spark_rapids_tpu_torch.columnar import encoding as ENC
        s = self._session
        ctx = L.ExecContext(s.device, s.transfers)
        batches = [b for part in self.executed_plan().execute(ctx)
                   for b in part]
        if any(ENC.batch_has_encoded(b) for b in batches):
            # dictionary columns come back as codes (late
            # materialization up to the result)
            whole = ENC.concat_encoded(batches, s.transfers) \
                if len(batches) > 1 else batches[0]
        else:
            whole = concat_batches(batches) if batches else \
                empty_batch(self.schema, s.device)
        return s.transfers.download_batch(whole)

    def collect(self) -> List[dict]:
        return self.collect_batch().to_rows()

    def scalar(self):
        """An eager scalar subquery (the JAX analyzer's, ``sql/
        analyzer.py:1174-1190``): the plan runs and its rows come back
        through the one counted download; the first column of the first
        row, or None when there is no row.  With several rows it takes
        the first, as the JAX package does (Spark would raise)."""
        rows = self.collect()
        return next(iter(rows[0].values())) if rows else None


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
        from spark_rapids_tpu_torch.exec.aggregate import _AggLayout
        from spark_rapids_tpu_torch.expressions.aggregates import (
            AggregateExpression, AggregateFunction)
        schema = self._df.schema
        aggs, outputs = [], []
        for e in agg_exprs:
            name = None
            if isinstance(e, Alias):
                name, e = e.alias_name, e.children[0]
            e = bind_references(e, schema)
            if _groupings_in(e) and not isinstance(e, AggregateFunction):
                if self._grouping_sets is None:
                    raise ValueError("grouping() needs a rollup")
                if _refs_outside_groupings(e):
                    raise NotImplementedError(
                        f"{e.sql()}: only grouping() calls and literals "
                        "can be combined in agg() in the port yet")
                outputs.append((name or e.sql(), e))
                continue
            if not isinstance(e, AggregateFunction):
                raise TypeError(f"not an aggregate expression: {e}")
            outputs.append((name or e.sql(), len(aggs)))
            aggs.append(AggregateExpression(e, name or e.sql()))
        if self._grouping_sets is not None:
            return self._agg_grouping_sets(aggs, outputs)
        layout = _AggLayout(self._keys, aggs)
        return DataFrame(_plan_aggregate(layout, self._df._plan),
                         self._df._session)

    def count(self) -> DataFrame:
        """The keys and ``count(1)`` as ``count`` (JAX ``session.py:1253``):
        K9's count of every row."""
        from spark_rapids_tpu_torch.expressions.aggregates import Count
        from spark_rapids_tpu_torch.expressions.base import Literal
        return self.agg(Alias(Count(Literal(1, T.INT)), "count"))

    def _agg_grouping_sets(self, aggs, outputs) -> DataFrame:
        """One Expand projection per grouping set -- each key, or a null
        of its type where the set does not group it; the grouping id
        (LONG; bit ``n - 1 - i`` set when key ``i`` is not grouped, Spark's
        order); then the child columns the aggregates read -- and a
        group-by on the keys and the grouping id, so a null the rollup
        makes never merges with a real null key (``_expand_for_grouping_
        sets``, ``:973``).  The output is the keys, then ``outputs`` in
        order: ``(name, index into aggs)`` for an aggregate, ``(name,
        expression)`` for one over ``grouping(k)`` calls, each of which
        becomes ``(gid div 2^(n - 1 - i)) % 2`` for key ``i``, the JAX
        analyzer's ``_grouping_bit`` (``sql/analyzer.py:810``); the
        grouping id is read by those and then dropped."""
        from spark_rapids_tpu_torch.exec.aggregate import _AggLayout
        from spark_rapids_tpu_torch.expressions.aggregates import \
            AggregateExpression
        from spark_rapids_tpu_torch.expressions.arithmetic import (
            IntegralDivide, Remainder)
        from spark_rapids_tpu_torch.expressions.base import (Grouping,
                                                             Literal,
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
        plan = _plan_aggregate(_AggLayout(new_keys, aggs), expand)
        out = plan.schema

        def ref(i: int) -> Expression:
            return BoundReference(i, out.types[i], out.fields[i].nullable,
                                  out.names[i])
        key_sql = [k.sql() for k in keys]

        def bit(node):
            if not isinstance(node, Grouping):
                return node
            k = node.children[0].sql()
            if k not in key_sql:
                raise ValueError(f"{node.sql()}: {k} is not a grouping key")
            return Remainder(IntegralDivide(
                ref(nk), Literal(1 << (nk - 1 - key_sql.index(k)), T.LONG)),
                Literal(2, T.LONG))
        exprs = [Alias(ref(i), out.names[i]) for i in range(nk)]
        for name, o in outputs:
            exprs.append(Alias(ref(nk + 1 + o) if isinstance(o, int)
                               else o.transform_up(bit), name))
        return DataFrame(L.Project(exprs, plan), self._df._session)


def _plan_aggregate(layout, child: L.LogicalPlan) -> L.LogicalPlan:
    """A group-by (or a global aggregate) of ``child``: COMPLETE over one
    partition; over several, PARTIAL, an exchange on the buffer keys by
    hash (one partition without keys) and FINAL; an aggregation with a
    ``count(DISTINCT)``, ``collect_list`` or ``collect_set`` COMPLETE
    behind an exchange of the raw rows by the keys (one partition without
    keys), as ``requires_complete`` aggregates are planned (JAX
    ``session.py:1083-1108``)."""
    from spark_rapids_tpu_torch.exec.aggregate import (COMPLETE, FINAL,
                                                       PARTIAL)
    from spark_rapids_tpu_torch.plan.partitioning import (
        HashPartitioning, SinglePartitioning)
    n = child.num_partitions
    if n == 1:
        return L.Aggregate(layout, COMPLETE, child)
    nk = layout.num_keys
    if layout.requires_complete:
        part = HashPartitioning(layout.grouping, n) if nk \
            else SinglePartitioning()
        return L.Aggregate(layout, COMPLETE, L.Exchange(part, child))
    partial = L.Aggregate(layout, PARTIAL, child)
    schema = partial.schema
    keys = [BoundReference(i, schema.types[i], schema.fields[i].nullable,
                           schema.names[i]) for i in range(nk)]
    part = HashPartitioning(keys, n) if nk else SinglePartitioning()
    return L.Aggregate(layout, FINAL, L.Exchange(part, partial))


def _groupings_in(e: Expression) -> bool:
    """``e``'s tree holds a ``grouping(k)`` call."""
    from spark_rapids_tpu_torch.expressions.base import Grouping
    return isinstance(e, Grouping) or any(_groupings_in(c)
                                          for c in e.children)


def _refs_outside_groupings(e: Expression) -> List[BoundReference]:
    """The column references in ``e``'s tree that no ``grouping()``
    holds."""
    from spark_rapids_tpu_torch.expressions.base import Grouping
    if isinstance(e, Grouping):
        return []
    if isinstance(e, BoundReference):
        return [e]
    return [r for c in e.children for r in _refs_outside_groupings(c)]


def _refs_in(e: Expression) -> List[BoundReference]:
    """The column references in ``e``'s tree."""
    if isinstance(e, BoundReference):
        return [e]
    return [r for c in e.children for r in _refs_in(c)]
