"""Aggregation layout, the final aggregate and the keyed aggregate (the
analog of ``spark_rapids_tpu/exec/aggregate.py``).

The update pass of a partial or complete global aggregate runs fused with
its filter/project chain (exec/fused.py).  The FINAL exec concatenates the
partitions' partial rows, merges them with kernel 2 under the merge kinds,
and evaluates the final projection, as ``TpuHashAggregateExec(FINAL)``
does through ``merge_partials_out_of_core`` (``:173``).

``TorchKeyedAggregateExec`` is a COMPLETE group-by over one partition: K9
(``ops/agg_ops.py keyed_aggregate``) groups the rows and folds sum and
count per group, writing each aggregate's result and its validity (a sum
of no present value is null, as Spark has it), and K7 gathers the key
columns from each group's first row.  An average folds a double sum and a
count, and K6 (exec/fused.py) evaluates its final expression over the
groups.  Groups come out in order of first appearance."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.aggregates import (
    AggregateExpression, BufferSpec)
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression, output_name)
from spark_rapids_tpu_torch.plan.base import ExecContext, Partitions, \
    UnaryExec

PARTIAL, FINAL, COMPLETE = "partial", "final", "complete"
#: the update kind of a count(DISTINCT)'s buffer, and its keyed_inputs kind
DISTINCT = "distinct"


class _AggLayout:
    """Buffer layout shared by every stage of one aggregation."""

    def __init__(self, grouping: Sequence[Expression],
                 aggs: Sequence[AggregateExpression]):
        self.grouping = list(grouping)
        self.aggs = list(aggs)
        self.num_keys = len(self.grouping)
        self.flat: List[Tuple[int, BufferSpec]] = []
        for ai, a in enumerate(self.aggs):
            for spec in a.func.buffers():
                self.flat.append((ai, spec))

    @property
    def has_distinct(self) -> bool:
        """A ``count(DISTINCT)`` is among the aggregates (K15d's)."""
        return any(spec.update_kind == DISTINCT for _ai, spec in self.flat)

    def key_name(self, i: int) -> str:
        return output_name(self.grouping[i])

    def buffer_name(self, j: int) -> str:
        ai, spec = self.flat[j]
        return f"{self.aggs[ai].out_name}#{spec.name}"

    @property
    def buffer_names(self) -> List[str]:
        return [self.key_name(i) for i in range(self.num_keys)] + \
            [self.buffer_name(j) for j in range(len(self.flat))]

    @property
    def buffer_schema(self) -> T.StructType:
        fields = [T.StructField(self.key_name(i), self.grouping[i].data_type,
                                self.grouping[i].nullable)
                  for i in range(self.num_keys)]
        fields += [T.StructField(self.buffer_name(j), spec.dtype, True)
                   for j, (_ai, spec) in enumerate(self.flat)]
        return T.StructType(fields)

    @property
    def result_schema(self) -> T.StructType:
        fields = [T.StructField(self.key_name(i), self.grouping[i].data_type,
                                self.grouping[i].nullable)
                  for i in range(self.num_keys)]
        fields += [T.StructField(a.out_name, a.func.data_type,
                                 a.func.nullable) for a in self.aggs]
        return T.StructType(fields)

    def update_input_exprs(self) -> List[Expression]:
        """Keys, then one input per buffer, cast so that a sum's input type
        is its buffer type."""
        from spark_rapids_tpu_torch.expressions.cast import Cast
        out = list(self.grouping)
        for ai, spec in self.flat:
            e = self.aggs[ai].func.inputs()[spec.input_ordinal]
            if spec.update_kind == "sum" and e.data_type != spec.dtype:
                e = Cast(e, spec.dtype)
            out.append(e)
        return out

    def update_specs(self):
        return [(self.num_keys + j, spec.update_kind, spec.count_valid_only,
                 spec.dtype) for j, (_ai, spec) in enumerate(self.flat)]

    def merge_specs(self):
        return [(self.num_keys + j, spec.merge_kind, spec.count_valid_only,
                 spec.dtype) for j, (_ai, spec) in enumerate(self.flat)]

    def final_exprs(self) -> List[Expression]:
        exprs: List[Expression] = []
        for i in range(self.num_keys):
            exprs.append(Alias(BoundReference(
                i, self.grouping[i].data_type, self.grouping[i].nullable),
                self.key_name(i)))
        j = 0
        for a in self.aggs:
            refs = []
            for spec in a.func.buffers():
                refs.append(BoundReference(self.num_keys + j, spec.dtype,
                                           True))
                j += 1
            exprs.append(Alias(a.func.evaluate(refs), a.out_name))
        return exprs


def merge_partials(layout: _AggLayout, partials: Sequence[ColumnarBatch]
                   ) -> ColumnarBatch:
    """One buffer row from the partial rows (kernel 2, merge kinds)."""
    from spark_rapids_tpu_torch.ops.agg_ops import global_aggregate
    from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
    return global_aggregate(concat_batches(partials), layout.merge_specs(),
                            layout.buffer_names)


def finish(layout: _AggLayout, buffers: ColumnarBatch) -> ColumnarBatch:
    """The final projection, e.g. ``If(cnt > 0, sum, NULL)``: torch glue
    over one row on this slice."""
    from spark_rapids_tpu_torch.expressions.evaluator import eval_exprs
    return eval_exprs(layout.final_exprs(), buffers)


class TorchHashAggregateExec(UnaryExec):
    def __init__(self, layout: _AggLayout, mode: str, child):
        super().__init__(child)
        self.layout = layout
        self.mode = mode

    @property
    def schema(self):
        return self.layout.buffer_schema if self.mode == PARTIAL else \
            self.layout.result_schema

    def node_string(self):
        aggs = ", ".join(a.out_name for a in self.layout.aggs)
        return (f"TorchHashAggregate[{self.mode}, "
                f"keys={self.layout.num_keys}, {aggs}]")

    def execute(self, ctx: ExecContext) -> Partitions:
        if self.mode != FINAL:
            raise NotImplementedError(
                "the update pass runs fused with its chain (exec/fused.py)")
        out = []
        for part in self.child.execute(ctx):
            if part:
                out.append([finish(self.layout,
                                   merge_partials(self.layout, part))])
        return out


def distinct_input(f) -> int:
    """The input ordinal of ``count(DISTINCT x)``: ``x`` must be a column
    of a type K15d takes; raises NotImplementedError, naming it, else."""
    from spark_rapids_tpu_torch.ops import agg_ops as G
    e = f.children[0]
    if not isinstance(e, BoundReference):
        raise NotImplementedError(
            f"{f.sql()}: a distinct count of an expression is not in the "
            "port yet (of a column is)")
    if e.data_type not in G.KEY_CODES:
        raise NotImplementedError(
            f"{f.sql()}: a distinct count of {e.data_type} is not in the "
            "port yet (int, date, long, double and string are)")
    return e.ordinal


def keyed_inputs(layout: _AggLayout):
    """``[(input ordinal or None, K9 kind or DISTINCT, result type)]``:
    one K9 aggregate for a sum or a count, two (a double sum and a count
    of present values) for an average, and a K15d count (``DISTINCT``)
    for a ``count(DISTINCT)``.  Raises NotImplementedError, naming it,
    for what K9 and K15d cannot fold yet."""
    from spark_rapids_tpu_torch.expressions.aggregates import (
        Average, Count, CountDistinct, Sum)
    from spark_rapids_tpu_torch.expressions.base import Literal
    from spark_rapids_tpu_torch.ops import agg_ops as G
    for k in layout.grouping:
        if not isinstance(k, BoundReference):
            raise NotImplementedError(
                f"a grouping key that is an expression ({k.sql()}) is not "
                "in the port yet")
        if k.data_type not in G.KEYED_KEY_TYPES:
            raise NotImplementedError(
                f"a grouping key of {k.data_type} is not in the port yet "
                "(int, date, long, double and string keys are)")
    out = []
    for a in layout.aggs:
        f = a.func
        e = f.children[0]
        if isinstance(f, CountDistinct):
            out.append((distinct_input(f), DISTINCT, T.LONG))
            continue
        if isinstance(f, Count) and isinstance(e, Literal) and \
                e.value is not None:
            out.append((None, G.KEYED_COUNT_ALL, T.LONG))
            continue
        if not isinstance(e, BoundReference) or \
                not isinstance(f, (Sum, Count, Average)):
            raise NotImplementedError(
                f"aggregate {f.sql()} in a group-by is not in the port yet "
                "(sum, count and avg of a column are)")
        if isinstance(f, Count):
            out.append((e.ordinal, G.KEYED_COUNT, T.LONG))
        elif isinstance(f, Average):
            # K9 converts an int or long input to double row by row
            out.append((e.ordinal, G.KEYED_SUM_F64, T.DOUBLE))
            out.append((e.ordinal, G.KEYED_COUNT, T.LONG))
        elif f.data_type.is_floating:
            out.append((e.ordinal, G.KEYED_SUM_F64, T.DOUBLE))
        else:
            # K9 widens int to long itself
            out.append((e.ordinal, G.KEYED_SUM_I64, T.LONG))
    return out


class TorchKeyedAggregateExec(UnaryExec):
    """COMPLETE group-by over one partition: K9, then K7 for the keys, then,
    when an aggregate has a final expression (an average's
    ``If(cnt > 0, sum / cnt, NULL)``), K6 over the group rows, as
    ``exec/fused.py:653`` runs ``eval_exprs_tpu`` over the merged
    groups.  A sum's and a count's K9 result is already final.  A
    ``count(DISTINCT)`` is K15d's over K9's groups (its row group ids), as
    ``_complete_collect`` (``exec/aggregate.py:510``) zips its collect
    slots with the scalar ones."""

    def __init__(self, layout: _AggLayout, child):
        from spark_rapids_tpu_torch.expressions.aggregates import Average
        from spark_rapids_tpu_torch.exec.fused import StageProgram
        super().__init__(child)
        if child.num_partitions != 1:
            raise NotImplementedError(
                "a group-by over several partitions is not in the port yet")
        self.layout = layout
        self.inputs = keyed_inputs(layout)
        nk = layout.num_keys
        # the batch K9 and K7 give: keys, then one column per K9 aggregate
        fields = [T.StructField(layout.key_name(i),
                                layout.grouping[i].data_type, True)
                  for i in range(nk)]
        fields += [T.StructField(f"_k9_{j}", dt, True)
                   for j, (_o, _k, dt) in enumerate(self.inputs)]
        self._folded = T.StructType(fields)
        finals: List[Expression] = [
            Alias(BoundReference(i, f.data_type, True), f.name)
            for i, f in enumerate(fields[:nk])]
        j = nk
        for a in layout.aggs:
            refs = [BoundReference(j + b, fields[j + b].data_type, True)
                    for b in range(2 if isinstance(a.func, Average) else 1)]
            j += len(refs)
            final = a.func.evaluate(refs) if isinstance(a.func, Average) \
                else refs[0]
            finals.append(Alias(final, a.out_name))
        self.finish = None
        if any(not isinstance(e.children[0], BoundReference)
               for e in finals):
            self.finish = StageProgram([("project", finals)],
                                       self._folded, 0)

    @property
    def schema(self):
        return self.layout.result_schema

    def node_string(self):
        keys = ", ".join(self.layout.key_name(i)
                         for i in range(self.layout.num_keys))
        aggs = ", ".join(a.out_name for a in self.layout.aggs)
        return f"TorchKeyedAggregate[complete, keys=[{keys}], {aggs}]"

    def aggregate_batch(self, batch: ColumnarBatch, transfers
                        ) -> ColumnarBatch:
        from spark_rapids_tpu_torch.columnar.column import DeviceColumn
        from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                       project_batch)
        from spark_rapids_tpu_torch.ops.agg_ops import (count_distinct,
                                                        keyed_aggregate)
        from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
        keys = [batch.columns[k.ordinal] for k in self.layout.grouping]
        scalar = [(o, kind) for o, kind, _dt in self.inputs
                  if kind != DISTINCT]
        distinct = len(scalar) < len(self.inputs)
        got = keyed_aggregate(
            keys, [None if o is None else batch.columns[o]
                   for o, _kind in scalar],
            [kind for _o, kind in scalar], transfers, row_groups=distinct)
        group_rep, results = got[0], iter(got[1])
        n_groups = group_rep.shape[0]
        cols = gather_columns(keys, group_rep, transfers, unique=True)
        for o, kind, dt in self.inputs:
            if kind != DISTINCT:
                cols.append(DeviceColumn(*next(results), dt))
                continue
            counts = count_distinct(batch.columns[o], got[2], n_groups) \
                if n_groups else group_rep.new_zeros(0)
            cols.append(DeviceColumn(counts, torch.ones_like(
                counts, dtype=torch.bool), dt))
        names = self.schema.names
        if self.finish is None:
            return ColumnarBatch(cols, group_rep.shape[0], names)
        folded = ColumnarBatch(cols, group_rep.shape[0],
                               self._folded.names)
        return project_batch(self.finish, folded, LiteralArgs([]), names)

    def execute(self, ctx: ExecContext) -> Partitions:
        out = []
        for part in self.child.execute(ctx):
            if len(part) > 1:
                raise NotImplementedError(
                    "a group-by over several batches is not in the port yet")
            out.append([self.aggregate_batch(b, ctx.transfers)
                        for b in part])
        return out
