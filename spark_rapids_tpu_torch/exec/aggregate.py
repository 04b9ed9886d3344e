"""Aggregation layout, the final aggregate and the keyed aggregate (the
analog of ``spark_rapids_tpu/exec/aggregate.py``).

The update pass of a partial or complete global aggregate runs fused with
its filter/project chain (exec/fused.py).  The FINAL exec concatenates the
partitions' partial rows, merges them with kernel 2 under the merge kinds,
and evaluates the final projection, as ``TpuHashAggregateExec(FINAL)``
does through ``merge_partials_out_of_core`` (``:173``).

``TorchKeyedAggregateExec`` is a group-by per partition: K9
(``ops/agg_ops.py keyed_aggregate``) groups the rows and folds sum, count,
m2, min, max, first and last per group, writing each aggregate's result
and its validity (a sum of no present value is null, as Spark has it),
and K7 gathers the key columns from each group's first row (and a string
first/last from the row K9 picked).  An average folds a double sum and a
count, the variance family a count and m2, and K6 (exec/fused.py)
evaluates their final expressions over the groups.  Groups come out in
order of first appearance.  The batches of one partition (an Expand's)
are concatenated first (K7c).  A key that is an expression is computed
first, beside the columns, as the JAX package's ``keyed_inputs`` does:
a numeric one by K6, a string one (a substring, a concat) by K13.  Over
several partitions it runs PARTIAL (the buffers, unfinished), then,
behind a hash exchange on the keys, FINAL (K9's merge kinds over the
buffers, then the finish).

A FINAL partition merges out of core (``merge_partials_out_of_core``,
``_repartition_spillables`` and ``_key_hash_u32``, ``:119-230``; the
FINAL merge's ``too_big`` branch, ``exec/fused.py:596-640``): its
batches are registered with the memory runtime as spillables and, where
their bytes pass ``free_device_headroom(2)`` (read with them counted) or
a ``SplitAndRetryOOM`` surfaces, they are re-partitioned on the host
into ``MERGE_BUCKETS`` groups of disjoint keys by 4 fresh bits a level
of Spark's murmur3 of the keys (up to depth 7), and each group merges
through K9's merge kinds on its own, recursing on a group that still
does not fit.  ``FORCE_REPARTITION_BELOW_DEPTH`` forces the re-partition
while the depth is below it, and ``REPARTITION_EVENTS`` counts the
re-partition passes, as in the JAX package."""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.aggregates import (
    AggregateExpression, BufferSpec)
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression, output_name)
from spark_rapids_tpu_torch.plan.base import ExecContext, Partitions, \
    UnaryExec, owned_partitions

PARTIAL, FINAL, COMPLETE = "partial", "final", "complete"
#: re-partition fan-out a level; 4 bits of the 32-bit key hash a level,
#: so 7 levels use the hash up
MERGE_BUCKETS = 16
_MAX_REPARTITION_DEPTH = 7
#: test hook: re-partition while the depth is below this value
FORCE_REPARTITION_BELOW_DEPTH = 0
#: re-partition passes (tests and chip_smoke.py read it)
REPARTITION_EVENTS = 0
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


def merge_partials(layout: _AggLayout, partials: Sequence[ColumnarBatch],
                   transfers=None) -> ColumnarBatch:
    """One buffer row from the partial rows (kernel 2, merge kinds; K7
    for a string first/last), in their order: a ``first`` merge takes the
    first partial row even where its value is null, as the JAX merge does
    (ROADMAP queue 3)."""
    from spark_rapids_tpu_torch.ops.agg_ops import global_aggregate
    from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
    return global_aggregate(concat_batches(partials), layout.merge_specs(),
                            layout.buffer_names, transfers)


def finish(layout: _AggLayout, buffers: ColumnarBatch) -> ColumnarBatch:
    """The final projection, e.g. ``If(cnt > 0, sum, NULL)``: torch glue
    over one row on this slice; a result that is a buffer as it is (a
    count, a min, max, first or last, of any type) is that buffer."""
    from spark_rapids_tpu_torch.exec.fused import bare_ordinal
    from spark_rapids_tpu_torch.expressions.evaluator import eval_exprs
    exprs = layout.final_exprs()
    bare = [bare_ordinal(e) for e in exprs]
    computed = [e for e, b in zip(exprs, bare) if b is None]
    done = iter(eval_exprs(computed, buffers).columns if computed else ())
    cols = [next(done) if b is None else buffers.columns[b] for b in bare]
    return ColumnarBatch(cols, buffers.row_count,
                         [output_name(e) for e in exprs])


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
                out.append([finish(self.layout, merge_partials(
                    self.layout, part, ctx.transfers))])
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


def _column_of(e) -> int:
    """The column ordinal K9 reads for input ``e``: a column, or a
    widening cast of one (K9 widens int to long and converts to double
    row by row itself); -1 for any other expression."""
    from spark_rapids_tpu_torch.expressions.cast import Cast
    if isinstance(e, Cast) and isinstance(e.children[0], BoundReference) \
            and e.children[0].data_type in (T.INT, T.LONG, T.DOUBLE):
        e = e.children[0]
    return e.ordinal if isinstance(e, BoundReference) else -1


def keyed_inputs(layout: _AggLayout, partial: bool = False):
    """``(slots, per_agg)``.  ``slots`` is ``[(input ordinal or None, K9
    kind or DISTINCT, result type)]``, each (input, kind) once, so
    aggregates that fold the same value share a slot (q17's ``count``,
    ``avg`` and ``stddev_samp`` of one column share its count);
    ``per_agg[i]`` is the slot indices aggregate ``i`` reads: one for a
    sum, a count, a min, max, first or last (K9's kind of its buffer, of
    the input's type), a double sum and a count of present values for an
    average, a count and m2 for the variance family, and a K15d count
    (``DISTINCT``) for a ``count(DISTINCT)``.  With ``partial`` (the
    PARTIAL buffers) a sum also reads a count and the variance family a
    double sum (its mean's).  Raises NotImplementedError, naming it, for
    what K9 and K15d cannot fold yet."""
    from spark_rapids_tpu_torch.expressions.aggregates import (
        Average, Count, CountDistinct, First, Min, Sum, _CentralMoment)
    from spark_rapids_tpu_torch.expressions.base import Literal
    from spark_rapids_tpu_torch.ops import agg_ops as G
    for k in layout.grouping:
        if k.data_type not in G.KEYED_KEY_TYPES:
            raise NotImplementedError(
                f"a grouping key of {k.data_type} is not in the port yet "
                "(int, date, long, double and string keys are)")
    slots, per_agg = [], []

    def slot(ordinal, kind, dtype) -> int:
        for j, (o, k, _dt) in enumerate(slots):
            if (o, k) == (ordinal, kind):
                return j
        slots.append((ordinal, kind, dtype))
        return len(slots) - 1

    for a in layout.aggs:
        f = a.func
        e = f.children[0]
        if isinstance(f, CountDistinct):
            if partial:
                raise ValueError(f"{f.sql()} runs in COMPLETE mode only")
            per_agg.append((slot(distinct_input(f), DISTINCT, T.LONG),))
            continue
        if isinstance(f, Count) and isinstance(e, Literal) and \
                e.value is not None:
            per_agg.append((slot(None, G.KEYED_COUNT_ALL, T.LONG),))
            continue
        o = _column_of(e)
        if o < 0 or not isinstance(f, (Sum, Count, Average, Min, First,
                                       _CentralMoment)):
            raise NotImplementedError(
                f"aggregate {f.sql()} in a group-by is not in the port yet "
                "(sum, count, avg, min, max, first, last and the variance "
                "family of a column are)")
        if isinstance(f, (Min, First)):
            # one buffer of the input's type; K9 keeps the type
            spec, = f.buffers()
            per_agg.append((slot(o, G.KEYED_KINDS[spec.update_kind],
                                 f.data_type),))
        elif isinstance(f, Count):
            per_agg.append((slot(o, G.KEYED_COUNT, T.LONG),))
        elif isinstance(f, Average) and f.decimal:
            # a decimal sum and a count; the finish is csrc/decimal.cu's
            total = f.buffers()[0].dtype
            per_agg.append((slot(o, decimal_sum_kind(total), total),
                            slot(o, G.KEYED_COUNT, T.LONG)))
        elif isinstance(f, Average):
            # K9 converts an int or long input to double row by row
            per_agg.append((slot(o, G.KEYED_SUM_F64, T.DOUBLE),
                            slot(o, G.KEYED_COUNT, T.LONG)))
        elif isinstance(f, _CentralMoment):
            per_agg.append((slot(o, G.KEYED_COUNT, T.LONG),
                            slot(o, G.KEYED_M2, T.DOUBLE)) +
                           ((slot(o, G.KEYED_SUM_F64, T.DOUBLE),)
                            if partial else ()))
        else:
            # K9 widens int to long itself
            total = slot(o, G.KEYED_SUM_F64, T.DOUBLE) \
                if f.data_type.is_floating else \
                slot(o, decimal_sum_kind(f.data_type), f.data_type) \
                if isinstance(f.data_type, T.DecimalType) else \
                slot(o, G.KEYED_SUM_I64, T.LONG)
            per_agg.append((total, slot(o, G.KEYED_COUNT, T.LONG))
                           if partial else (total,))
    if sum(kind != DISTINCT for _o, kind, _dt in slots) > G.MAX_AGGS:
        raise NotImplementedError(
            f"a group-by of more than {G.MAX_AGGS} distinct K9 slots is "
            "not in the port yet")
    return slots, per_agg


def decimal_sum_kind(total: T.DecimalType) -> int:
    """K9's kind of a decimal sum buffer: the long sum of a decimal64's
    unscaled values, the 128-bit sum for a decimal128."""
    from spark_rapids_tpu_torch.ops import agg_ops as G
    return G.KEYED_SUM_DEC128 if total.is_decimal128 else G.KEYED_SUM_I64


#: K9 kind of each merge kind over a buffer column
_MERGE_KINDS = {"m2_cnt": "sum", "m2_mean": "chan_mean",
                "m2_m2": "chan_m2"}


def merge_inputs(layout: _AggLayout):
    """K9's slots of a FINAL group-by over the buffer columns (ordinals
    ``num_keys + j``): ``[(ordinal, kind, aux)]``, one per buffer in
    order.  A sum or a count merges as the sum of its buffer column (a
    count's sum is a sum, not a count); the variance family's triple by
    the Chan merge, whose ``aux`` is the triple's (count, mean)
    ordinals; a min, max, first or last by its own kind over the buffer
    rows, in the order the exchange delivers them."""
    from spark_rapids_tpu_torch.ops import agg_ops as G
    nk = layout.num_keys
    out = []
    for j, (_ai, spec) in enumerate(layout.flat):
        kind = _MERGE_KINDS.get(spec.merge_kind, spec.merge_kind)
        if kind in G.KEYED_KINDS:
            out.append((nk + j, G.KEYED_KINDS[kind], None))
        elif kind == "sum":
            out.append((nk + j, G.KEYED_SUM_F64 if spec.dtype.is_floating
                        else decimal_sum_kind(spec.dtype)
                        if isinstance(spec.dtype, T.DecimalType)
                        else G.KEYED_SUM_I64, None))
        elif kind in ("chan_mean", "chan_m2"):
            first = j - (1 if kind == "chan_mean" else 2)
            out.append((nk + j, G.KEYED_CHAN_MEAN if kind == "chan_mean"
                        else G.KEYED_CHAN_M2, (nk + first, nk + first + 1)))
        else:
            raise NotImplementedError(
                f"the merge kind {spec.merge_kind} is not in the port yet")
    if len(out) > G.MAX_AGGS:
        raise NotImplementedError(
            f"a FINAL group-by of more than {G.MAX_AGGS} buffers is not in "
            "the port yet")
    return out


class TorchKeyedAggregateExec(UnaryExec):
    """A group-by over each partition: K9, then K7 for the keys, then,
    when an output computes, K6 over the group rows, as
    ``exec/fused.py:653`` runs ``eval_exprs_tpu`` over the merged groups;
    when none does, the output is a selection of K9's slots (no launch).
    The batches of a partition (an Expand's, one per grouping set) are
    concatenated first (K7c), as the JAX package's aggregate concatenates
    its input (``exec/aggregate.py:200``).

    - COMPLETE: the results (an average's ``If(cnt > 0, sum / cnt,
      NULL)``, ``stddev_samp``'s ``If(n > 1, sqrt(m2 / (n - 1)), NULL)``).
      A ``count(DISTINCT)`` is K15d's over K9's groups (its row group
      ids), as ``_complete_collect`` (``exec/aggregate.py:510``) zips its
      collect slots with the scalar ones.
    - PARTIAL: the buffer layout, unfinished (``_AggLayout.buffer_schema``
      ``:58``): a sum's sum and count, a count, an average's double sum
      and count, the variance family's (count, mean, m2) with the count a
      double and the mean null where it is 0.
    - FINAL: over a hash exchange of PARTIAL buffers (``merge_partials_
      out_of_core``'s in-core path, ``:173-226``): K9's merge kinds fold
      each group's partial rows (sums of sums and counts, the Chan merge
      of the triples), and K6 evaluates the final expressions; the port
      of ``fused.agg_merge_final`` (``exec/fused.py:468``, K3b) is the
      reducer's K7c (the exchange), this K9 and that K6."""

    def __init__(self, layout: _AggLayout, child, mode: str = COMPLETE):
        from spark_rapids_tpu_torch.exec.fused import StageProgram, \
            bare_ordinal
        super().__init__(child)
        self.layout = layout
        self.mode = mode
        if mode == FINAL:
            self.merges = merge_inputs(layout)
            folded, outs = self._final_outputs()
        else:
            self.inputs, per_agg = keyed_inputs(layout, mode == PARTIAL)
            folded, outs = self._partial_outputs(per_agg) \
                if mode == PARTIAL else self._complete_outputs(per_agg)
        self._folded = folded
        #: K6 and K13's program of the keys when one is an expression (a
        #: numeric one K6's, a string one K13's; JAX ``keyed_inputs``)
        self.keys = None
        if mode != FINAL and any(not isinstance(k, BoundReference)
                                 for k in layout.grouping):
            self.keys = StageProgram([("project", layout.grouping)],
                                     child.schema, 0)
        #: the slots the output reads when it computes nothing (a
        #: selection), else K6's program
        self.picked = [bare_ordinal(e) for e in outs]
        self.finish = None
        if None in self.picked:
            self.picked = None
            self.finish = StageProgram([("project", outs)], folded, 0)

    def _slot_fields(self, types):
        nk = self.layout.num_keys
        fields = [T.StructField(self.layout.key_name(i),
                                self.layout.grouping[i].data_type, True)
                  for i in range(nk)]
        fields += [T.StructField(f"_k9_{j}", dt, True)
                   for j, dt in enumerate(types)]
        refs = [BoundReference(nk + j, dt, True)
                for j, dt in enumerate(types)]
        keys = [Alias(BoundReference(i, f.data_type, True), f.name)
                for i, f in enumerate(fields[:nk])]
        return T.StructType(fields), refs, keys

    def _complete_outputs(self, per_agg):
        from spark_rapids_tpu_torch.expressions.aggregates import (
            Average, _CentralMoment)
        from spark_rapids_tpu_torch.expressions.cast import Cast
        folded, ref, outs = self._slot_fields(
            [dt for _o, _k, dt in self.inputs])
        for a, js in zip(self.layout.aggs, per_agg):
            if isinstance(a.func, Average):
                final = a.func.evaluate([ref[j] for j in js])
            elif isinstance(a.func, _CentralMoment):
                cnt, m2 = (ref[j] for j in js)
                final = a.func.evaluate([Cast(cnt, T.DOUBLE), None, m2])
            else:
                final = ref[js[0]]
            outs.append(Alias(final, a.out_name))
        return folded, outs

    def _partial_outputs(self, per_agg):
        """The buffers of ``layout.flat``, in order: a sum's or an
        average's sum and count, a count, and the variance family's count
        as a double, its mean (null where the count is 0) and m2."""
        from spark_rapids_tpu_torch.expressions.aggregates import (
            Average, _CentralMoment)
        from spark_rapids_tpu_torch.expressions.cast import Cast
        folded, ref, outs = self._slot_fields(
            [dt for _o, _k, dt in self.inputs])
        buffers = []
        for a, js in zip(self.layout.aggs, per_agg):
            if isinstance(a.func, _CentralMoment):
                cnt, m2, total = (ref[j] for j in js)
                buffers += [Cast(cnt, T.DOUBLE),
                            Average(total).evaluate([total, cnt]), m2]
            else:
                buffers += [ref[j] for j in js]
        for j, e in enumerate(buffers):
            outs.append(Alias(e, self.layout.buffer_name(j)))
        return folded, outs

    def _final_outputs(self):
        from spark_rapids_tpu_torch.ops import agg_ops as G
        bschema = self.layout.buffer_schema
        types = [bschema.types[o] if kind not in G._KEYED_CHAN else T.DOUBLE
                 for o, kind, _aux in self.merges]
        folded, ref, _keys = self._slot_fields(types)
        return folded, self.layout.final_exprs()

    @property
    def schema(self):
        return self.layout.buffer_schema if self.mode == PARTIAL \
            else self.layout.result_schema

    def node_string(self):
        keys = ", ".join(self.layout.key_name(i)
                         for i in range(self.layout.num_keys))
        aggs = ", ".join(a.out_name for a in self.layout.aggs)
        return (f"TorchKeyedAggregate[{self.mode}, keys=[{keys}], "
                f"{aggs}]")

    def aggregate_batch(self, batch: ColumnarBatch, transfers
                        ) -> ColumnarBatch:
        from spark_rapids_tpu_torch.columnar.column import DeviceColumn
        from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                       project_batch)
        from spark_rapids_tpu_torch.ops.agg_ops import (count_distinct,
                                                        keyed_aggregate)
        from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
        nk = self.layout.num_keys
        if self.mode == FINAL:
            keys = batch.columns[:nk]
            got = keyed_aggregate(
                keys, [batch.columns[o] for o, _k, _a in self.merges],
                [kind for _o, kind, _a in self.merges], transfers,
                aux=[None if a is None else tuple(batch.columns[x]
                                                   for x in a)
                     for _o, _k, a in self.merges])
            group_rep, results = got
            n_groups = group_rep.shape[0]
            cols = gather_columns(keys, group_rep, transfers, unique=True)
            cols += [_slot_column(batch.columns[o], kind, v, ok,
                                  self._folded.types[nk + j], transfers)
                     for j, ((o, kind, _a), (v, ok)) in
                     enumerate(zip(self.merges, results))]
            folded = ColumnarBatch(cols, n_groups, self._folded.names)
        else:
            keys = [batch.columns[k.ordinal] for k in self.layout.grouping] \
                if self.keys is None else project_batch(
                    self.keys, batch, LiteralArgs([]),
                    [f"_key{j}" for j in range(nk)], transfers).columns
            scalar = [(o, kind) for o, kind, _dt in self.inputs
                      if kind != DISTINCT]
            distinct = len(scalar) < len(self.inputs)
            got = keyed_aggregate(
                keys, [None if o is None else batch.columns[o]
                       for o, _kind in scalar],
                [kind for _o, kind in scalar], transfers,
                row_groups=distinct)
            group_rep, results = got[0], iter(got[1])
            n_groups = group_rep.shape[0]
            cols = gather_columns(keys, group_rep, transfers, unique=True)
            for o, kind, dt in self.inputs:
                if kind != DISTINCT:
                    cols.append(_slot_column(
                        None if o is None else batch.columns[o], kind,
                        *next(results), dt, transfers))
                    continue
                counts = count_distinct(batch.columns[o], got[2],
                                        n_groups) \
                    if n_groups else group_rep.new_zeros(0)
                cols.append(DeviceColumn(counts, torch.ones_like(
                    counts, dtype=torch.bool), dt))
            folded = ColumnarBatch(cols, n_groups, self._folded.names)
        names = self.schema.names
        if self.picked is not None:
            return folded.select(self.picked, names)
        return project_batch(self.finish, folded, LiteralArgs([]), names,
                             transfers)

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.memory.spillable import spillable_pieces
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        out = []
        for part in owned_partitions(self.child.execute(ctx)):
            if not part:
                out.append([])
            elif self.mode != FINAL or not any(b.row_count for b in part):
                out.append([self.aggregate_batch(concat_batches(part),
                                                 ctx.transfers)])
            else:
                live = [b for b in part if b.row_count]
                part.clear()
                spills = spillable_pieces(live, ctx.transfers)
                out.append(list(merge_partials_out_of_core(
                    self, spills, ctx.transfers)))
        return out


def _slot_column(c, kind: int, values: torch.Tensor, ok: torch.Tensor,
                 dt: T.DataType, transfers):
    """A K9 slot's result as a column: a string first/last is K9's rows of
    ``c`` (-1 for a null), which K7 gathers (each row once: groups are
    disjoint, so no sync sizes the chars); any other is K9's values."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    from spark_rapids_tpu_torch.ops.agg_ops import KEYED_PICK
    from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
    if kind in KEYED_PICK and c.is_string:
        return gather_columns([c], values, transfers, unique=True,
                              nullable=True)[0]
    return DeviceColumn(values, ok, dt)


def _key_hash_u32(hb, nk: int) -> np.ndarray:
    """Spark's murmur3 (seed 42) of each row's keys, the first ``nk``
    columns of a host batch, as uint32 (K11h's plain hash on host
    planes)."""
    from spark_rapids_tpu_torch.exec.sort import _host_key_column
    from spark_rapids_tpu_torch.ops.partition_ops import murmur3_rows
    h = murmur3_rows([_host_key_column(c) for c in hb.columns[:nk]])
    return h.numpy().astype(np.int64).astype(np.uint32)


def _repartition_spillables(spills, nk: int, depth: int):
    """The spillable buffer batches split on the host into
    ``MERGE_BUCKETS`` groups of disjoint keys, by the hash's bits ``4 *
    depth`` up, so a bucket of one level splits again at the next."""
    from spark_rapids_tpu_torch.memory.spillable import \
        SpillableColumnarBatch
    global REPARTITION_EVENTS
    REPARTITION_EVENTS += 1
    buckets = [[] for _ in range(MERGE_BUCKETS)]
    for sb in spills:
        hb = sb.get_host_batch()
        device = sb.device
        sb.close()
        h = _key_hash_u32(hb, nk)
        pid = ((h >> np.uint32(4 * depth)) % MERGE_BUCKETS).astype(np.int64)
        order = np.argsort(pid, kind="stable")
        counts = np.bincount(pid, minlength=MERGE_BUCKETS)
        moved = hb.take(order)
        off = 0
        for k in range(MERGE_BUCKETS):
            if counts[k]:
                buckets[k].append(SpillableColumnarBatch.from_host(
                    moved.slice(off, int(counts[k])), catalog=sb.catalog,
                    device=device))
            off += int(counts[k])
    return buckets


def merge_partials_out_of_core(agg: "TorchKeyedAggregateExec", spills,
                               transfers, depth: int = 0):
    """A FINAL group-by over spillable buffer batches: the merged (and
    finished) batches, whose key sets are pairwise disjoint.  One concat
    and K9 merge under a retry frame where they fit, else the re-partition
    and a merge per bucket (JAX ``:173``)."""
    from spark_rapids_tpu_torch.memory.device_manager import \
        free_device_headroom
    from spark_rapids_tpu_torch.memory.retry import (SplitAndRetryOOM,
                                                     maybe_inject_oom,
                                                     with_retry_no_split)
    from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
    nk = agg.layout.num_keys

    def attempt():
        maybe_inject_oom()
        bs = [sb.get_batch() for sb in spills]
        return agg.aggregate_batch(concat_batches(bs) if len(bs) > 1
                                   else bs[0], transfers)

    too_big = False
    if depth < _MAX_REPARTITION_DEPTH:
        too_big = depth < FORCE_REPARTITION_BELOW_DEPTH
        if not too_big:
            budget = free_device_headroom(2)
            if budget is not None:
                too_big = sum(sb.sized_nbytes for sb in spills) > budget
    if not too_big:
        try:
            merged = with_retry_no_split(None, attempt)
            for sb in spills:
                sb.close()
            yield merged
            return
        except SplitAndRetryOOM:
            # merge state cannot shrink by running again: re-partition
            if depth >= _MAX_REPARTITION_DEPTH:
                raise
    for bucket in _repartition_spillables(spills, nk, depth):
        if bucket:
            yield from merge_partials_out_of_core(agg, bucket, transfers,
                                                  depth + 1)
