"""The window exec (the analog of ``spark_rapids_tpu/exec/window.py``:
``lower_window_expr`` ``:48``, ``TpuWindowExec._window_one`` ``:437`` and
``execute_partition`` ``:465``).

``TorchWindowExec`` appends one column per window expression of one spec
to its child's columns.  It runs per partition and concatenates a
partition's batches (K7c); over several partitions the planner puts a
hash exchange on the ``partition_by`` keys below it (one of a single
partition without keys), as ``session.py:416-425`` does.  Per partition
it evaluates the partition keys and each function's input (a sum's
``Cast(child, sum type)``, an average's ``Cast(child, DOUBLE)``) through K6
where they compute and by selection where they are columns, and hands
them to ``ops/window_ops.py compute_windows`` (K8, K7, K14).  Its rows
come out sorted by the partition keys (and the order keys), as the JAX
program gives them.  Order keys that compute (q36's ratio of two sums)
go through K6 with the partition keys.

Each function lowers as the JAX lowering does (``:48-108``):
row_number, rank and dense_rank over an ORDER BY (K14's ranking pass);
ntile (K14o); lag and lead (K14o's source rows, K7's gather, a scalar
default of a fixed-width type filled by K14o); and sum, count, avg, min
and max over a frame (ROWS or the default RANGE frame): the whole
partition (K14's reduction; K14s for min and max), a frame with an
unbounded end (K14s), or a ROWS frame with two finite bounds (K14b).  It
refuses, by name, what the JAX package refuses: a bounded RANGE frame
(``:83-87``), a lag/lead default that is not a literal, is over a
string, or is of another type than the column (``:60-72``), and a min or
max frame its device program does not run (``ops/window_ops.py:352``:
one end unbounded, the other neither the current row nor unbounded);
and what the port cannot run yet: a ranking function without an ORDER
BY or over a frame, and a min or max of a string or boolean (the JAX
program runs those on its CPU engine).

Out of core (``execute_partition``'s budget decision, ``:465-499``):
where a partition's bytes pass ``free_device_headroom(4)`` (or the
session forces it), a window of running shapes only
(``_running_eligible``, ``:378``: row_number, rank, dense_rank and ROWS
UNBOUNDED PRECEDING .. CURRENT ROW sums, counts, minima and maxima) runs
``_running_windows`` (``:502-518``): the external sort of
``exec/sort.py`` streams the partition in sorted chunks, each chunk's
functions run on the chunk alone (K14, K14r, K14s, with no sort or
gather of their own), and K14c (``ops/window_ops.py running_fixup``)
shifts the rows that continue the previous chunk's last partition by the
carry, which stays on the card.  A window of fixed-bound ROWS frames and
lag/lead whose preceding + following span ``P + F`` is at most
``spark.rapids.sql.window.batched.bounded.rowLimit`` (``_bounded_span``,
``:351``) runs ``_bounded_windows`` (``:520-583``): each chunk is joined
(K7c) behind the previous chunk's last ``P + F`` rows (a K7 gather), and
only rows whose frames lie whole in that batch are emitted.  The row
counts are exact on the host, so the emitted range is a slice and no
kernel is needed beyond K7, K7c, K14b and K14o.  ``RUNNING_WINDOW_EVENTS``
and ``BOUNDED_WINDOW_EVENTS`` count the passes.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions import window_exprs as WE
from spark_rapids_tpu_torch.expressions.base import Expression, Literal
from spark_rapids_tpu_torch.ops import window_ops as W
from spark_rapids_tpu_torch.plan.base import (ExecContext, Partitions,
                                              UnaryExec, owned_partitions)


#: passes of the chunked running and bounded paths (tests and
#: chip_smoke.py read them)
RUNNING_WINDOW_EVENTS = 0
BOUNDED_WINDOW_EVENTS = 0

#: K14's ranking kind of each ranking function
_RANKING = {WE.RowNumber: W.WIN_ROW_NUMBER, WE.Rank: W.WIN_RANK,
            WE.DenseRank: W.WIN_DENSE_RANK}


def lower_window_expr(wexpr) -> Tuple[object, Optional[Expression]]:
    """``(K14 kind, input expression or None)`` of one window expression:
    a ranking kind (an int), or an ``ops/window_ops.py`` ``FrameAgg``,
    ``NTileFn`` or ``OffsetFn``; NotImplementedError naming what the port
    does not run."""
    from spark_rapids_tpu_torch.expressions.aggregates import (
        AggregateFunction, Average, Count, Max, Min, Sum)
    from spark_rapids_tpu_torch.expressions.cast import Cast
    spec = wexpr.spec
    f = wexpr.function
    if type(f) in _RANKING:
        if not spec.order_specs:
            raise NotImplementedError(
                f"{wexpr.sql()}: a ranking function needs an ORDER BY")
        if spec.frame is not None:
            raise NotImplementedError(
                f"{wexpr.sql()}: a ranking function over the frame "
                f"{spec.frame.desc()} is not in the port yet")
        return _RANKING[type(f)], None
    if isinstance(f, WE.NTile):
        return W.NTileFn(f.n), None
    if isinstance(f, (WE.Lag, WE.Lead)):
        child = f.children[0]
        default = None
        if f.default is not None:
            if not isinstance(f.default, Literal) or \
                    isinstance(child.data_type, T.StringType):
                raise NotImplementedError(
                    "lag/lead default must be a scalar literal over a "
                    "non-string column")
            if f.default.data_type != child.data_type:
                raise TypeError(
                    f"lag/lead default type {f.default.data_type} does not "
                    f"match column type {child.data_type}; cast the "
                    "default explicitly")
            default = f.default.value
        return W.OffsetFn(f.offset * f.direction, default), child
    if not isinstance(f, AggregateFunction):
        raise NotImplementedError(f"window function {type(f).__name__}")
    frame = spec.effective_frame()
    lo = None if frame.lo_unbounded else int(frame.lo)
    hi = None if frame.hi_unbounded else int(frame.hi)
    if frame.kind == "range" and not (lo is None and hi in (None, 0)):
        raise NotImplementedError(
            f"the bounded RANGE frame {frame.desc()} is not supported; use "
            "ROWS BETWEEN (Spark's value-based RANGE frames need a single "
            "numeric order key)")

    def over(kind, value=None):
        return W.FrameAgg(kind, frame.kind, lo, hi), value
    if not isinstance(f, (Sum, Count, Average, Min, Max)):
        raise NotImplementedError(
            f"window function {type(f).__name__} is not in the port yet "
            "(sum, count, avg, min, max, row_number, rank, dense_rank, "
            "ntile, lag and lead are)")
    child = f.children[0]
    if isinstance(f, Count):
        if isinstance(child, Literal) and child.value is not None:
            return over(W.WIN_COUNT_ALL)
        return over(W.WIN_COUNT, child)
    if isinstance(f, (Min, Max)):
        if child.data_type not in W.MINMAX_TYPES:
            raise NotImplementedError(
                f"{f.sql()} of {child.data_type} over a window is not in "
                "the port yet (int, date, long and double are)")
        low = over(W.WIN_MAX if isinstance(f, Max) else W.WIN_MIN, child)
        _check_minmax_frame(wexpr, low[0])
        return low
    if not child.data_type.is_numeric or \
            isinstance(child.data_type, T.DecimalType):
        raise NotImplementedError(f"{f.sql()} of {child.data_type} over a "
                                  "window is not in the port yet")
    want = T.DOUBLE if isinstance(f, Average) else f.data_type
    value = child if child.data_type == want else Cast(child, want)
    if isinstance(f, Average):
        return over(W.WIN_MEAN, value)
    return over(W.WIN_SUM_F64 if want.is_floating else W.WIN_SUM_I64,
                value)


def _check_minmax_frame(wexpr, func) -> None:
    """The min and max frames the JAX device program runs: bounded ROWS,
    running to the current row or its last peer, the whole partition,
    and CURRENT ROW..UNBOUNDED FOLLOWING."""
    if func.bounded or (func.lo is None and func.hi in (None, 0)) or \
            (func.lo == 0 and func.hi is None):
        return
    raise NotImplementedError(
        f"{wexpr.sql()}: min/max over this frame is not supported (the "
        "JAX program's _one_func refuses it: one end unbounded, the other "
        "neither the current row nor unbounded)")


def _bounded_span(lowered, max_span: int) -> Optional[Tuple[int, int]]:
    """``(P, F)``, the most preceding and following rows any function
    reads, when every one is a ROWS frame with two finite bounds or a
    lag/lead, and ``0 < P + F <= max_span``; else None."""
    p = f = 0
    for kind, _e in lowered:
        if isinstance(kind, W.OffsetFn):
            p, f = max(p, -kind.offset), max(f, kind.offset)
        elif isinstance(kind, W.FrameAgg) and kind.bounded:
            p, f = max(p, -kind.lo), max(f, kind.hi)
        else:
            return None
    if p + f == 0 or p + f > max_span:
        return None
    return p, f


def _running_eligible(lowered) -> bool:
    """Every function's state is a fixed-size carry (JAX ``:378``)."""
    for kind, _e in lowered:
        try:
            W.fixup_kind(kind)
        except ValueError:
            return False
    return True


class TorchWindowExec(UnaryExec):
    """``window_cols``: ``[(name, WindowExpression)]`` sharing one spec.
    ``force_running``, ``force_bounded`` and ``force_out_of_core_sort``
    take the chunked paths (and the external sort under them) whatever
    the pool holds; ``max_span`` is the widest ``P + F`` the bounded path
    carries."""

    def __init__(self, window_cols, child, force_running: bool = False,
                 force_bounded: bool = False,
                 force_out_of_core_sort: bool = False,
                 max_span: int = 4096):
        from spark_rapids_tpu_torch.exec.fused import StageProgram
        super().__init__(child)
        self.force_running = force_running
        self.force_bounded = force_bounded
        self.force_out_of_core_sort = force_out_of_core_sort
        self.max_span = max_span
        self.window_cols = list(window_cols)
        spec = self.window_cols[0][1].spec
        self.partition_exprs = list(spec.partition_exprs)
        self.order_exprs = [e for e, _a, _nf in spec.order_specs]
        self.orders = [(a, nf) for _e, a, nf in spec.order_specs]
        for e in self.partition_exprs + self.order_exprs:
            if e.data_type not in W.WINDOW_KEY_TYPES:
                raise NotImplementedError(
                    f"a window key of {e.data_type} is not in the port yet "
                    "(int, date, long, double and string keys are)")
        self.lowered = [lower_window_expr(w) for _n, w in self.window_cols]
        inputs = [e for _k, e in self.lowered if e is not None]
        # partition keys, order keys, then the inputs: K6 computes what
        # is not a column
        exprs = self.partition_exprs + self.order_exprs + inputs
        self.program = StageProgram([("project", exprs)], child.schema,
                                    0) if exprs else None
        self._schema = T.StructType(list(child.schema.fields) + [
            T.StructField(name, W.result_type(kind) if isinstance(kind, int)
                          else W.frame_result_type(
                              kind, None if e is None else e.data_type),
                          True)
            for (name, _w), (kind, e) in zip(self.window_cols,
                                             self.lowered)])

    @property
    def schema(self):
        return self._schema

    def node_string(self):
        cols = ", ".join(f"{w.sql()} AS {name}"
                         for name, w in self.window_cols)
        return f"TorchWindow[{cols}]"

    def window_batch(self, batch: ColumnarBatch, transfers,
                     presorted: bool = False) -> ColumnarBatch:
        payload, _k, _o, outs = self._windows(batch, transfers, presorted)
        return ColumnarBatch(payload + outs, batch.row_count,
                             self._schema.names)

    def _windows(self, batch: ColumnarBatch, transfers,
                 presorted: bool = False):
        """``(payload, partition keys, order keys, window columns)`` of
        one batch, all in the window's sorted order."""
        from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                       project_batch)
        program = self.program
        evaluated: List = []
        if program is not None and program.computes:
            names = [f"_e{j}" for j in range(len(program.bare))]
            evaluated = project_batch(program, batch, LiteralArgs([]),
                                      names, transfers).columns
        elif program is not None:
            evaluated = [batch.columns[b] for b in program.bare]
        nk, no = len(self.partition_exprs), len(self.order_exprs)
        it = iter(evaluated[nk + no:])
        values = [None if e is None else next(it) for _k, e in self.lowered]
        keys = evaluated[:nk + no]
        payload, outs = W.compute_windows(
            list(batch.columns) + keys, evaluated[:nk], values,
            [k for k, _e in self.lowered], batch.row_count, batch.device,
            transfers, evaluated[nk:nk + no], self.orders, presorted)
        n_payload = len(batch.columns)
        return payload[:n_payload], payload[n_payload:n_payload + nk], \
            payload[n_payload + nk:], outs

    def execute(self, ctx: ExecContext) -> Partitions:
        return [list(self.window_partition(part, ctx.transfers))
                if part else []
                for part in owned_partitions(self.child.execute(ctx))]

    def window_partition(self, batches, transfers):
        """One partition: the whole partition in one batch where it fits
        ``free_device_headroom(4)``, else (or forced) the chunked running
        or bounded path where the functions allow it (JAX ``:465-491``).
        A chunked path empties the list handed in: the sort registers the
        batches as spillables, and the catalog holds them from then on."""
        from spark_rapids_tpu_torch.memory.device_manager import \
            free_device_headroom
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        live = [b for b in batches if b.row_count]
        if live:
            est = sum(b.nbytes() for b in live)
            budget = free_device_headroom(4)
            over = budget is not None and est > budget
            running = _running_eligible(self.lowered) and \
                (self.force_running or over)
            span = _bounded_span(self.lowered, self.max_span)
            if running or span is not None and (self.force_bounded or over):
                batches.clear()
                yield from (self._running_windows(live, transfers) if running
                            else self._bounded_windows(live, transfers,
                                                       *span))
                return
        yield self.window_batch(concat_batches(batches), transfers)

    def _sorted_chunks(self, batches, transfers):
        """The partition through the sort by (partition keys ascending,
        nulls first; order keys), chunk by chunk."""
        from spark_rapids_tpu_torch.exec.sort import SortSpec, TorchSortExec
        specs = [SortSpec(e, True, True) for e in self.partition_exprs]
        specs += [SortSpec(e, a, nf) for e, (a, nf) in
                  zip(self.order_exprs, self.orders)]
        # a sort over this exec's input; it takes the batches (and empties
        # the list) itself, never running its child
        sorter = TorchSortExec(specs, self.child,
                               self.force_out_of_core_sort)
        return sorter.sort_partition(batches, transfers)

    def _running_windows(self, batches, transfers):
        """The running path (JAX ``_running_windows`` ``:493``): each
        sorted chunk's functions, then K14c with the carry."""
        global RUNNING_WINDOW_EVENTS
        RUNNING_WINDOW_EVENTS += 1
        kinds = [W.fixup_kind(k) for k, _e in self.lowered]
        carry = None
        for chunk in self._sorted_chunks(batches, transfers):
            payload, pkeys, okeys, outs = self._windows(chunk, transfers,
                                                        presorted=True)
            fixed, carry = W.running_fixup(pkeys, okeys, kinds, outs,
                                           chunk.row_count, carry,
                                           transfers)
            yield ColumnarBatch(payload + fixed, chunk.row_count,
                                self._schema.names)

    def _bounded_windows(self, batches, transfers, p: int, f: int):
        """The chunked bounded path (JAX ``_bounded_windows`` ``:520``):
        each chunk behind the previous batch's last ``p + f`` rows; the
        rows ``[skip, rc - f)`` of the joined batch have their whole
        frames in it and are emitted; the last chunk's tail at the end."""
        from spark_rapids_tpu_torch.ops.batch_ops import (concat_batches,
                                                          gather_batch,
                                                          slice_batch)
        global BOUNDED_WINDOW_EVENTS
        BOUNDED_WINDOW_EVENTS += 1
        span = p + f
        carry, skip, last = None, 0, None
        for chunk in self._sorted_chunks(batches, transfers):
            combined = chunk if carry is None else \
                concat_batches([carry, chunk])
            rc = combined.row_count
            out = self.window_batch(combined, transfers, presorted=True)
            emit_hi = max(rc - f, skip)
            if emit_hi > skip:
                yield slice_batch(out, skip, emit_hi - skip, transfers)
            carried = min(rc, span)
            idx = torch.arange(rc - carried, rc, dtype=torch.int64,
                               device=combined.device)
            carry = gather_batch(combined, idx, transfers, unique=True)
            # of the carried rows, the last rc - emit_hi were not emitted
            skip = carried - (rc - emit_hi)
            last = (out, rc, emit_hi)
        if last is not None:
            out, rc, emit_hi = last
            if rc > emit_hi:
                yield slice_batch(out, emit_hi, rc - emit_hi, transfers)
