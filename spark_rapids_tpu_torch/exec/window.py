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
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions import window_exprs as WE
from spark_rapids_tpu_torch.expressions.base import Expression, Literal
from spark_rapids_tpu_torch.ops import window_ops as W
from spark_rapids_tpu_torch.plan.base import (ExecContext, Partitions,
                                              UnaryExec)


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
    if not child.data_type.is_numeric:
        raise NotImplementedError(f"{f.sql()} of {child.data_type}")
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


class TorchWindowExec(UnaryExec):
    """``window_cols``: ``[(name, WindowExpression)]`` sharing one spec."""

    def __init__(self, window_cols, child):
        from spark_rapids_tpu_torch.exec.fused import StageProgram
        super().__init__(child)
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

    def window_batch(self, batch: ColumnarBatch, transfers) -> ColumnarBatch:
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
        payload, outs = W.compute_windows(
            batch.columns, evaluated[:nk], values,
            [k for k, _e in self.lowered], batch.row_count, batch.device,
            transfers, evaluated[nk:nk + no], self.orders)
        return ColumnarBatch(payload + outs, batch.row_count,
                             self._schema.names)

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        out = []
        for part in self.child.execute(ctx):
            if part:
                out.append([self.window_batch(concat_batches(part),
                                              ctx.transfers)])
            else:
                out.append([])
        return out
