"""The window exec (the analog of ``spark_rapids_tpu/exec/window.py``:
``lower_window_expr`` ``:48``, ``TpuWindowExec._window_one`` ``:437`` and
``execute_partition`` ``:465``).

``TorchWindowExec`` appends one column per window expression of one spec
to its child's columns.  It takes one partition and concatenates its
batches, evaluates the partition keys and each function's input (a sum's
``Cast(child, sum type)``, an average's ``Cast(child, DOUBLE)``) through K6
where they compute and by selection where they are columns, and hands
them to ``ops/window_ops.py compute_windows`` (K8, K7, K14).  Its rows
come out sorted by the partition keys, as the JAX program gives them.

The port runs the whole-partition frame (no ORDER BY) of sum, count and
avg.  It refuses, by name, an ORDER BY (running frames), a frame other
than the whole partition (bounded ROWS), any other function (row_number,
rank, dense_rank, ntile, lag, lead, min, max) and several partitions."""

from __future__ import annotations

from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.base import Expression, Literal
from spark_rapids_tpu_torch.ops import window_ops as W
from spark_rapids_tpu_torch.plan.base import (ExecContext, Partitions,
                                              UnaryExec)


def lower_window_expr(wexpr) -> Tuple[int, Optional[Expression]]:
    """``(K14 kind, input expression or None)`` of one window expression,
    or NotImplementedError naming what the port cannot run yet."""
    from spark_rapids_tpu_torch.expressions.aggregates import (Average,
                                                               Count, Sum)
    from spark_rapids_tpu_torch.expressions.cast import Cast
    spec = wexpr.spec
    if spec.order_specs:
        raise NotImplementedError(
            f"a window with ORDER BY ({wexpr.sql()}; a running frame) is "
            "not in the port yet")
    frame = spec.effective_frame()
    if not (frame.lo_unbounded and frame.hi_unbounded):
        raise NotImplementedError(
            f"the window frame {frame.desc()} is not in the port yet (the "
            "whole partition is)")
    f = wexpr.function
    if not isinstance(f, (Sum, Count, Average)):
        raise NotImplementedError(
            f"window function {type(f).__name__} is not in the port yet "
            "(sum, count and avg over the whole partition are)")
    child = f.children[0]
    if isinstance(f, Count):
        if isinstance(child, Literal) and child.value is not None:
            return W.WIN_COUNT_ALL, None
        return W.WIN_COUNT, child
    if not child.data_type.is_numeric:
        raise NotImplementedError(f"{f.sql()} of {child.data_type}")
    want = T.DOUBLE if isinstance(f, Average) else f.data_type
    value = child if child.data_type == want else Cast(child, want)
    if isinstance(f, Average):
        return W.WIN_MEAN, value
    return (W.WIN_SUM_F64 if want.is_floating else W.WIN_SUM_I64), value


class TorchWindowExec(UnaryExec):
    """``window_cols``: ``[(name, WindowExpression)]`` sharing one spec."""

    def __init__(self, window_cols, child):
        from spark_rapids_tpu_torch.exec.fused import StageProgram
        super().__init__(child)
        self.window_cols = list(window_cols)
        if child.num_partitions != 1:
            raise NotImplementedError(
                "a window over several partitions is not in the port yet")
        spec = self.window_cols[0][1].spec
        self.partition_exprs = list(spec.partition_exprs)
        for e in self.partition_exprs:
            if e.data_type not in W.WINDOW_KEY_TYPES:
                raise NotImplementedError(
                    f"a window partition key of {e.data_type} is not in "
                    "the port yet (int, date, long, double and string "
                    "keys are)")
        self.lowered = [lower_window_expr(w) for _n, w in self.window_cols]
        inputs = [e for _k, e in self.lowered if e is not None]
        # keys, then the inputs: K6 computes what is not a column
        self.program = StageProgram(
            [("project", self.partition_exprs + inputs)], child.schema, 0) \
            if self.partition_exprs or inputs else None
        self._schema = T.StructType(list(child.schema.fields) + [
            T.StructField(name, W.result_type(kind), True)
            for (name, _w), (kind, _e) in zip(self.window_cols,
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
        if program is not None and program.computed:
            names = [f"_e{j}" for j in range(len(program.bare))]
            evaluated = project_batch(program, batch, LiteralArgs([]),
                                      names).columns
        elif program is not None:
            evaluated = [batch.columns[b] for b in program.bare]
        nk = len(self.partition_exprs)
        it = iter(evaluated[nk:])
        values = [None if e is None else next(it) for _k, e in self.lowered]
        payload, outs = W.compute_windows(
            batch.columns, evaluated[:nk], values,
            [k for k, _e in self.lowered], batch.row_count, batch.device,
            transfers)
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
