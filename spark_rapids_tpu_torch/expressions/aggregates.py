"""Declarative aggregate functions (the analog of ``spark_rapids_tpu/
expressions/aggregates.py``): each function names its buffers with an
update kind and a merge kind, and a final expression over the merged
buffers.  ``Average`` (``:154``) keeps the JAX package's buffers: a double
sum of ``Cast(child, DOUBLE)`` and a count, and the final expression
``If(cnt > 0, sum / cnt, NULL)``."""

from __future__ import annotations

import dataclasses
from typing import List

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Expression, Literal


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    name: str
    dtype: T.DataType
    update_kind: str   # reduction over the input column
    merge_kind: str    # reduction over partial buffers
    input_ordinal: int = 0
    count_valid_only: bool = True


class AggregateFunction(Expression):
    is_aggregate = True

    @property
    def nullable(self) -> bool:
        return True

    def inputs(self) -> List[Expression]:
        return list(self.children)

    def buffers(self) -> List[BufferSpec]:
        raise NotImplementedError

    def evaluate(self, refs: List[Expression]) -> Expression:
        raise NotImplementedError

    def sql(self):
        args = ", ".join(c.sql() for c in self.children)
        return f"{type(self).__name__.lower()}({args})"

    def over(self, spec) -> Expression:
        """This aggregate over a window (``functions.Window`` or a
        ``WindowSpecDef``)."""
        from spark_rapids_tpu_torch.expressions.window_exprs import (
            WindowExpression, to_spec)
        return WindowExpression(self, to_spec(spec))


def _sum_result_type(dt: T.DataType) -> T.DataType:
    return T.DOUBLE if dt.is_floating else T.LONG


class Sum(AggregateFunction):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return _sum_result_type(self.children[0].data_type)

    def buffers(self):
        return [BufferSpec("sum", self.data_type, "sum", "sum"),
                BufferSpec("cnt", T.LONG, "count", "sum")]

    def evaluate(self, refs):
        # Spark: the sum of an empty or all-null group is NULL, not 0
        from spark_rapids_tpu_torch.expressions.conditional import If
        from spark_rapids_tpu_torch.expressions.predicates import \
            GreaterThan
        return If(GreaterThan(refs[1], Literal(0, T.LONG)),
                  refs[0], Literal(None, self.data_type))


class Count(AggregateFunction):
    """count(expr) counts non-null rows; count(lit(1)) == count(*)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.LONG

    @property
    def nullable(self):
        return False

    def buffers(self):
        count_all = isinstance(self.children[0], Literal) and \
            self.children[0].value is not None
        return [BufferSpec("cnt", T.LONG, "count", "sum",
                           count_valid_only=not count_all)]

    def evaluate(self, refs):
        return refs[0]


class Average(AggregateFunction):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.DOUBLE

    def inputs(self):
        from spark_rapids_tpu_torch.expressions.cast import Cast
        return [Cast(self.children[0], T.DOUBLE)]

    def buffers(self):
        return [BufferSpec("sum", T.DOUBLE, "sum", "sum"),
                BufferSpec("cnt", T.LONG, "count", "sum")]

    def evaluate(self, refs):
        from spark_rapids_tpu_torch.expressions.arithmetic import Divide
        from spark_rapids_tpu_torch.expressions.cast import Cast
        from spark_rapids_tpu_torch.expressions.conditional import If
        from spark_rapids_tpu_torch.expressions.predicates import \
            GreaterThan
        return If(GreaterThan(refs[1], Literal(0, T.LONG)),
                  Divide(Cast(refs[0], T.DOUBLE), Cast(refs[1], T.DOUBLE)),
                  Literal(None, T.DOUBLE))


@dataclasses.dataclass
class AggregateExpression:
    """An aggregate and its output name."""
    func: AggregateFunction
    out_name: str
