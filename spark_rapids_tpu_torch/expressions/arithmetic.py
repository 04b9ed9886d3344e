"""Arithmetic (the analog of ``spark_rapids_tpu/expressions/arithmetic.py``).

Spark non-ANSI semantics: operands widen to the common type, integer
overflow wraps (torch's int64 and int32 arithmetic is two's complement),
and a null operand makes the result null."""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Col, EvalContext, \
    Expression


class BinaryExpr(Expression):
    symbol = "?"

    def __init__(self, left: Expression, right: Expression):
        super().__init__([left, right])

    @property
    def left(self):
        return self.children[0]

    @property
    def right(self):
        return self.children[1]

    def sql(self):
        return f"({self.left.sql()} {self.symbol} {self.right.sql()})"


class BinaryArithmetic(BinaryExpr):
    @property
    def data_type(self) -> T.DataType:
        return T.common_type(self.left.data_type, self.right.data_type)

    def _apply(self, a, b):
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> Col:
        rt = self.data_type.torch_dtype
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        return Col(self._apply(a.data.to(rt), b.data.to(rt)),
                   a.valid & b.valid)


class Add(BinaryArithmetic):
    symbol = "+"

    def _apply(self, a, b):
        return a + b


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _apply(self, a, b):
        return a * b
