"""Arithmetic (the analog of ``spark_rapids_tpu/expressions/arithmetic.py``).

Spark non-ANSI semantics: operands widen to the common type, integer
overflow wraps (torch's int64 and int32 arithmetic is two's complement),
and a null operand makes the result null (``Add``, ``Subtract``,
``Multiply``).  ``Divide`` (``:178``) divides
as doubles and gives null for a zero divisor (0.0 or -0.0); the data
under that null is the dividend divided by one, as the JAX package
computes it."""

from __future__ import annotations

import torch

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


class Subtract(BinaryArithmetic):
    """``a - b`` (JAX ``:162``); integer overflow wraps."""
    symbol = "-"

    def _apply(self, a, b):
        return a - b


class Multiply(BinaryArithmetic):
    symbol = "*"

    def _apply(self, a, b):
        return a * b


class Divide(BinaryArithmetic):
    symbol = "/"

    @property
    def data_type(self) -> T.DataType:
        return T.DOUBLE

    def eval(self, ctx: EvalContext) -> Col:
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        x, y = a.data.to(torch.float64), b.data.to(torch.float64)
        zero = y == 0
        return Col(x / torch.where(zero, 1.0, y), a.valid & b.valid & ~zero)
