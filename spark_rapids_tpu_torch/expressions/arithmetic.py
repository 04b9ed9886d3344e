"""Arithmetic (the analog of ``spark_rapids_tpu/expressions/arithmetic.py``).

Spark non-ANSI semantics: operands widen to the common type, integer
overflow wraps (torch's int64 and int32 arithmetic is two's complement),
and a null operand makes the result null (``Add``, ``Subtract``,
``Multiply``).  ``Divide`` (``:178``) divides
as doubles and gives null for a zero divisor (0.0 or -0.0); the data
under that null is the dividend divided by one, as the JAX package
computes it.  ``IntegralDivide`` (``div``, ``:200``) gives a long that
truncates toward zero, ``Remainder`` (``%``, ``:224``) the sign of the
dividend (C's ``fmod``); both take int and long operands and give null
for a zero divisor.  A divisor of -1 is taken apart: ``INT64_MIN div -1``
wraps to ``INT64_MIN`` (the JAX package's numpy ``a // b``) and ``x %
-1`` is 0, where C's ``/`` and ``%`` (and ``torch.div``, which kills the
process on the CPU) are undefined."""

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


class _IntegralDivision(BinaryArithmetic):
    """``div`` and ``%`` over int and long operands, null for a zero
    divisor."""

    def check_operands(self) -> None:
        for c in self.children:
            if not isinstance(c.data_type, (T.IntegerType, T.LongType)):
                raise NotImplementedError(
                    f"{self.sql()}: {self.symbol} of {c.data_type} is not "
                    "in the port yet (int and long operands are)")

    def eval(self, ctx: EvalContext) -> Col:
        self.check_operands()
        rt = self.data_type.torch_dtype
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        x, y = a.data.to(rt), b.data.to(rt)
        zero, minus_one = y == 0, y == -1
        safe = torch.where(zero | minus_one, torch.ones_like(y), y)
        return Col(self._apply_safe(x, safe, minus_one),
                   a.valid & b.valid & ~zero)


class IntegralDivide(_IntegralDivision):
    """``a div b``: a long, truncated toward zero."""
    symbol = "div"

    @property
    def data_type(self) -> T.DataType:
        return T.LONG

    def _apply_safe(self, x, safe, minus_one):
        # -x wraps: INT64_MIN div -1 is INT64_MIN
        return torch.where(minus_one, -x,
                           torch.div(x, safe, rounding_mode="trunc"))


class Remainder(_IntegralDivision):
    """``a % b``: the sign of the dividend, of the operands' common
    type."""
    symbol = "%"

    def _apply_safe(self, x, safe, minus_one):
        return torch.where(minus_one, torch.zeros_like(x),
                           torch.fmod(x, safe))
