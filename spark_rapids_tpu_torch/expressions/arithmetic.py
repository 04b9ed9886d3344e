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
process on the CPU) are undefined.

Decimals (``:66-110``, ``decimal_op``): ``+``, ``-``, ``*``, ``/`` and
``%`` of a decimal and a decimal, int or long run in decimal space with
Spark's result types, exactly (``expressions/decimal_math.py``, K12:
HALF_UP, overflow and a zero divisor give NULL); an operation the JAX
package's gate sends to its host tier is refused by name.  A decimal
and a double compute as doubles, the decimal converted as
``decimal_to_double`` converts it."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions import decimal_math as DM
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


def convert(data: torch.Tensor, src: T.DataType,
            dst: T.DataType) -> torch.Tensor:
    """A column's data of type ``src`` as ``dst``'s data: a decimal as a
    double through ``decimal_to_double``, any other by torch's
    conversion."""
    if isinstance(src, T.DecimalType) and not isinstance(dst, T.DecimalType):
        return DM.to_double(data, src).to(dst.torch_dtype)
    return data.to(dst.torch_dtype)


class BinaryArithmetic(BinaryExpr):
    #: the decimal operation (``decimal_math.binary``), None for none
    decimal_op = None

    def decimal_type(self):
        """The decimal result type when this runs in decimal space (a
        decimal and a decimal, int or long), else None; refuses by name
        what the JAX package sends to its host tier."""
        lt, rt = self.left.data_type, self.right.data_type
        if not DM.decimal_operands(lt, rt):
            return None
        if self.decimal_op is None:
            raise NotImplementedError(
                f"{self.sql()}: {self.symbol} of {lt} and {rt} is not in "
                "the port yet")
        return DM.check_binary(self.decimal_op, lt, rt, self.sql())

    @property
    def data_type(self) -> T.DataType:
        dt = self.decimal_type()
        if dt is not None:
            return dt
        return T.common_type(self.left.data_type, self.right.data_type)

    def _apply(self, a, b):
        raise NotImplementedError

    def eval_decimal(self, ctx: EvalContext, out: T.DecimalType) -> Col:
        """K12's plain version: the operands' unscaled values through
        ``decimal_math.binary``; 0 under a null."""
        lt, rt = self.left.data_type, self.right.data_type
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        value, ok = DM.binary(self.decimal_op, DM.operand(a.data, lt),
                              T.integral_decimal(lt), DM.operand(b.data, rt),
                              T.integral_decimal(rt), out, DM.TORCH)
        ok = ok & a.valid & b.valid
        return Col(DM.result_data(value, ok), ok)

    def eval(self, ctx: EvalContext) -> Col:
        dt = self.decimal_type()
        if dt is not None:
            return self.eval_decimal(ctx, dt)
        rt = self.data_type
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        return Col(self._apply(convert(a.data, self.left.data_type, rt),
                               convert(b.data, self.right.data_type, rt)),
                   a.valid & b.valid)


class Add(BinaryArithmetic):
    symbol = "+"
    decimal_op = "add"

    def _apply(self, a, b):
        return a + b


class Subtract(BinaryArithmetic):
    """``a - b`` (JAX ``:162``); integer overflow wraps."""
    symbol = "-"
    decimal_op = "sub"

    def _apply(self, a, b):
        return a - b


class Multiply(BinaryArithmetic):
    symbol = "*"
    decimal_op = "mul"

    def _apply(self, a, b):
        return a * b


class Divide(BinaryArithmetic):
    """``a / b``: a double, or of decimal operands Spark's decimal
    quotient (HALF_UP; NULL for a zero divisor)."""
    symbol = "/"
    decimal_op = "div"

    @property
    def data_type(self) -> T.DataType:
        dt = self.decimal_type()
        return T.DOUBLE if dt is None else dt

    def eval(self, ctx: EvalContext) -> Col:
        dt = self.decimal_type()
        if dt is not None:
            return self.eval_decimal(ctx, dt)
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        x = convert(a.data, self.left.data_type, T.DOUBLE)
        y = convert(b.data, self.right.data_type, T.DOUBLE)
        zero = y == 0
        return Col(x / torch.where(zero, 1.0, y), a.valid & b.valid & ~zero)


class _IntegralDivision(BinaryArithmetic):
    """``div`` and ``%`` over int and long operands, null for a zero
    divisor."""

    def check_operands(self) -> None:
        if self.decimal_type() is not None:
            return
        for c in self.children:
            if not isinstance(c.data_type, (T.IntegerType, T.LongType)):
                raise NotImplementedError(
                    f"{self.sql()}: {self.symbol} of {c.data_type} is not "
                    "in the port yet (int and long operands are)")

    def eval(self, ctx: EvalContext) -> Col:
        self.check_operands()
        dt = self.decimal_type()
        if dt is not None:
            return self.eval_decimal(ctx, dt)
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
    type; of decimal operands Spark's decimal remainder."""
    symbol = "%"
    decimal_op = "rem"

    def _apply_safe(self, x, safe, minus_one):
        return torch.where(minus_one, torch.zeros_like(x),
                           torch.fmod(x, safe))
