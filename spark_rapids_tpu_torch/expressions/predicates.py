"""Comparisons, ``IN`` and Kleene logic (the analog of
``spark_rapids_tpu/expressions/predicates.py``).

Operands widen to a common type; a null operand gives null.  For doubles
Spark orders NaN above every other value (``predicates.py:190-219``), so
``NaN >= x`` and ``x <= NaN`` hold for every x.  A date compares as its
days.  ``=`` and ``<>`` (``NotEqual``, ``:224``) also compare two strings
byte for byte: columns, substrings of columns or literals.  ``<>`` is NOT
``=``, so ``NaN <> NaN`` is false.  ``And`` (``:258``) and ``Or``
(``:295``) follow Spark's three-valued logic: ``null AND false`` is false
and ``null OR true`` is true; otherwise a null operand gives null.
``Not`` (``:330``) negates, and NOT null is null.  ``In`` (``:413``) is
the OR chain of ``value = option`` over its literal options, so a null
value gives null, NaN matches a NaN option, and a null option makes a
miss null."""

from __future__ import annotations

from typing import Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.arithmetic import BinaryExpr
from spark_rapids_tpu_torch.expressions.base import (BoundReference, Col,
                                                     EvalContext, Expression,
                                                     Literal)


def string_equal(a: Col, b: Col) -> torch.Tensor:
    """Rows of two string columns that hold the same bytes."""
    oa, ob = a.offsets.to(torch.int64), b.offsets.to(torch.int64)
    la, lb = oa[1:] - oa[:-1], ob[1:] - ob[:-1]
    same_len = la == lb
    n = la.shape[0]
    lens = torch.where(same_len, la, 0)
    total = int(lens.sum())
    dev = la.device
    row = torch.repeat_interleave(torch.arange(n, device=dev), lens,
                                  output_size=total)
    within = torch.arange(total, device=dev) - (torch.cumsum(lens, 0) -
                                                lens)[row]
    differ = a.data[oa[:-1][row] + within] != b.data[ob[:-1][row] + within]
    bad = torch.zeros(n, dtype=torch.int64, device=dev).index_add_(
        0, row, differ.to(torch.int64))
    return same_len & (bad == 0)


def string_equals_literal(a: Col, raw: bytes) -> torch.Tensor:
    """Rows of a string column that hold the bytes ``raw``: the lengths,
    then each byte where every byte before it matched."""
    off = a.offsets.to(torch.int64)
    starts = off[:-1]
    eq = off[1:] - starts == len(raw)
    for j, byte in enumerate(raw):
        if not a.data.numel():
            return eq & False
        at = torch.where(eq, starts + j, 0)
        eq = eq & (a.data[at] == byte)
    return eq


class BinaryComparison(BinaryExpr):
    @property
    def data_type(self):
        return T.BOOLEAN

    @property
    def operand_type(self) -> T.DataType:
        return T.common_type(self.left.data_type, self.right.data_type)

    def _cmp(self, a, b, floating: bool):
        raise NotImplementedError

    def _string_equal(self, ctx: EvalContext) -> Col:
        """``=`` of the two string operands, a literal's bytes compared
        directly."""
        for column, other in ((self.left, self.right),
                              (self.right, self.left)):
            if type(other) is Literal and other.value is not None:
                a = column.eval(ctx)
                return Col(string_equals_literal(
                    a, other.value.encode("utf-8")), a.valid)
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        return Col(string_equal(a, b), a.valid & b.valid)

    def eval(self, ctx: EvalContext) -> Col:
        ot = self.operand_type
        if isinstance(ot, T.StringType):
            if not isinstance(self, (EqualTo, NotEqual)):
                raise NotImplementedError(
                    f"{self.symbol} of strings is not in the port yet")
            eq = self._string_equal(ctx)
            return Col(~eq.data if isinstance(self, NotEqual) else eq.data,
                       eq.valid)
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        out = self._cmp(a.data.to(ot.torch_dtype), b.data.to(ot.torch_dtype),
                        ot.is_floating)
        return Col(out, a.valid & b.valid)


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _cmp(self, a, b, floating):
        if floating:
            return (a > b) | (torch.isnan(a) & ~torch.isnan(b))
        return a > b


class GreaterThanOrEqual(BinaryComparison):
    symbol = ">="

    def _cmp(self, a, b, floating):
        if floating:
            return (a >= b) | torch.isnan(a)
        return a >= b


class LessThan(BinaryComparison):
    symbol = "<"

    def _cmp(self, a, b, floating):
        if floating:
            return (a < b) | (torch.isnan(b) & ~torch.isnan(a))
        return a < b


class LessThanOrEqual(BinaryComparison):
    symbol = "<="

    def _cmp(self, a, b, floating):
        if floating:
            return (a <= b) | torch.isnan(b)
        return a <= b


class EqualTo(BinaryComparison):
    """``=``; for doubles Spark has NaN = NaN true (``predicates.py:177``),
    and -0.0 = 0.0 as IEEE has it."""

    symbol = "="

    def _cmp(self, a, b, floating):
        if floating:
            return (a == b) | (torch.isnan(a) & torch.isnan(b))
        return a == b


class NotEqual(BinaryComparison):
    """``<>``: NOT ``=``, so NaN <> NaN is false and -0.0 <> 0.0 too."""

    symbol = "<>"

    def _cmp(self, a, b, floating):
        return ~EqualTo._cmp(self, a, b, floating)


class Not(Expression):
    """NOT: Kleene, so NOT null is null."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.BOOLEAN

    def sql(self):
        return f"(NOT {self.children[0].sql()})"

    def eval(self, ctx: EvalContext) -> Col:
        c = self.children[0]
        if not isinstance(c.data_type, T.BooleanType):
            raise TypeError(f"NOT of {c.data_type}")
        v = c.eval(ctx)
        return Col(~v.data, v.valid)


class _Logic(BinaryExpr):
    @property
    def data_type(self):
        return T.BOOLEAN

    def _sides(self, ctx: EvalContext):
        """(definitely true, definitely false, valid) of each operand."""
        out = []
        for c in self.children:
            if not isinstance(c.data_type, T.BooleanType):
                raise TypeError(f"{self.symbol} of {c.data_type}")
            v = c.eval(ctx)
            out.append((v.data & v.valid, ~v.data & v.valid, v.valid))
        return out


class And(_Logic):
    symbol = "AND"

    def eval(self, ctx: EvalContext) -> Col:
        (at, af, _), (bt, bf, _) = self._sides(ctx)
        out = at & bt
        return Col(out, out | af | bf)


class Or(_Logic):
    symbol = "OR"

    def eval(self, ctx: EvalContext) -> Col:
        (at, _, av), (bt, _, bv) = self._sides(ctx)
        out = at | bt
        return Col(out, out | (av & bv))


class In(Expression):
    """``value IN (options)``: the options are literals (a Python value
    becomes one), compared as ``value = option`` each.  They are not
    children, so literal promotion leaves them in place: a kernel holds
    them as constants."""

    def __init__(self, value: Expression, options: Sequence):
        super().__init__([value])
        for o in options:
            if isinstance(o, Expression) and type(o) is not Literal:
                raise NotImplementedError(
                    f"IN over {o.sql()}: only literal options are in the "
                    "port")
        self.options = [o if isinstance(o, Literal) else Literal(o)
                        for o in options]

    @property
    def data_type(self):
        return T.BOOLEAN

    def sql(self):
        opts = ", ".join(o.sql() for o in self.options)
        return f"({self.children[0].sql()} IN ({opts}))"

    def eval(self, ctx: EvalContext) -> Col:
        value = self.children[0]
        v = value.eval(ctx)
        found = torch.zeros(ctx.row_count, dtype=torch.bool,
                            device=ctx.device)
        one = EvalContext([v], ctx.row_count, ctx.device)
        ref = BoundReference(0, value.data_type)
        has_null = False
        for o in self.options:
            if o.value is None:
                has_null = True
                continue
            found = found | EqualTo(ref, o).eval(one).data
        if not self.options:
            return Col(found, torch.ones_like(found))
        return Col(found, v.valid & found if has_null else v.valid)
