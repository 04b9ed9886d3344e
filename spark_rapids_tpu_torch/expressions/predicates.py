"""Comparisons and Kleene logic (the analog of
``spark_rapids_tpu/expressions/predicates.py``).

Operands widen to a common type; a null operand gives null.  For doubles
Spark orders NaN above every other value (``predicates.py:206``).  ``=``
also compares two strings byte for byte.  ``And`` (``:258``) and ``Or``
(``:295``) follow Spark's three-valued logic: ``null AND false`` is
false and ``null OR true`` is true; otherwise a null operand gives
null."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.arithmetic import BinaryExpr
from spark_rapids_tpu_torch.expressions.base import Col, EvalContext


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


class BinaryComparison(BinaryExpr):
    @property
    def data_type(self):
        return T.BOOLEAN

    @property
    def operand_type(self) -> T.DataType:
        return T.common_type(self.left.data_type, self.right.data_type)

    def _cmp(self, a, b, floating: bool):
        raise NotImplementedError

    def eval(self, ctx: EvalContext) -> Col:
        ot = self.operand_type
        a = self.left.eval(ctx)
        b = self.right.eval(ctx)
        if isinstance(ot, T.StringType):
            if not isinstance(self, EqualTo):
                raise NotImplementedError(
                    f"{self.symbol} of strings is not in the port yet")
            return Col(string_equal(a, b), a.valid & b.valid)
        out = self._cmp(a.data.to(ot.torch_dtype), b.data.to(ot.torch_dtype),
                        ot.is_floating)
        return Col(out, a.valid & b.valid)


class GreaterThan(BinaryComparison):
    symbol = ">"

    def _cmp(self, a, b, floating):
        if floating:
            return (a > b) | (torch.isnan(a) & ~torch.isnan(b))
        return a > b


class EqualTo(BinaryComparison):
    """``=``; for doubles Spark has NaN = NaN true (``predicates.py:177``),
    and -0.0 = 0.0 as IEEE has it."""

    symbol = "="

    def _cmp(self, a, b, floating):
        if floating:
            return (a == b) | (torch.isnan(a) & torch.isnan(b))
        return a == b


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
