"""Comparisons (the analog of ``spark_rapids_tpu/expressions/predicates.py``).

Operands widen to a common type; a null operand gives null.  For doubles
Spark orders NaN above every other value (``predicates.py:206``)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.arithmetic import BinaryExpr
from spark_rapids_tpu_torch.expressions.base import Col, EvalContext


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
