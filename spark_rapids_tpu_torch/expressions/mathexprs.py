"""Math functions (the analog of ``spark_rapids_tpu/expressions/
mathexprs.py``): ``Sqrt`` (``:76``), a DOUBLE of its operand converted to
double; a negative operand gives NaN, not null, and a null operand null,
as the JAX package's ``sqrt(where(x < 0, nan, x))`` does."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Col, EvalContext, \
    Expression


class Sqrt(Expression):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self) -> T.DataType:
        return T.DOUBLE

    def sql(self):
        return f"sqrt({self.children[0].sql()})"

    def eval(self, ctx: EvalContext) -> Col:
        c = self.children[0].eval(ctx)
        r = torch.sqrt(torch.where(c.data.to(torch.float64) < 0,
                                   float("nan"), c.data.to(torch.float64)))
        # one quiet NaN for a negative or NaN operand (K6 writes the same)
        return Col(torch.where(torch.isnan(r), float("nan"), r), c.valid)
