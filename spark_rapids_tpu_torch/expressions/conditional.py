"""Conditionals (the analog of ``spark_rapids_tpu/expressions/
conditional.py``): a null predicate selects the else branch."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Col, EvalContext, \
    Expression


class If(Expression):
    def __init__(self, predicate: Expression, a: Expression, b: Expression):
        super().__init__([predicate, a, b])

    @property
    def data_type(self):
        return T.common_type(self.children[1].data_type,
                             self.children[2].data_type)

    def sql(self):
        p, a, b = self.children
        return f"if({p.sql()}, {a.sql()}, {b.sql()})"

    def eval(self, ctx: EvalContext) -> Col:
        rt = self.data_type.torch_dtype
        p, a, b = (c.eval(ctx) for c in self.children)
        cond = p.data & p.valid
        return Col(torch.where(cond, a.data.to(rt), b.data.to(rt)),
                   torch.where(cond, a.valid, b.valid))
