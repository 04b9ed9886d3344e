"""Numeric casts (the analog of ``spark_rapids_tpu/expressions/cast.py``).

This slice needs widening casts only (``Cast(int -> long)`` is inserted by
the aggregate layout so a sum's input matches its buffer type); any other
cast is refused when it is built."""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Col, EvalContext, \
    Expression

_WIDENING = {(T.INT, T.LONG), (T.INT, T.DOUBLE), (T.LONG, T.DOUBLE)}


class Cast(Expression):
    def __init__(self, child: Expression, dtype: T.DataType):
        super().__init__([child])
        src = child.data_type
        if src != dtype and (src, dtype) not in _WIDENING:
            raise NotImplementedError(
                f"Cast from {src} to {dtype} is not in this port yet")
        self._dtype = dtype

    @property
    def data_type(self):
        return self._dtype

    def sql(self):
        return f"cast({self.children[0].sql()} as {self._dtype.simple_name})"

    def eval(self, ctx: EvalContext) -> Col:
        c = self.children[0].eval(ctx)
        return Col(c.data.to(self._dtype.torch_dtype), c.valid)
