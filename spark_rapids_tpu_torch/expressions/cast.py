"""Numeric casts (the analog of ``spark_rapids_tpu/expressions/cast.py``).

The port needs widening casts only: ``Cast(int -> long)`` is inserted by
the aggregate layout so a sum's input matches its buffer type, and
``Cast(x -> double)`` by ``Average``.  Any other cast is refused when it
is built."""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import (AttributeReference,
                                                     Col, EvalContext,
                                                     Expression)

_WIDENING = {(T.INT, T.LONG), (T.INT, T.DOUBLE), (T.LONG, T.DOUBLE)}


class Cast(Expression):
    def __init__(self, child: Expression, dtype: T.DataType):
        super().__init__([child])
        self._dtype = dtype
        self._check()

    def _check(self) -> None:
        """Refuses a cast the port does not have, once the child's type is
        known (a column named but not yet bound is checked when it is)."""
        child = self.children[0]
        if isinstance(child, AttributeReference):
            return
        src = child.data_type
        if src != self._dtype and (src, self._dtype) not in _WIDENING:
            raise NotImplementedError(
                f"Cast from {src} to {self._dtype} is not in this port yet")

    def with_children(self, children):
        node = super().with_children(children)
        node._check()
        return node

    @property
    def data_type(self):
        return self._dtype

    def sql(self):
        return f"cast({self.children[0].sql()} as {self._dtype.simple_name})"

    def eval(self, ctx: EvalContext) -> Col:
        c = self.children[0].eval(ctx)
        return Col(c.data.to(self._dtype.torch_dtype), c.valid)
