"""Numeric casts (the analog of ``spark_rapids_tpu/expressions/cast.py``).

The port's casts are widening: ``Cast(int -> long)`` is inserted by the
aggregate layout so a sum's input matches its buffer type, and
``Cast(x -> double)`` by ``Average``.  Decimal casts (``:53-61``,
``:114-122``) follow Spark's rules, not the JAX package's host cast
(which takes the unscaled integer for the value, ROADMAP queue 3):

- an int or long to a decimal, and a decimal to a decimal, rescale the
  unscaled value (HALF_UP where the scale drops; NULL past the target's
  precision): ``decimal_math.rescale``;
- a decimal to a double is ``decimal_to_double`` (``decimal_math
  .to_double``).

Any other cast is refused by name when it is built."""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions import decimal_math as DM
from spark_rapids_tpu_torch.expressions.base import (AttributeReference,
                                                     Col, EvalContext,
                                                     Expression)

_WIDENING = {(T.INT, T.LONG), (T.INT, T.DOUBLE), (T.LONG, T.DOUBLE)}


def decimal_cast(src: T.DataType, dst: T.DataType) -> bool:
    """A cast in decimal space: an int, long or decimal to a decimal."""
    return isinstance(dst, T.DecimalType) and \
        T.integral_decimal(src) is not None


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
        src, dst = child.data_type, self._dtype
        if src == dst or (src, dst) in _WIDENING:
            return
        if decimal_cast(src, dst):
            DM.check_rescale(T.integral_decimal(src), dst, self.sql())
            return
        if isinstance(src, T.DecimalType) and dst == T.DOUBLE and \
                not src.is_decimal128:
            return
        raise NotImplementedError(
            f"Cast from {src} to {dst} is not in this port yet")

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
        src, dst = self.children[0].data_type, self._dtype
        if src == dst:
            return c
        if decimal_cast(src, dst):
            value, ok = DM.rescale(DM.operand(c.data, src),
                                   T.integral_decimal(src), dst, DM.TORCH)
            ok = ok & c.valid
            return Col(DM.result_data(value, ok), ok)
        if isinstance(src, T.DecimalType):
            return Col(DM.to_double(c.data, src), c.valid)
        return Col(c.data.to(dst.torch_dtype), c.valid)
