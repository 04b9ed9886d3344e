"""Window specs and window expressions (the analog of ``spark_rapids_tpu/
expressions/window_exprs.py``: ``WindowFrame`` ``:27``, ``WHOLE_PARTITION``
``:61``, ``WindowSpecDef`` ``:66``, ``WindowExpression`` ``:93`` and the
ranking functions ``RowNumber`` ``:150``, ``Rank`` ``:163`` and
``DenseRank`` ``:176``).

An aggregate function or a ranking function ``.over(spec)`` is a
``WindowExpression``.  A ``select`` extracts these into one logical
``Window`` node per (partition, order) group and reads their columns
(``session.py``).  The port runs the whole-partition frame (no ORDER BY)
of sum, count and avg, and row_number, rank and dense_rank over an ORDER
BY (``exec/window.py``); other frames and functions are refused there, by
name."""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Expression

# frame bound sentinels (Spark's Window.unboundedPreceding/Following)
UNBOUNDED_PRECEDING = -(1 << 62)
UNBOUNDED_FOLLOWING = 1 << 62
CURRENT_ROW = 0


@dataclasses.dataclass(frozen=True)
class WindowFrame:
    """``kind`` is "rows" or "range"; bounds are row or peer offsets, or
    the sentinels above."""
    kind: str = "range"
    lo: int = UNBOUNDED_PRECEDING
    hi: int = CURRENT_ROW

    @property
    def lo_unbounded(self) -> bool:
        return self.lo <= UNBOUNDED_PRECEDING

    @property
    def hi_unbounded(self) -> bool:
        return self.hi >= UNBOUNDED_FOLLOWING

    def desc(self) -> str:
        def bound(v):
            if v <= UNBOUNDED_PRECEDING:
                return "UNBOUNDED PRECEDING"
            if v >= UNBOUNDED_FOLLOWING:
                return "UNBOUNDED FOLLOWING"
            if v == 0:
                return "CURRENT ROW"
            return f"{-v} PRECEDING" if v < 0 else f"{v} FOLLOWING"
        return (f"{self.kind.upper()} BETWEEN {bound(self.lo)} AND "
                f"{bound(self.hi)}")


WHOLE_PARTITION = WindowFrame("range", UNBOUNDED_PRECEDING,
                              UNBOUNDED_FOLLOWING)


@dataclasses.dataclass
class WindowSpecDef:
    """Partition expressions, order ``(expr, ascending, nulls_first)``
    and a frame."""
    partition_exprs: List[Expression]
    order_specs: List[Tuple[Expression, bool, bool]]
    frame: Optional[WindowFrame] = None

    def effective_frame(self) -> WindowFrame:
        """Spark's default: a running frame with an ORDER BY, else the
        whole partition."""
        if self.frame is not None:
            return self.frame
        if self.order_specs:
            return WindowFrame("range", UNBOUNDED_PRECEDING, CURRENT_ROW)
        return WHOLE_PARTITION

    def group_key(self) -> Tuple:
        """Specs with the same partition and order share one window pass
        (the frame may differ per expression)."""
        return (tuple(e.sql() for e in self.partition_exprs),
                tuple((e.sql(), a, nf) for e, a, nf in self.order_specs))

    def desc(self) -> str:
        p = ", ".join(e.sql() for e in self.partition_exprs)
        o = ", ".join(f"{e.sql()} {'ASC' if a else 'DESC'}"
                      for e, a, _nf in self.order_specs)
        return (f"PARTITION BY {p} ORDER BY {o} "
                f"{self.effective_frame().desc()}")


class WindowExpression(Expression):
    """``function OVER spec``.  The spec's partition and order expressions
    are children after the function, so binding reaches them;
    ``with_children`` keeps the spec's shape."""

    def __init__(self, function: Expression, spec: WindowSpecDef):
        super().__init__([function] + list(spec.partition_exprs) +
                         [e for e, _a, _nf in spec.order_specs])
        self._n_part = len(spec.partition_exprs)
        self._order_dirs = [(a, nf) for _e, a, nf in spec.order_specs]
        self._frame = spec.frame

    @property
    def function(self) -> Expression:
        return self.children[0]

    @property
    def spec(self) -> WindowSpecDef:
        pk = self.children[1:1 + self._n_part]
        ok = self.children[1 + self._n_part:]
        return WindowSpecDef(list(pk), [(e, a, nf) for e, (a, nf) in
                                        zip(ok, self._order_dirs)],
                             self._frame)

    @property
    def data_type(self):
        return self.function.data_type

    @property
    def nullable(self) -> bool:
        return True

    def sql(self):
        return f"{self.function.sql()} OVER ({self.spec.desc()})"

    def eval(self, ctx):
        raise NotImplementedError(
            "a window expression runs in its Window node (exec/window.py), "
            "not in a projection")


def to_spec(spec) -> WindowSpecDef:
    from spark_rapids_tpu_torch.functions import WindowBuilder
    if isinstance(spec, WindowSpecDef):
        return spec
    if isinstance(spec, WindowBuilder):
        return spec.spec
    raise TypeError(f"not a window spec: {spec!r}")


class WindowFunction(Expression):
    """A function that only runs over a window (``:133``)."""

    def __init__(self):
        super().__init__([])

    @property
    def data_type(self):
        return T.INT

    @property
    def nullable(self) -> bool:
        return False

    def sql(self):
        return f"{self.fn_name}()"

    def over(self, spec) -> "WindowExpression":
        return WindowExpression(self, to_spec(spec))

    def eval(self, ctx):
        raise NotImplementedError(
            f"{self.sql()} runs in its Window node (exec/window.py)")


class RowNumber(WindowFunction):
    """The row's position in its partition, from 1."""
    fn_name = "row_number"


class Rank(WindowFunction):
    """1 + the rows of the partition before the row's first peer."""
    fn_name = "rank"


class DenseRank(WindowFunction):
    """The number of peer groups of the partition up to the row's."""
    fn_name = "dense_rank"
