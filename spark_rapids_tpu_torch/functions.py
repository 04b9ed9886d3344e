"""DataFrame functions (the subset of ``spark_rapids_tpu/functions.py``
the port supports)."""

from __future__ import annotations

from spark_rapids_tpu_torch.expressions import window_exprs as W
from spark_rapids_tpu_torch.expressions.base import Expression, col, lit

__all__ = ["col", "lit", "sum", "count", "count_distinct", "avg", "asc",
           "desc", "substring", "Window", "WindowBuilder"]


def _expr(e) -> Expression:
    return col(e) if isinstance(e, str) else e


def sum(e):  # noqa: A001 - mirrors pyspark.sql.functions naming
    from spark_rapids_tpu_torch.expressions.aggregates import Sum
    return Sum(_expr(e))


def avg(e):
    from spark_rapids_tpu_torch.expressions.aggregates import Average
    return Average(_expr(e))


def count(e="*"):
    from spark_rapids_tpu_torch.expressions.aggregates import Count
    if isinstance(e, str) and e == "*":
        return Count(lit(1))
    return Count(_expr(e))


def count_distinct(e):
    """``count(DISTINCT e)``: K15d, over one group or K9's groups."""
    from spark_rapids_tpu_torch.expressions.aggregates import CountDistinct
    return CountDistinct(_expr(e))


countDistinct = count_distinct


def asc(e, nulls_first: bool = True):
    from spark_rapids_tpu_torch.exec.sort import SortSpec
    return SortSpec(_expr(e), True, nulls_first)


def desc(e, nulls_first: bool = False):
    from spark_rapids_tpu_torch.exec.sort import SortSpec
    return SortSpec(_expr(e), False, nulls_first)


def substring(e, pos: int, length_: int):
    """``substring(e, pos, len)`` over bytes (``expressions/strings.py``)."""
    from spark_rapids_tpu_torch.expressions.strings import Substring
    return Substring(_expr(e), pos, length_)


# -- windows (``functions.py:125 WindowBuilder``, ``:174 _WindowNamespace``) --

class WindowBuilder:
    """pyspark's ``Window``: ``Window.partition_by("k")``, then optionally
    ``.order_by(...)`` and ``.rows_between(a, b)`` (which the port refuses
    at planning, by name)."""

    def __init__(self, spec=None):
        self.spec = spec or W.WindowSpecDef([], [], None)

    def _with(self, partition=None, order=None, frame=None):
        s = self.spec
        return WindowBuilder(W.WindowSpecDef(
            s.partition_exprs if partition is None else partition,
            s.order_specs if order is None else order,
            s.frame if frame is None else frame))

    def partition_by(self, *cols) -> "WindowBuilder":
        return self._with(partition=[_expr(c) for c in cols])

    def order_by(self, *cols) -> "WindowBuilder":
        from spark_rapids_tpu_torch.exec.sort import SortSpec
        specs = [(c.expr, c.ascending, c.effective_nulls_first)
                 if isinstance(c, SortSpec) else (_expr(c), True, True)
                 for c in cols]
        return self._with(order=specs)

    def rows_between(self, start: int, end: int) -> "WindowBuilder":
        return self._with(frame=W.WindowFrame("rows", int(start), int(end)))


class _WindowNamespace:
    """``Window.partition_by(...)``."""

    def partition_by(self, *cols) -> WindowBuilder:
        return WindowBuilder().partition_by(*cols)


Window = _WindowNamespace()
