"""DataFrame functions (the subset of ``spark_rapids_tpu/functions.py``
the port supports)."""

from __future__ import annotations

from spark_rapids_tpu_torch.expressions import window_exprs as W
from spark_rapids_tpu_torch.expressions.base import Expression, col, lit

__all__ = ["col", "lit", "sum", "count", "count_distinct", "avg", "min",
           "max", "first", "last", "stddev", "stddev_samp", "stddev_pop", "var_samp",
           "var_pop", "asc", "desc", "substring", "concat", "when",
           "grouping",
           "row_number", "rank", "dense_rank", "ntile", "lag", "lead",
           "Window", "WindowBuilder"]


def _expr(e) -> Expression:
    return col(e) if isinstance(e, str) else e


def sum(e):  # noqa: A001 - mirrors pyspark.sql.functions naming
    """``sum``: a long of ints and longs, a double of doubles, and of a
    decimal(p, s) a decimal(min(38, p + 10), s), summed exactly."""
    from spark_rapids_tpu_torch.expressions.aggregates import Sum
    return Sum(_expr(e))


def avg(e):
    """``avg``: a double, or of a decimal(p, s) a decimal(p + 4, s + 4)
    by Spark's rule (HALF_UP; ``expressions/aggregates.py avg_types``)."""
    from spark_rapids_tpu_torch.expressions.aggregates import Average
    return Average(_expr(e))


def min(e):  # noqa: A001 - mirrors pyspark.sql.functions naming
    """``min`` of an int, date, long or double column: K9 in a group-by,
    K1 and K3 in a global aggregate, K14s and K14b over a window."""
    from spark_rapids_tpu_torch.expressions.aggregates import Min
    return Min(_expr(e))


def max(e):  # noqa: A001
    """``max``, as ``min``."""
    from spark_rapids_tpu_torch.expressions.aggregates import Max
    return Max(_expr(e))


def first(e, ignore_nulls=False):
    """The first row's value (the first non-null one with
    ``ignore_nulls``) of an int, date, long, double or string column: K9
    in a group-by, K1, K3 and K7 in a global aggregate."""
    from spark_rapids_tpu_torch.expressions.aggregates import First
    return First(_expr(e), ignore_nulls)


def last(e, ignore_nulls=False):
    """The last row's value, as ``first``."""
    from spark_rapids_tpu_torch.expressions.aggregates import Last
    return Last(_expr(e), ignore_nulls)


def count(e="*"):
    from spark_rapids_tpu_torch.expressions.aggregates import Count
    if isinstance(e, str) and e == "*":
        return Count(lit(1))
    return Count(_expr(e))


def var_samp(e):
    from spark_rapids_tpu_torch.expressions.aggregates import VarianceSamp
    return VarianceSamp(_expr(e))


def var_pop(e):
    from spark_rapids_tpu_torch.expressions.aggregates import VariancePop
    return VariancePop(_expr(e))


def stddev(e):
    """``stddev_samp(e)``: K9's count and m2 kinds, then K6's finish."""
    from spark_rapids_tpu_torch.expressions.aggregates import StddevSamp
    return StddevSamp(_expr(e))


stddev_samp = stddev


def stddev_pop(e):
    from spark_rapids_tpu_torch.expressions.aggregates import StddevPop
    return StddevPop(_expr(e))


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


def concat(*cols):
    """``concat(c1, c2, ...)`` of string columns and literals (a ``lit``;
    a bare name is a column), NULL if any input is NULL; K13 writes it
    (``expressions/strings.py Concat``)."""
    from spark_rapids_tpu_torch.expressions.strings import Concat
    return Concat(*[_expr(c) for c in cols])


def when(condition, value):
    """``CASE WHEN condition THEN value``; chain ``.when(...)`` and
    ``.otherwise(...)`` (``expressions/conditional.py CaseWhen``)."""
    from spark_rapids_tpu_torch.expressions.conditional import CaseWhen
    return CaseWhen([(_expr(condition), _expr(value))])


def grouping(e):
    """``grouping(e)`` in a ``rollup(...).agg(...)``: 1 where the row's
    grouping set drops key ``e``, else 0 (a LONG), computed from the
    grouping id as the JAX analyzer's ``_grouping_bit`` does
    (``session.py GroupedData``)."""
    from spark_rapids_tpu_torch.expressions.base import Grouping
    return Grouping(_expr(e))


def row_number():
    from spark_rapids_tpu_torch.expressions.window_exprs import RowNumber
    return RowNumber()


def rank():
    from spark_rapids_tpu_torch.expressions.window_exprs import Rank
    return Rank()


def dense_rank():
    from spark_rapids_tpu_torch.expressions.window_exprs import DenseRank
    return DenseRank()


def ntile(n: int):
    from spark_rapids_tpu_torch.expressions.window_exprs import NTile
    return NTile(n)


def _default(default):
    from spark_rapids_tpu_torch.expressions.base import Expression as E
    return default if default is None or isinstance(default, E) \
        else lit(default)


def lag(e, offset: int = 1, default=None):
    """The value ``offset`` rows before the row in its window partition
    (K14o, then K7), else ``default``, else null."""
    from spark_rapids_tpu_torch.expressions.window_exprs import Lag
    return Lag(_expr(e), offset, _default(default))


def lead(e, offset: int = 1, default=None):
    """The value ``offset`` rows after the row, as ``lag``."""
    from spark_rapids_tpu_torch.expressions.window_exprs import Lead
    return Lead(_expr(e), offset, _default(default))


# -- windows (``functions.py:125 WindowBuilder``, ``:174 _WindowNamespace``) --

class WindowBuilder:
    """pyspark's ``Window``: ``Window.partition_by("k")``, then optionally
    ``.order_by(...)`` and ``.rows_between(a, b)`` (row offsets, or the
    sentinels ``Window.unboundedPreceding``, ``currentRow`` and
    ``unboundedFollowing``) or ``.range_between(a, b)`` (which the port
    refuses at planning, by name, unless it is the default RANGE frame, as
    the JAX package does)."""

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

    def range_between(self, start: int, end: int) -> "WindowBuilder":
        return self._with(frame=W.WindowFrame("range", int(start),
                                              int(end)))


class _WindowNamespace:
    """``Window.partition_by(...)``, ``Window.order_by(...)`` and the frame
    sentinels (JAX ``functions.py:179-192``)."""

    unboundedPreceding = W.UNBOUNDED_PRECEDING
    unboundedFollowing = W.UNBOUNDED_FOLLOWING
    currentRow = W.CURRENT_ROW

    def partition_by(self, *cols) -> WindowBuilder:
        return WindowBuilder().partition_by(*cols)

    def order_by(self, *cols) -> WindowBuilder:
        return WindowBuilder().order_by(*cols)


Window = _WindowNamespace()
