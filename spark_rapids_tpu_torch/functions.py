"""DataFrame functions (the subset of ``spark_rapids_tpu/functions.py``
the port supports)."""

from __future__ import annotations

from spark_rapids_tpu_torch.expressions.base import Expression, col, lit

__all__ = ["col", "lit", "sum", "count", "asc", "desc"]


def _expr(e) -> Expression:
    return col(e) if isinstance(e, str) else e


def sum(e):  # noqa: A001 - mirrors pyspark.sql.functions naming
    from spark_rapids_tpu_torch.expressions.aggregates import Sum
    return Sum(_expr(e))


def count(e="*"):
    from spark_rapids_tpu_torch.expressions.aggregates import Count
    if isinstance(e, str) and e == "*":
        return Count(lit(1))
    return Count(_expr(e))


def asc(e, nulls_first: bool = True):
    from spark_rapids_tpu_torch.exec.sort import SortSpec
    return SortSpec(_expr(e), True, nulls_first)


def desc(e, nulls_first: bool = False):
    from spark_rapids_tpu_torch.exec.sort import SortSpec
    return SortSpec(_expr(e), False, nulls_first)
