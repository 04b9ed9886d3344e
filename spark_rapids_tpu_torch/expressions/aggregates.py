"""Declarative aggregate functions (the analog of ``spark_rapids_tpu/
expressions/aggregates.py``): each function names its buffers with an
update kind and a merge kind, and a final expression over the merged
buffers.  ``Average`` (``:154``) keeps the JAX package's buffers: a double
sum of ``Cast(child, DOUBLE)`` and a count, and the final expression
``If(cnt > 0, sum / cnt, NULL)``; the variance family (``_CentralMoment``,
``:228``) its count, mean and m2.

Decimals (``:72-75``, ``:154-190``): ``sum`` of decimal(p, s) is
decimal(min(38, p + 10), s), a decimal buffer summed exactly (K9, K1 and
K3's decimal sum kinds: they wrap past 128 bits as the JAX kernels do,
which below the 38-digit clamp takes more than 10^10 rows).  ``avg`` of
decimal(p, s) is decimal(min(38, p + 4), min(38, s + 4)) by Spark's rule:
its buffers are that sum and a count, and its final value
(``DecimalAverage``) divides the sum by the count at the scale of
Spark's ``Divide(sum, cast(count as decimal(20,0)))`` and casts the
quotient to the result type, both HALF_UP, NULL for a count of 0.  The
JAX package divides as doubles and casts back through its faulty cast
(ROADMAP queue 3)."""

from __future__ import annotations

import dataclasses
from typing import List

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Expression, Literal


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    name: str
    dtype: T.DataType
    update_kind: str   # reduction over the input column
    merge_kind: str    # reduction over partial buffers
    input_ordinal: int = 0
    count_valid_only: bool = True


class AggregateFunction(Expression):
    is_aggregate = True

    @property
    def nullable(self) -> bool:
        return True

    def inputs(self) -> List[Expression]:
        return list(self.children)

    def buffers(self) -> List[BufferSpec]:
        raise NotImplementedError

    def evaluate(self, refs: List[Expression]) -> Expression:
        raise NotImplementedError

    def sql(self):
        args = ", ".join(c.sql() for c in self.children)
        return f"{type(self).__name__.lower()}({args})"

    def over(self, spec) -> Expression:
        """This aggregate over a window (``functions.Window`` or a
        ``WindowSpecDef``)."""
        from spark_rapids_tpu_torch.expressions.window_exprs import (
            WindowExpression, to_spec)
        return WindowExpression(self, to_spec(spec))


def _sum_result_type(dt: T.DataType) -> T.DataType:
    if isinstance(dt, T.DecimalType):
        return T.DecimalType(min(38, dt.precision + 10), dt.scale)
    return T.DOUBLE if dt.is_floating else T.LONG


def avg_types(dt: T.DecimalType):
    """``(sum, quotient, result)`` types of ``avg`` over a decimal: the
    sum buffer's, Spark's ``Divide(sum, cast(count as decimal(20,0)))``,
    and the average's."""
    from spark_rapids_tpu_torch.expressions.decimal_math import \
        binary_result_type
    total = _sum_result_type(dt)
    return (total, binary_result_type("div", total, T.DecimalType(20, 0)),
            T.DecimalType(min(38, dt.precision + 4), min(dt.scale + 4, 38)))


class Sum(AggregateFunction):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return _sum_result_type(self.children[0].data_type)

    def buffers(self):
        return [BufferSpec("sum", self.data_type, "sum", "sum"),
                BufferSpec("cnt", T.LONG, "count", "sum")]

    def evaluate(self, refs):
        # Spark: the sum of an empty or all-null group is NULL, not 0
        from spark_rapids_tpu_torch.expressions.conditional import If
        from spark_rapids_tpu_torch.expressions.predicates import \
            GreaterThan
        return If(GreaterThan(refs[1], Literal(0, T.LONG)),
                  refs[0], Literal(None, self.data_type))


class Count(AggregateFunction):
    """count(expr) counts non-null rows; count(lit(1)) == count(*)."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.LONG

    @property
    def nullable(self):
        return False

    def buffers(self):
        count_all = isinstance(self.children[0], Literal) and \
            self.children[0].value is not None
        return [BufferSpec("cnt", T.LONG, "count", "sum",
                           count_valid_only=not count_all)]

    def evaluate(self, refs):
        return refs[0]


class Average(AggregateFunction):
    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def decimal(self) -> bool:
        return isinstance(self.children[0].data_type, T.DecimalType)

    @property
    def data_type(self):
        if self.decimal:
            return avg_types(self.children[0].data_type)[2]
        return T.DOUBLE

    def inputs(self):
        from spark_rapids_tpu_torch.expressions.cast import Cast
        if self.decimal:
            return [self.children[0]]
        return [Cast(self.children[0], T.DOUBLE)]

    def buffers(self):
        total = avg_types(self.children[0].data_type)[0] if self.decimal \
            else T.DOUBLE
        return [BufferSpec("sum", total, "sum", "sum"),
                BufferSpec("cnt", T.LONG, "count", "sum")]

    def evaluate(self, refs):
        if self.decimal:
            return DecimalAverage(refs[0], refs[1],
                                  self.children[0].data_type)
        from spark_rapids_tpu_torch.expressions.arithmetic import Divide
        from spark_rapids_tpu_torch.expressions.cast import Cast
        from spark_rapids_tpu_torch.expressions.conditional import If
        from spark_rapids_tpu_torch.expressions.predicates import \
            GreaterThan
        return If(GreaterThan(refs[1], Literal(0, T.LONG)),
                  Divide(Cast(refs[0], T.DOUBLE), Cast(refs[1], T.DOUBLE)),
                  Literal(None, T.DOUBLE))


class DecimalAverage(Expression):
    """The final value of ``avg`` over decimal(p, s) from its buffers
    (a decimal sum and a count), by Spark's rule (``avg_types``): the
    sum divided by the count at the quotient's scale, then cast to the
    result type, both HALF_UP; NULL for a count of 0 or an overflow.
    Its kernel is ``csrc/decimal.cu`` (``ops/decimal_ops.py
    avg_finish``): a K6 projection leaves it out and launches it after
    itself (``avg_form``)."""

    def __init__(self, total: Expression, count: Expression,
                 input_type: T.DecimalType):
        super().__init__([total, count])
        self.input_type = input_type

    @property
    def data_type(self):
        return avg_types(self.input_type)[2]

    def sql(self):
        return (f"decimal_avg({self.children[0].sql()}, "
                f"{self.children[1].sql()})")

    def eval(self, ctx) -> "Col":
        from spark_rapids_tpu_torch.expressions.base import Col
        from spark_rapids_tpu_torch.ops.decimal_ops import avg_finish
        s, c = (ch.eval(ctx) for ch in self.children)
        data, valid = avg_finish(s.data, s.valid, c.data, c.valid,
                                 self.input_type)
        return Col(data, valid)


class AvgForm:
    """A ``DecimalAverage`` output of a projection over its two input
    columns (the form ``exec/fused.py StageProgram`` runs after K6)."""

    def __init__(self, e: DecimalAverage, total: int, count: int):
        self.input_type = e.input_type
        self.total = total
        self.count = count

    def run(self, columns, n: int, device, transfers, rows=None):
        from spark_rapids_tpu_torch.columnar.column import DeviceColumn
        from spark_rapids_tpu_torch.ops.decimal_ops import avg_finish
        if rows is not None:
            raise NotImplementedError("a decimal avg's finish behind a "
                                      "filter is not in the port")
        s, c = columns[self.total], columns[self.count]
        data, valid = avg_finish(s.data, s.validity, c.data, c.validity,
                                 self.input_type)
        return DeviceColumn(data, valid, avg_types(self.input_type)[2])


def avg_form(e: Expression):
    """The ``AvgForm`` of a projection output that is a ``DecimalAverage``
    of two columns, else None."""
    from spark_rapids_tpu_torch.expressions.base import (Alias,
                                                         BoundReference)
    while isinstance(e, Alias):
        e = e.children[0]
    if not isinstance(e, DecimalAverage):
        return None
    total, count = e.children
    if not (isinstance(total, BoundReference) and
            isinstance(count, BoundReference)):
        raise NotImplementedError(f"{e.sql()}: a decimal avg's finish of "
                                  "computed buffers is not in the port")
    return AvgForm(e, total.ordinal, count.ordinal)


class Min(AggregateFunction):
    """``min`` (JAX ``:124``): of the input's type, buffer kind ``min``;
    K9 folds it in a group-by (and merges it, FINAL), K1 and K3 in a
    global aggregate, K14s and K14b over a window.  Strings are refused
    by name, as on the JAX device path."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return self.children[0].data_type

    def buffers(self):
        return [BufferSpec("min", self.data_type, "min", "min")]

    def evaluate(self, refs):
        return refs[0]


class Max(Min):
    """``max`` (JAX ``:139``), as ``Min``."""

    def buffers(self):
        return [BufferSpec("max", self.data_type, "max", "max")]


class First(AggregateFunction):
    """``first(e, ignore_nulls)`` (JAX ``:190``): the first row's value in
    row order (kind ``first``), or the first non-null one (``first_valid``
    with ``ignore_nulls``), of the input's type; the merge takes the same
    kind over the buffer rows, so a global ``first`` over a partition
    that kept no row is null, as the JAX package gives it (ROADMAP queue
    3)."""

    kind = "first"

    def __init__(self, child: Expression, ignore_nulls: bool = False):
        super().__init__([child])
        self.ignore_nulls = ignore_nulls

    @property
    def data_type(self):
        return self.children[0].data_type

    def buffers(self):
        kind = f"{self.kind}_valid" if self.ignore_nulls else self.kind
        return [BufferSpec(self.kind, self.data_type, kind, kind)]

    def evaluate(self, refs):
        return refs[0]


class Last(First):
    """``last(e, ignore_nulls)`` (JAX ``:209``), as ``First`` from the
    other end."""

    kind = "last"


class CountDistinct(AggregateFunction):
    """count(DISTINCT x): the distinct non-null values; LONG, never null
    (0 for an empty or all-null group)."""

    requires_complete = True

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.LONG

    @property
    def nullable(self):
        return False

    def sql(self):
        return f"count(DISTINCT {self.children[0].sql()})"

    def buffers(self):
        return [BufferSpec("distinct", T.LONG, "distinct", "distinct")]

    def evaluate(self, refs):
        return refs[0]


class CollectList(AggregateFunction):
    """collect_list(x): the group's present values in row order, an array
    of x's type with no null element (``[]`` for an empty or all-null
    group, never null), as the JAX package's ``CollectList``
    (``:307``) plans it: COMPLETE mode over the raw rows (K15)."""

    requires_complete = True
    #: the update kind of its buffer (exec/aggregate.py)
    kind = "list"

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.ArrayType(self.children[0].data_type, contains_null=False)

    @property
    def nullable(self):
        return False

    def sql(self):
        return f"{self.kind_name}({self.children[0].sql()})"

    kind_name = "collect_list"

    def buffers(self):
        return [BufferSpec(self.kind, self.data_type, self.kind, self.kind)]

    def evaluate(self, refs):
        return refs[0]


class CollectSet(CollectList):
    """collect_set(x): the group's distinct present values (-0.0 equals
    0.0, every NaN is one value), each once, in first-seen order (JAX
    ``:324``; Spark leaves the order unspecified)."""

    kind = "set"
    kind_name = "collect_set"


class _CentralMoment(AggregateFunction):
    """The variance family over the JAX package's buffers (``:228``):
    count, mean and m2 (the sum of squared deviations from the group's
    mean) of ``Cast(child, DOUBLE)``.  A group-by folds the count and m2
    on K9 (its m2 kind: the mean, then the squared deviations, two passes
    over the group's rows); the PARTIAL/FINAL merge (``m2_cnt``,
    ``m2_mean``, ``m2_m2``: Chan's formula) is not in the port yet."""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.DOUBLE

    def inputs(self):
        from spark_rapids_tpu_torch.expressions.cast import Cast
        return [Cast(self.children[0], T.DOUBLE)]

    def buffers(self):
        return [BufferSpec("cnt", T.DOUBLE, "count", "m2_cnt"),
                BufferSpec("mean", T.DOUBLE, "mean", "m2_mean"),
                BufferSpec("m2", T.DOUBLE, "m2", "m2_m2")]

    def _final(self, refs):
        raise NotImplementedError

    def evaluate(self, refs):
        """The result from ``[cnt, mean, m2]`` (DOUBLE) references."""
        return self._final(refs)


class VarianceSamp(_CentralMoment):
    """``var_samp``: ``If(n > 1, m2 / (n - 1), NULL)`` (``:259``)."""

    def sql(self):
        return f"var_samp({self.children[0].sql()})"

    def _final(self, refs):
        from spark_rapids_tpu_torch.expressions.arithmetic import (Divide,
                                                                   Subtract)
        from spark_rapids_tpu_torch.expressions.conditional import If
        from spark_rapids_tpu_torch.expressions.predicates import \
            GreaterThan
        n, m2 = refs[0], refs[2]
        return If(GreaterThan(n, Literal(1.0, T.DOUBLE)),
                  Divide(m2, Subtract(n, Literal(1.0, T.DOUBLE))),
                  Literal(None, T.DOUBLE))


class VariancePop(_CentralMoment):
    """``var_pop``: ``If(n > 0, m2 / n, NULL)``."""

    def sql(self):
        return f"var_pop({self.children[0].sql()})"

    def _final(self, refs):
        from spark_rapids_tpu_torch.expressions.arithmetic import Divide
        from spark_rapids_tpu_torch.expressions.conditional import If
        from spark_rapids_tpu_torch.expressions.predicates import \
            GreaterThan
        n, m2 = refs[0], refs[2]
        return If(GreaterThan(n, Literal(0.0, T.DOUBLE)), Divide(m2, n),
                  Literal(None, T.DOUBLE))


class StddevSamp(_CentralMoment):
    """``stddev_samp``: ``Sqrt`` of ``var_samp``'s final (``:279``)."""

    def sql(self):
        return f"stddev_samp({self.children[0].sql()})"

    def _final(self, refs):
        from spark_rapids_tpu_torch.expressions.mathexprs import Sqrt
        return Sqrt(VarianceSamp(self.children[0])._final(refs))


class StddevPop(_CentralMoment):
    """``stddev_pop``: ``Sqrt`` of ``var_pop``'s final."""

    def sql(self):
        return f"stddev_pop({self.children[0].sql()})"

    def _final(self, refs):
        from spark_rapids_tpu_torch.expressions.mathexprs import Sqrt
        return Sqrt(VariancePop(self.children[0])._final(refs))


@dataclasses.dataclass
class AggregateExpression:
    """An aggregate and its output name."""
    func: AggregateFunction
    out_name: str
