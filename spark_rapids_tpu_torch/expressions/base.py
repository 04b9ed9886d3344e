"""Expression tree (the analog of ``spark_rapids_tpu/expressions/base.py``).

Each expression class has a plain PyTorch ``eval`` that follows Spark's
null rules; it is the CPU path and the plain version the fused kernel is
held against.  The kernel path does not call ``eval``: the emitter registry
of ``kernels/fused_agg.py`` turns the same tree into Triton source."""

from __future__ import annotations

import copy
import datetime
import decimal
from typing import Callable, List, Optional, Sequence

import torch

from spark_rapids_tpu_torch import types as T


class Col:
    """An evaluated column: data and bool validity, ``row_count`` long; a
    string also has its offsets (``data`` is then its chars plane)."""

    __slots__ = ("data", "valid", "offsets")

    def __init__(self, data: torch.Tensor, valid: torch.Tensor,
                 offsets: Optional[torch.Tensor] = None):
        self.data = data
        self.valid = valid
        self.offsets = offsets


class EvalContext:
    """Input columns of one evaluation.  ``literal_args`` holds the values
    of promoted literal slots (plan/stages.py), when a chain runs with
    runtime literals; ``tables`` the lookup tables of its code-space
    conjuncts (``columnar/encoding.py DictContains``)."""

    def __init__(self, cols: Sequence[Col], row_count: int,
                 device: torch.device, literal_args: Optional[list] = None,
                 tables: Optional[list] = None):
        self.cols = list(cols)
        self.row_count = int(row_count)
        self.device = device
        self.literal_args = literal_args
        self.tables = tables

    def full(self, value, dtype: T.DataType) -> Col:
        n = self.row_count
        if isinstance(dtype, T.StringType):
            raw = b"" if value is None else value.encode("utf-8")
            chars = torch.tensor(list(raw) * n, dtype=torch.uint8,
                                 device=self.device)
            offsets = torch.arange(n + 1, dtype=torch.int64,
                                   device=self.device) * len(raw)
            return Col(chars, torch.full((n,), value is not None,
                                         dtype=torch.bool,
                                         device=self.device), offsets)
        wide = isinstance(dtype, T.DecimalType) and dtype.is_decimal128
        if value is None:
            return Col(torch.zeros((n, 2) if wide else n,
                                   dtype=dtype.torch_dtype or torch.int64,
                                   device=self.device),
                       torch.zeros(n, dtype=torch.bool, device=self.device))
        if isinstance(dtype, T.DecimalType):
            from spark_rapids_tpu_torch.columnar.column import (
                unscaled_of, words_of)
            u = unscaled_of(value, dtype.scale)
            data = torch.tensor([words_of(u)] if wide else [u],
                                dtype=torch.int64, device=self.device)
            return Col(data.expand((n, 2) if wide else (n,)).contiguous(),
                       torch.ones(n, dtype=torch.bool, device=self.device))
        if isinstance(dtype, T.DateType):
            value = T.date_days(value)
        return Col(torch.full((n,), value, dtype=dtype.torch_dtype,
                              device=self.device),
                   torch.ones(n, dtype=torch.bool, device=self.device))


class Expression:
    """Base expression node."""

    def __init__(self, children: Sequence["Expression"] = ()):
        self.children: List[Expression] = list(children)

    @property
    def data_type(self) -> T.DataType:
        raise NotImplementedError

    @property
    def nullable(self) -> bool:
        return any(c.nullable for c in self.children) if self.children \
            else True

    @property
    def name(self) -> str:
        return type(self).__name__

    def sql(self) -> str:
        args = ", ".join(c.sql() for c in self.children)
        return f"{self.name}({args})"

    def eval(self, ctx: EvalContext) -> Col:
        raise NotImplementedError(f"{self.name}.eval")

    def alias(self, name: str) -> "Alias":
        return Alias(self, name)

    def with_children(self, children: Sequence["Expression"]
                      ) -> "Expression":
        node = copy.copy(self)
        node.children = list(children)
        return node

    def transform_up(self, fn: Callable[["Expression"], "Expression"]
                     ) -> "Expression":
        node = self.with_children([c.transform_up(fn)
                                   for c in self.children]) \
            if self.children else self
        return fn(node)

    def __repr__(self) -> str:
        return self.sql()


class Literal(Expression):
    def __init__(self, value, dtype: Optional[T.DataType] = None):
        super().__init__()
        self.value = value
        self._dtype = dtype or _infer_literal_type(value)

    @property
    def data_type(self) -> T.DataType:
        return self._dtype

    @property
    def nullable(self) -> bool:
        return self.value is None

    def sql(self):
        if isinstance(self._dtype, T.DateType) and self.value is not None:
            return f"DATE '{self.value.isoformat()}'"
        if isinstance(self.value, decimal.Decimal):
            return f"{self.value}BD"
        return repr(self.value)

    def eval(self, ctx):
        return ctx.full(self.value, self._dtype)


class BoundReference(Expression):
    def __init__(self, ordinal: int, dtype: T.DataType, nullable: bool = True,
                 ref_name: str = ""):
        super().__init__()
        self.ordinal = ordinal
        self._dtype = dtype
        self._nullable = nullable
        self.ref_name = ref_name

    @property
    def data_type(self):
        return self._dtype

    @property
    def nullable(self):
        return self._nullable

    def sql(self):
        return self.ref_name or f"input[{self.ordinal}]"

    def eval(self, ctx):
        return ctx.cols[self.ordinal]


class AttributeReference(Expression):
    """Named column reference, resolved to a BoundReference at bind time."""

    def __init__(self, ref_name: str):
        super().__init__()
        self.ref_name = ref_name

    @property
    def data_type(self):
        raise TypeError(f"unresolved attribute {self.ref_name!r}")

    def sql(self):
        return self.ref_name


class Alias(Expression):
    def __init__(self, child: Expression, alias_name: str):
        super().__init__([child])
        self.alias_name = alias_name

    @property
    def data_type(self):
        return self.children[0].data_type

    @property
    def nullable(self):
        return self.children[0].nullable

    def sql(self):
        return f"{self.children[0].sql()} AS {self.alias_name}"

    def eval(self, ctx):
        return self.children[0].eval(ctx)


class Grouping(Expression):
    """``grouping(key)`` of a grouping-set aggregation: it holds only in a
    ``rollup(...).agg(...)``, which replaces it with the key's bit of the
    grouping id (``session.py GroupedData``)."""

    def __init__(self, key: Expression):
        super().__init__([key])

    @property
    def data_type(self):
        return T.LONG

    @property
    def nullable(self) -> bool:
        return False

    def sql(self):
        return f"grouping({self.children[0].sql()})"


def _infer_literal_type(value) -> T.DataType:
    if value is None:
        return T.NULL
    if isinstance(value, bool):
        return T.BOOLEAN
    if isinstance(value, int):
        return T.INT if -(2 ** 31) <= value < 2 ** 31 else T.LONG
    if isinstance(value, float):
        return T.DOUBLE
    if isinstance(value, str):
        return T.STRING
    if isinstance(value, datetime.date) and \
            not isinstance(value, datetime.datetime):
        return T.DATE
    if isinstance(value, decimal.Decimal):
        # Spark's type of a BigDecimal literal: its digits and scale
        sign, digits, exponent = value.as_tuple()
        scale = max(0, -exponent)
        precision = max(len(digits) + max(0, exponent), scale, 1)
        if precision > T.DecimalType.MAX_PRECISION:
            raise NotImplementedError(f"literal {value!r} has more than 38 "
                                      "digits")
        return T.DecimalType(precision, scale)
    raise NotImplementedError(
        f"literal {value!r} of {type(value).__name__} is not in this port")


def bind_references(expr: Expression, schema: T.StructType) -> Expression:
    """Resolves AttributeReference names to ordinals."""

    def fix(node: Expression) -> Expression:
        if isinstance(node, AttributeReference):
            i = schema.field_index(node.ref_name)
            f = schema.fields[i]
            return BoundReference(i, f.data_type, f.nullable, f.name)
        return node

    return expr.transform_up(fix)


def output_name(e: Expression) -> str:
    if isinstance(e, Alias):
        return e.alias_name
    if isinstance(e, (BoundReference, AttributeReference)):
        return e.ref_name or e.sql()
    return e.sql()


def col(name: str) -> AttributeReference:
    return AttributeReference(name)


def lit(value, dtype: Optional[T.DataType] = None) -> Literal:
    return Literal(value, dtype)
