"""Conditionals (the analog of ``spark_rapids_tpu/expressions/
conditional.py``): ``If`` (``:100``) and ``CaseWhen`` (``:132``); a null
predicate selects the else branch."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import (BoundReference, Col,
                                                     EvalContext,
                                                     Expression, Literal)


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


class CaseWhen(Expression):
    """``CASE WHEN p1 THEN v1 [WHEN p2 THEN v2]... [ELSE e] END``: the
    value of the first branch whose predicate is true (a null predicate
    is not), else ``e``, else null.  A numeric result is the right fold
    of ``If`` the JAX package evaluates.

    A string result is allowed only where every value is one string
    column or a null literal: it is then a view of that column (its
    offsets and chars), valid where a branch that holds the column is
    taken and the column's row is valid (``view_column``).  Other
    computed strings have no form in the port yet."""

    def __init__(self, branches, else_value: Optional[Expression] = None):
        pairs = [(p, v) for p, v in branches]
        if not pairs:
            raise ValueError("CASE WHEN needs at least one branch")
        self._n = len(pairs)
        super().__init__([e for pv in pairs for e in pv] +
                         [Literal(None) if else_value is None
                          else else_value])

    @property
    def branches(self) -> List[Tuple[Expression, Expression]]:
        c = self.children
        return [(c[2 * i], c[2 * i + 1]) for i in range(self._n)]

    @property
    def else_value(self) -> Expression:
        return self.children[-1]

    def with_children(self, children):
        n = self._n
        return CaseWhen([(children[2 * i], children[2 * i + 1])
                         for i in range(n)], children[-1])

    def when(self, predicate: Expression, value: Expression) -> "CaseWhen":
        """pyspark's ``when(...).when(...)``."""
        return CaseWhen(self.branches + [(predicate, value)],
                        self.else_value)

    def otherwise(self, value: Expression) -> "CaseWhen":
        return CaseWhen(self.branches, value)

    @property
    def data_type(self):
        dt = T.NULL
        for v in [v for _p, v in self.branches] + [self.else_value]:
            dt = T.common_type(dt, v.data_type)
        return dt

    @property
    def nullable(self) -> bool:
        return True

    def sql(self):
        body = " ".join(f"WHEN {p.sql()} THEN {v.sql()}"
                        for p, v in self.branches)
        return f"CASE {body} ELSE {self.else_value.sql()} END"

    def folded(self) -> Expression:
        """The right fold of ``If`` (JAX ``_eval``)."""
        e = self.else_value
        for p, v in reversed(self.branches):
            e = If(p, v, e)
        return e

    def view_column(self) -> BoundReference:
        """The string column a string result is a view of; raises
        NotImplementedError, naming the expression, when a value is
        another string."""
        refs = []
        for v in [v for _p, v in self.branches] + [self.else_value]:
            if isinstance(v, Literal) and v.value is None:
                continue
            if not isinstance(v, BoundReference):
                raise NotImplementedError(
                    f"a computed string ({self.sql()}) has no form in the "
                    "port yet (CASE WHEN over one string column and nulls "
                    "has)")
            refs.append(v)
        if not refs or any(r.ordinal != refs[0].ordinal for r in refs):
            raise NotImplementedError(
                f"a computed string ({self.sql()}) has no form in the port "
                "yet (CASE WHEN over one string column and nulls has)")
        return refs[0]

    def holds_column(self, value: Expression) -> bool:
        """A string result's branch value is its column (not a null)."""
        return not (isinstance(value, Literal) and value.value is None)

    def eval(self, ctx: EvalContext) -> Col:
        if not isinstance(self.data_type, T.StringType):
            return self.folded().eval(ctx)
        column = self.view_column().eval(ctx)
        rest = torch.ones(ctx.row_count, dtype=torch.bool,
                          device=ctx.device)
        taken = torch.zeros_like(rest)
        for p, v in self.branches:
            pc = p.eval(ctx)
            hit = rest & pc.valid & pc.data
            if self.holds_column(v):
                taken = taken | hit
            rest = rest & ~hit
        if self.holds_column(self.else_value):
            taken = taken | rest
        return Col(column.data, taken & column.valid, column.offsets)
