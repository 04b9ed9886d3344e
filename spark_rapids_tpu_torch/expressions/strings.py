"""String functions (the analog of ``spark_rapids_tpu/expressions/
strings.py``): ``Substring`` (``:157``) and ``Concat`` (``:105``).

``Substring`` works on bytes, as the JAX package's device form does: a
1-based ``pos`` (0 acts as 1, a negative one counts from the end) and an
optional ``len``.  ``pos`` and ``len`` are integer literals.  ``Concat``
is NULL if any input is NULL; its inputs are string columns and string
literals.

Their plain ``eval`` builds the result's offsets and chars
(``ops/string_ops.py``, K13's plain form).  On the kernel path a
``Substring`` that ``=`` or ``IN`` compares stays a byte view ``(start,
length)`` into the value's own chars (``kernels/fused_agg.py``), so no
string is written; every other consumer gets a string column that K13
writes (``k13_form``: a substring of a string column, a concat of string
columns and literals, a string literal)."""

from __future__ import annotations

from typing import List, Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Col, EvalContext,
                                                     Expression, Literal)
from spark_rapids_tpu_torch.ops import string_ops as SO

#: the length of a substring with no ``len`` (the JAX package's 2**30)
NO_LENGTH = SO.NO_LENGTH


def _int_literal(x, what: str) -> Literal:
    value = x.value if isinstance(x, Literal) else x
    if isinstance(value, bool) or not isinstance(value, int):
        raise NotImplementedError(
            f"substring's {what} must be an integer literal in the port, "
            f"got {x!r}")
    return Literal(int(value), T.INT)


def _eval_plain(op: int, children, ctx: EvalContext, **kw) -> Col:
    """K13's plain form over evaluated children (a string literal is its
    bytes, a null one None)."""
    parts = []
    for c in children:
        if isinstance(c, Literal):
            parts.append(None if c.value is None else
                         c.value.encode("utf-8"))
            continue
        v = c.eval(ctx)
        parts.append((v.data, v.offsets, v.valid))
    chars, offsets, valid = SO.compute_plain(
        op, parts, ctx.row_count, ctx.device, int, **kw)
    return Col(chars, valid, offsets)


class Substring(Expression):
    def __init__(self, child: Expression, pos, length=None):
        kids = [child, _int_literal(pos, "pos")]
        if length is not None:
            kids.append(_int_literal(length, "len"))
        super().__init__(kids)

    @property
    def data_type(self):
        return T.STRING

    @property
    def pos(self) -> int:
        return self.children[1].value

    @property
    def length(self) -> Optional[int]:
        return self.children[2].value if len(self.children) > 2 else None

    def sql(self):
        args = ", ".join(c.sql() for c in self.children)
        return f"substring({args})"

    def eval(self, ctx: EvalContext) -> Col:
        return _eval_plain(SO.SUBSTRING, self.children[:1], ctx,
                           pos=self.pos, length=self.length)


class Concat(Expression):
    """``concat(...)``: NULL if any input is NULL (Spark's rule)."""

    def __init__(self, *exprs: Expression):
        if not exprs:
            raise ValueError("concat needs at least one input")
        super().__init__(list(exprs))

    @property
    def data_type(self):
        return T.STRING

    def sql(self):
        return f"concat({', '.join(c.sql() for c in self.children)})"

    def eval(self, ctx: EvalContext) -> Col:
        for c in self.children:
            if not isinstance(c.data_type, (T.StringType, T.NullType)):
                raise NotImplementedError(
                    f"{self.sql()}: concat of {c.data_type} is not in the "
                    "port yet (of strings is)")
        return _eval_plain(SO.CONCAT, self.children, ctx)


class StringForm:
    """What K13 writes for one computed string output: ``op``
    (``SUBSTRING`` or ``CONCAT``), its parts (an input column's ordinal,
    or a literal's bytes or None) and a substring's ``pos`` and
    ``length``."""

    def __init__(self, op: int, parts: List, pos: int = 1,
                 length: Optional[int] = None):
        self.op = op
        self.parts = parts
        self.pos = pos
        self.length = length

    def run(self, columns, n: int, device, transfers,
            rows: Optional[torch.Tensor] = None):
        """K13 over ``columns`` (the stage's input columns), ``n`` output
        rows (``rows``: the input row of each)."""
        parts = [columns[p] if isinstance(p, int) else p
                 for p in self.parts]
        return SO.string_column(self.op, parts, n, device, transfers,
                                self.pos, self.length, rows)


def _unalias(e: Expression) -> Expression:
    while isinstance(e, Alias):
        e = e.children[0]
    return e


#: what ``_string_part`` gives for an input K13 cannot read
_NOT_A_PART = object()


def _string_part(e: Expression):
    """A string column's ordinal, a string literal's bytes (None for a
    null one), else ``_NOT_A_PART``."""
    e = _unalias(e)
    if isinstance(e, BoundReference) and isinstance(e.data_type,
                                                    T.StringType):
        return e.ordinal
    if type(e) is Literal and (e.value is None or isinstance(e.value, str)):
        return None if e.value is None else e.value.encode("utf-8")
    return _NOT_A_PART


def k13_form(e: Expression) -> Optional[StringForm]:
    """The K13 form of a computed string output over input columns: a
    substring of a string column, a concat of string columns and
    literals (at most ``ops/string_ops.py MAX_PARTS``), or a string
    literal (a concat of one literal); None for any other expression."""
    e = _unalias(e)
    if isinstance(e, Substring):
        part = _string_part(e.children[0])
        return StringForm(SO.SUBSTRING, [part], e.pos, e.length) \
            if isinstance(part, int) else None
    if isinstance(e, Concat) and len(e.children) <= SO.MAX_PARTS:
        parts = [_string_part(c) for c in e.children]
        return None if any(p is _NOT_A_PART for p in parts) else \
            StringForm(SO.CONCAT, parts)
    if type(e) is Literal and isinstance(e.data_type, T.StringType):
        return StringForm(SO.CONCAT, [_string_part(e)])
    return None
