"""String functions (the analog of ``spark_rapids_tpu/expressions/
strings.py``): ``Substring`` (``:157``), ``Concat`` (``:105``),
``Length`` (``:42``), ``Upper`` and ``Lower`` (``:68-102``) and, with a
plain form only, ``Like`` (``:313``).

``Substring`` works on characters, as Spark and the JAX CPU engine do (a
character is a byte that is not a continuation byte with the
continuation bytes after it; the JAX device form cuts bytes, ROADMAP
queue 3): a 1-based ``pos`` (0 acts as 1, a negative one counts from the
end, clamped first) and an optional ``len``.  ``pos`` and ``len`` are
integer literals.  ``Concat`` is NULL if any input is NULL; its inputs
are string columns and string literals.  ``Length`` counts characters
(an INT).  ``Upper`` and ``Lower`` map by Python's ``str.upper`` and
``str.lower``, the JAX CPU engine's rule (the JAX device form maps ASCII
only).

Their plain ``eval`` builds the result's planes (``ops/string_ops.py``,
K13's plain form).  On the kernel path a ``Substring`` that ``=`` or
``IN`` compares stays a view ``(start, length)`` into the value's own
chars (``kernels/fused_agg.py``), so no string is written; every other
consumer gets a column that K13 writes (``k13_form``: a substring, an
upper or lower case, or the length of a string column, a concat of
string columns and literals, a string literal)."""

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


class _StringMap(Expression):
    """A function of one string (``Length``, ``Upper``, ``Lower``)."""

    #: its ``ops/string_ops.py`` op
    op = None
    name = ""

    def __init__(self, child: Expression):
        super().__init__([child])

    @property
    def data_type(self):
        return T.STRING

    def sql(self):
        return f"{self.name}({self.children[0].sql()})"

    def _child(self, ctx: EvalContext) -> Col:
        c = self.children[0]
        if not isinstance(c.data_type, T.StringType):
            raise NotImplementedError(
                f"{self.sql()}: {self.name} of {c.data_type} is not in the "
                "port (of a string is)")
        return c.eval(ctx)

    def eval(self, ctx: EvalContext) -> Col:
        v = self._child(ctx)
        chars, offsets, valid = SO.compute_plain(
            self.op, [(v.data, v.offsets, v.valid)], ctx.row_count,
            ctx.device, int)
        return Col(chars, valid, offsets)


class Length(_StringMap):
    """``length(s)``: its characters, an INT (null for a null)."""

    op = SO.LENGTH
    name = "length"

    @property
    def data_type(self):
        return T.INT

    def eval(self, ctx: EvalContext) -> Col:
        v = self._child(ctx)
        count, valid = SO.length_plain(v.data, v.offsets, v.valid)
        return Col(count, valid)


class Upper(_StringMap):
    op = SO.UPPER
    name = "upper"


class Lower(_StringMap):
    op = SO.LOWER
    name = "lower"


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
    """What K13 writes for one computed output: ``op`` (``SUBSTRING``,
    ``CONCAT``, ``UPPER``, ``LOWER``, or ``LENGTH``, K13's length pass),
    its parts (an input column's ordinal, or a literal's bytes or None)
    and a substring's ``pos`` and ``length``."""

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
        if self.op == SO.LENGTH:
            return SO.string_length(parts[0], n, rows)
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
    """The K13 form of a computed output over input columns: a substring,
    an upper or lower case or the length of a string column, a concat of
    string columns and literals (at most ``ops/string_ops.py
    MAX_PARTS``), or a string literal (a concat of one literal); None for
    any other expression."""
    e = _unalias(e)
    if isinstance(e, _StringMap):
        part = _string_part(e.children[0])
        return StringForm(e.op, [part]) if isinstance(part, int) else None
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


class Like(Expression):
    """``s LIKE pattern`` (the JAX package's ``Like``, ``expressions/
    strings.py:313``): ``%`` any run of characters, ``_`` one character,
    ``\\`` escapes the next one; the pattern is a string literal.  It has
    a plain ``eval`` only (host regex matching, as the JAX package's
    ``eval_cpu``): it runs where a conjunct over a dictionary column is
    evaluated once over the dictionary's values (``columnar/encoding.py
    lookup_table``); inside a kernel it is refused by name."""

    def __init__(self, child: Expression, pattern):
        value = pattern.value if isinstance(pattern, Literal) else pattern
        if not isinstance(value, str):
            raise NotImplementedError(
                f"LIKE takes a string literal pattern in the port, got "
                f"{pattern!r}")
        super().__init__([child])
        self.pattern = value

    @property
    def data_type(self):
        return T.BOOLEAN

    def sql(self):
        return f"({self.children[0].sql()} LIKE {self.pattern!r})"

    def regex(self):
        import re
        out, i, p = "^", 0, self.pattern
        while i < len(p):
            ch = p[i]
            if ch == "\\" and i + 1 < len(p):
                out += re.escape(p[i + 1])
                i += 2
                continue
            out += ".*" if ch == "%" else "." if ch == "_" else re.escape(ch)
            i += 1
        return re.compile(out + "$", flags=re.DOTALL)

    def eval(self, ctx: EvalContext) -> Col:
        c = self.children[0].eval(ctx)
        rx = self.regex()
        raw = c.data.cpu().numpy().tobytes()
        offs = c.offsets.cpu().tolist()
        valid = c.valid.cpu().tolist()
        hits = [ok and rx.match(raw[offs[i]:offs[i + 1]].decode("utf-8"))
                is not None for i, ok in enumerate(valid)]
        return Col(torch.tensor(hits, dtype=torch.bool, device=ctx.device),
                   c.valid)
