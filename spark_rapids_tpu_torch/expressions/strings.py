"""String functions (the analog of ``spark_rapids_tpu/expressions/
strings.py``): ``Substring`` (``:157``) so far.

``Substring`` works on bytes, as the JAX package's device form does: a
1-based ``pos`` (0 acts as 1, a negative one counts from the end) and an
optional ``len``.  Its plain ``eval`` builds the result's offsets and chars;
its kernel form (``kernels/fused_agg.py``) is a byte view ``(start,
length)`` into the value's own chars that ``=`` and ``IN`` read, so no
string is written.  ``pos`` and ``len`` are integer literals."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import (Col, EvalContext,
                                                     Expression, Literal)

#: the length of a substring with no ``len`` (the JAX package's 2**30)
NO_LENGTH = 2 ** 30


def _int_literal(x, what: str) -> Literal:
    value = x.value if isinstance(x, Literal) else x
    if isinstance(value, bool) or not isinstance(value, int):
        raise NotImplementedError(
            f"substring's {what} must be an integer literal in the port, "
            f"got {x!r}")
    return Literal(int(value), T.INT)


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

    def bounds(self, lens: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
        """``(start within the value, byte length)`` of each row's
        substring, for values of ``lens`` bytes."""
        pos = self.pos
        if pos > 0:
            start = torch.clamp(lens, max=pos - 1)
        elif pos < 0:
            start = torch.clamp(lens + pos, min=0)
        else:
            start = torch.zeros_like(lens)
        slen = NO_LENGTH if self.length is None else self.length
        return start, torch.clamp(torch.clamp(lens - start, max=slen), min=0)

    def eval(self, ctx: EvalContext) -> Col:
        c = self.children[0].eval(ctx)
        off = c.offsets.to(torch.int64)
        lens = off[1:] - off[:-1]
        start, out_len = self.bounds(lens)
        offsets = torch.zeros(lens.shape[0] + 1, dtype=torch.int64,
                              device=off.device)
        torch.cumsum(out_len, 0, out=offsets[1:])
        total = int(offsets[-1])
        at = torch.repeat_interleave(off[:-1] + start - offsets[:-1],
                                     out_len, output_size=total) + \
            torch.arange(total, dtype=torch.int64, device=off.device)
        return Col(c.data[at], c.valid, offsets)
