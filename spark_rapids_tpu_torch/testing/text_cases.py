"""Seeded inputs of K13's character forms and K15 (chip_smoke.py's phase
2o and tests/test_torch_scaletest_cuda.py use them): string columns of 0
to 40 bytes that mix ASCII, 'é', 'ß', 'İ', sigma in word-final and inner
positions, case-ignorable marks, CJK, 4-byte emoji and bytes that are
not valid UTF-8 (a row is cut at 40 bytes, so a character may be cut
too), and collect inputs of every element type K15 takes, with nulls,
NaN, +-0.0 and +-inf, built in numpy."""

from __future__ import annotations

import numpy as np

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import HostColumn

#: the pieces a string is made of
PIECES = [b"a", b"Z", b"q", b"7", b" ", b"'", b".", "é".encode(),
          "É".encode(), "ß".encode(), "İ".encode(), "Σ".encode(),
          "ς".encode(), "σ".encode(), "ͅ".encode(), "ʰ".encode(),
          "ǅ".encode(), "ﬀ".encode(), "日".encode(), "本".encode(),
          "🎉".encode(), b"\xff", b"\x80", b"\xe6\x97", b"\xc3"]
MAX_BYTES = 40
#: the substrings phase 2o holds in both forms
SUBSTRINGS = ((1, 4), (1, 5), (2, 3), (0, 2), (-1, None), (-3, 2),
              (-50, 4), (41, None), (3, None), (1, 0))


def string_column(rng: np.random.Generator, n: int,
                  null_frac: float = 0.1) -> HostColumn:
    """``n`` strings of 0 to 8 pieces cut at ``MAX_BYTES`` bytes, a null
    row of length 0."""
    widths = np.array([len(p) for p in PIECES], dtype=np.int64)
    table = np.frombuffer(b"".join(PIECES), dtype=np.uint8)
    before = np.cumsum(widths) - widths
    count = rng.integers(0, 9, n)
    picks = rng.integers(0, len(PIECES), int(count.sum()))
    piece_bytes = widths[picks]
    within = np.arange(int(piece_bytes.sum())) - np.repeat(
        np.cumsum(piece_bytes) - piece_bytes, piece_bytes)
    drawn = table[np.repeat(before[picks], piece_bytes) + within]
    row_bytes = np.bincount(np.repeat(np.arange(n), count),
                            weights=piece_bytes, minlength=n).astype(np.int64)
    valid = rng.random(n) >= null_frac
    row_of = np.repeat(np.arange(n), row_bytes)
    at = np.arange(len(drawn)) - np.repeat(np.cumsum(row_bytes) - row_bytes,
                                           row_bytes)
    keep = (at < MAX_BYTES) & valid[row_of]
    lens = np.bincount(row_of[keep], minlength=n).astype(np.int64)
    offsets = np.zeros(n + 1, dtype=np.int32)
    np.cumsum(lens, out=offsets[1:])
    return HostColumn(drawn[keep].copy(), None if valid.all() else valid,
                      T.STRING, offsets)


#: K15's element types
COLLECT_TYPES = {"long": T.LONG, "int": T.INT, "date": T.DATE,
                 "bool": T.BOOLEAN, "double": T.DOUBLE,
                 "decimal": T.DecimalType(12, 2)}
_DOUBLES = np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5, -2.25,
                     1e300])


def collect_values(rng: np.random.Generator, kind: str, n: int,
                   null_frac: float = 0.15) -> HostColumn:
    """``n`` values of ``COLLECT_TYPES[kind]`` drawn from a few hundred
    distinct ones (doubles from the specials and a few hundred others, a
    NaN of another payload among them), ``null_frac`` of them null."""
    dt = COLLECT_TYPES[kind]
    if kind == "double":
        pool = np.concatenate([_DOUBLES, rng.standard_normal(300).round(1),
                               np.array([0x7ff8000000000001],
                                        dtype=np.int64).view(np.float64)])
        data = pool[rng.integers(0, len(pool), n)]
    elif kind == "bool":
        data = rng.integers(0, 2, n).astype(np.bool_)
    elif kind in ("int", "date"):
        data = rng.integers(-300, 300, n).astype(np.int32)
    else:
        data = rng.integers(-(1 << 40), 1 << 40, 500)[
            rng.integers(0, 500, n)].astype(np.int64)
    valid = rng.random(n) >= null_frac
    return HostColumn(data, None if valid.all() else valid, dt)


def view_program(schema, subs, stage: bool):
    """A K6 (or, with ``stage``, K5) program over a string column
    ``s`` and K13's written substrings ``w0``... of it: each output (each
    conjunct of K5's filter) is ``substring(s, pos, len) = w<j>``, the
    substring as a view compared byte by byte with the written one, and
    one compares a view with a literal."""
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import strings as ST
    from spark_rapids_tpu_torch.expressions.base import (Alias,
                                                         BoundReference,
                                                         Literal)
    from spark_rapids_tpu_torch.expressions.predicates import And, EqualTo
    s = BoundReference(0, T.STRING)
    eqs = [EqualTo(ST.Substring(s, p, ln), BoundReference(j + 1, T.STRING))
           for j, (p, ln) in enumerate(subs)]
    lit = EqualTo(ST.Substring(s, 2, 2), Literal("日本", T.STRING))
    if not stage:
        return FU.StageProgram([("project", [Alias(e, f"e{j}") for j, e in
                                             enumerate(eqs + [lit])])],
                               schema, 0)
    cond = eqs[0]
    for e in eqs[1:]:
        cond = And(cond, e)
    return FU.StageProgram([("filter", cond),
                            ("project", [Alias(lit, "lit")])], schema, 0)
