"""Decimal inputs and references shared by the CPU tests and
``chip_smoke.py`` (phases 2n and 3d).

- ``recipe_decimal``: the slice-1 recipe's decimal form over ``k int64,
  w int32, d DECIMAL(7,2)``: ``filter(w > t).select(k + 1, d * 2, d - w,
  d * w, (d * w) * d, murmur3(k, w))``, then the sum of each.  The
  projected types are decimal(18,2), decimal(13,2), decimal(18,2) and
  decimal(26,4), their sums decimal(28,2), (23,2), (28,2) and (36,4):
  K12 inside K1 (a rescaled add, a decimal64 multiply, a 64 x 64 -> 128
  multiply) and 128-bit sums in K1 and K3.
- ``recipe_decimal_exact``: its decimal sums as Python ints of the
  unscaled values, from numpy planes (int64 arithmetic, then Python ints
  for the 128-bit products and sums).
- ``cents``: money drawn as the TPC-DS generator draws it (``_money``),
  as exact int64 cents.
- ``decimal_operands``: seeded unscaled operands of a decimal type, with
  nulls, zeros, the bounds and values near them;
- ``decimal_batch``: a host batch of such columns (``TYPES``) beside int,
  long and group-key columns, and ``k12_expressions`` /
  ``k12_predicates``, every decimal operation the JAX gate admits over
  them (decimal64 and decimal128 operands, int and long partners, casts,
  comparisons across scales, If)."""

from __future__ import annotations

from typing import Dict

import numpy as np

from spark_rapids_tpu_torch import types as T

MONEY = T.DecimalType(7, 2)


def cents(rng, n: int, lo: float = 0.5, hi: float = 300.0) -> np.ndarray:
    """``_money``'s values (``np.round(uniform(lo, hi), 2)``) as int64
    cents: exact, since each is a multiple of 0.01 below 2^53 / 100."""
    return np.rint(np.round(rng.uniform(lo, hi, n), 2) * 100).astype(
        np.int64)


def recipe_decimal(df, threshold: int = 0):
    """The recipe's decimal form (module docstring)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import hashing as H
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    return (df
            .filter(P.GreaterThan(col("w"), lit(threshold)))
            .select(Alias(A.Add(col("k"), lit(1)), "k1"),
                    Alias(A.Multiply(col("d"), lit(2)), "d2"),
                    Alias(A.Subtract(col("d"), col("w")), "dw"),
                    Alias(A.Multiply(col("d"), col("w")), "dm"),
                    Alias(A.Multiply(A.Multiply(col("d"), col("w")),
                                     col("d")), "dd"),
                    Alias(H.Murmur3Hash(col("k"), col("w")), "h"))
            .agg(F.sum("k1").alias("sk"), F.sum("d2").alias("s2"),
                 F.sum("dw").alias("sw"), F.sum("dm").alias("sm"),
                 F.sum("dd").alias("sd"), F.sum("h").alias("sh")))


#: the recipe's sum types, by output name
RECIPE_SUM_TYPES = {"s2": T.DecimalType(28, 2), "sw": T.DecimalType(23, 2),
                    "sm": T.DecimalType(28, 2), "sd": T.DecimalType(36, 4)}


def exact_sum(x: np.ndarray) -> int:
    """The sum of int64 values below 2^56 in magnitude as a Python int:
    int64 sums of 64 rows (below 2^62), then those as Python ints."""
    pad = -len(x) % 64
    rows = np.concatenate([x, np.zeros(pad, dtype=np.int64)]).reshape(-1, 64)
    return int(rows.sum(axis=1).astype(object).sum())


def recipe_decimal_exact(k: np.ndarray, w: np.ndarray, d: np.ndarray,
                         threshold: int = 0) -> Dict[str, int]:
    """The decimal sums of ``recipe_decimal`` (``RECIPE_SUM_TYPES``) as
    unscaled Python ints, from the planes (no null; ``d`` in cents below
    10^7, ``w`` an int32).  ``sk`` and ``sh`` are the slice-1 recipe's."""
    sel = w > threshold
    ww, dd = w[sel].astype(np.int64), d[sel]
    dm = dd * ww                                  # below 2^55
    return {"s2": exact_sum(dd * 2),
            "sw": exact_sum(dd - ww * 100),       # at scale 2
            "sm": exact_sum(dm),
            # (d * w) * d needs 128 bits: dm's 32-bit limbs times d
            "sd": exact_sum((dm & 0xFFFFFFFF) * dd) +
            (exact_sum((dm >> 32) * dd) << 32)}


def decimal_operands(rng, dt: T.DecimalType, n: int) -> tuple:
    """``(unscaled Python ints, validity)`` of ``n`` values of ``dt``:
    uniform over its range, with zeros, +-1, its bounds and values near
    them mixed in, about a tenth null."""
    top = 10 ** dt.precision - 1
    vals = [int(x) for x in rng.integers(-(2 ** 62), 2 ** 62, n)]
    vals = [v % (2 * top + 1) - top for v in vals]
    if dt.precision > 18:
        vals = [v * (10 ** (dt.precision - 18)) +
                int(rng.integers(0, 10 ** (dt.precision - 18)))
                if abs(v) < top // 10 ** (dt.precision - 18) else v
                for v in vals]
    special = [0, 1, -1, top, -top, top - 1, -(top - 1), top // 2,
               -(top // 2), 5, -5, 50, -50]
    for i, v in enumerate(special[:n]):
        vals[(i * 7919) % n] = v
    valid = rng.random(n) > 0.1
    return vals, valid


#: the decimal columns of ``decimal_batch``
TYPES = {"a": T.DecimalType(7, 2), "b": T.DecimalType(18, 4),
         "c": T.DecimalType(20, 4), "e": T.DecimalType(30, 6)}


def decimal_batch(n: int, seed: int = 5):
    """A host batch of ``n`` rows: the ``TYPES`` columns (with nulls and
    their bounds), ``w`` int32, ``k`` long and ``g``, a long group key
    of 37 values."""
    from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                       decimal_column,
                                                       host_column)
    rng = np.random.default_rng(seed)
    cols, names = [], []
    for name, dt in TYPES.items():
        vals, valid = decimal_operands(rng, dt, n)
        cols.append(decimal_column(np.array(vals, dtype=object), dt, valid))
        names.append(name)
    cols.append(host_column(rng.integers(-1000, 1000, n).astype(np.int32)))
    cols.append(host_column(rng.integers(-10 ** 12, 10 ** 12, n)))
    cols.append(host_column(rng.integers(0, 37, n)))
    names += ["w", "k", "g"]
    return HostColumnarBatch(cols, n, names)


def k12_expressions():
    """Every decimal operation the JAX gate admits, over
    ``decimal_batch``'s columns."""
    import decimal
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import col, lit
    from spark_rapids_tpu_torch.expressions.cast import Cast
    from spark_rapids_tpu_torch.expressions.conditional import If
    D = T.DecimalType
    a, b, c, e, w, k = (col(x) for x in "abcewk")
    return [A.Add(a, b), A.Subtract(a, w), A.Add(c, e), A.Subtract(e, k),
            A.Add(a, k), A.Multiply(a, b), A.Multiply(a, w),
            A.Multiply(b, b), A.Multiply(a, lit(2)),
            A.Divide(a, a), A.Divide(a, w), A.Remainder(b, a),
            A.Remainder(a, w), Cast(a, D(9, 4)), Cast(b, D(10, 1)),
            Cast(a, T.DOUBLE), Cast(w, D(12, 2)), Cast(k, D(30, 4)),
            Cast(c, D(38, 10)), Cast(e, D(25, 2)),
            If(P.GreaterThan(a, lit(decimal.Decimal("10.5"))), a, b)]


def k12_predicates():
    """Comparisons across scales over ``decimal_batch``'s columns."""
    import decimal
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import col, lit
    a, b, c, e, w = (col(x) for x in "abcew")
    return [P.GreaterThan(a, b), P.LessThanOrEqual(a, w),
            P.EqualTo(c, e), P.GreaterThanOrEqual(e, a),
            P.NotEqual(b, c), P.LessThan(a, lit(decimal.Decimal("3.25"))),
            P.GreaterThan(a, lit(1.5))]
