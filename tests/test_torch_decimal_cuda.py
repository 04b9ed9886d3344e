"""The port's decimal kernels on the card against their plain PyTorch
versions (the CPU session's): K12 inside K6, K5 and K1 (every decimal
operation the JAX package's gate admits, decimal64 and decimal128
operands, int and long partners, casts, comparisons across scales, If),
K9's and K3's decimal sum kinds (decimal64 and decimal128, with the
PARTIAL/FINAL merge), the decimal avg finish (``csrc/decimal.cu``), K8's
decimal sort words and K7, K7c and K7s moving decimal128 rows; the
recipe's decimal form against exact integers.

Every test needs a CUDA card and skips without one; this file imports
nothing of JAX:

    python -m pytest tests/test_torch_decimal_cuda.py --noconftest -q

Exact: decimals compare as ``Decimal`` values with their scale."""

import decimal

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                   decimal_column,
                                                   host_column)
from spark_rapids_tpu_torch.columnar.column import decimal_value
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.base import Alias, col
from spark_rapids_tpu_torch.ops import agg_ops as G
from spark_rapids_tpu_torch.ops import decimal_ops as DO
from spark_rapids_tpu_torch.ops import sort_ops as S
from spark_rapids_tpu_torch.testing import decimal_cases as DC

pytestmark = pytest.mark.cuda

D = T.DecimalType


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return TorchSession(device="cuda")


def batch(n: int) -> HostColumnarBatch:
    return DC.decimal_batch(n)


def same(card_session, build, hb, parts: int = 1):
    """``build(df)`` on the card and on the CPU: equal rows, with the
    same decimal scales."""
    got = build(card_session.create_dataframe(hb, num_partitions=parts))
    ref = build(TorchSession(device="cpu").create_dataframe(
        hb, num_partitions=parts))
    assert got.schema.types == ref.schema.types
    a, b = got.collect(), ref.collect()
    assert a == b
    for x, y in zip(a, b):
        for k in x:
            if isinstance(x[k], decimal.Decimal):
                assert x[k].as_tuple().exponent == y[k].as_tuple().exponent
    return a


@pytest.mark.parametrize("n", [1, 1000, (1 << 17) + 3])
def test_k12_in_k6(card, n):
    hb = batch(n)
    exprs = DC.k12_expressions() + DC.k12_predicates()
    FU.PROJECT_LAUNCHES = 0
    same(card, lambda df: df.select(*[Alias(x, f"o{j}")
                                      for j, x in enumerate(exprs)]), hb)
    assert FU.PROJECT_LAUNCHES == 1


@pytest.mark.parametrize("n", [1000, (1 << 17) + 3])
def test_k12_in_k5(card, n):
    hb = batch(n)
    FU.STAGE_LAUNCHES = 0
    same(card, lambda df: df.filter(P.GreaterThan(col("a"), col("w")))
         .select(*[Alias(x, f"o{j}") for j, x in enumerate(DC.k12_expressions())]), hb)
    assert FU.STAGE_LAUNCHES == 1


def test_recipe_decimal_in_k1_and_k3(card):
    rng = np.random.default_rng(7)
    n = (1 << 20) + 3
    k = rng.integers(0, 1 << 20, n).astype(np.int64)
    w = rng.integers(-1000, 1000, n).astype(np.int32)
    d = DC.cents(rng, n, -300.0, 300.0)
    hb = HostColumnarBatch([host_column(k), host_column(w),
                            decimal_column(d, DC.MONEY)], n, ["k", "w", "d"])
    FU.LAUNCHES, G.LAUNCHES = 0, 0
    got = same(card, DC.recipe_decimal, hb, parts=4)[0]
    assert FU.LAUNCHES == 4 and G.LAUNCHES == 5
    exact = DC.recipe_decimal_exact(k, w, d)
    for name, dt in DC.RECIPE_SUM_TYPES.items():
        assert got[name] == decimal_value(exact[name], dt.scale)


@pytest.mark.parametrize("parts", [1, 3])
def test_k9_decimal_sums_and_avg(card, parts):
    hb = batch(50_000)
    G.KEYED_LAUNCHES, DO.AVG_LAUNCHES = 0, 0
    same(card, lambda df: df.group_by("g").agg(
        F.sum("a").alias("sa"), F.sum("b").alias("sb"),
        F.sum("c").alias("sc"), F.sum("e").alias("se"),
        F.avg("a").alias("va"), F.avg("b").alias("vb"),
        F.count("a").alias("n")).order_by("g"), hb, parts)
    assert G.KEYED_LAUNCHES >= (1 if parts == 1 else 2)
    assert DO.AVG_LAUNCHES >= 1


def test_global_decimal_sums_and_avg(card):
    hb = batch(70_001)
    same(card, lambda df: df.agg(F.sum("a"), F.sum("c"), F.sum("e"),
                                 F.avg("a"), F.avg("b")), hb, parts=3)


@pytest.mark.parametrize("key", ["a", "b", "c", "e"])
def test_k8_decimal_keys(card, key):
    hb = batch(20_000)
    S.LAUNCHES = 0
    same(card, lambda df: df.order_by(F.desc(key), "k"), hb)
    same(card, lambda df: df.order_by(key, "k"), hb)
    assert S.LAUNCHES == 2


def test_k7_k7c_k7s_move_decimal128_rows(card):
    hb = batch(30_000)
    dims = {"g": np.arange(37, dtype=np.int64),
            "x": np.arange(37, dtype=np.int64) * 3}

    def build(df):
        s = df._session
        right = s.create_dataframe(dims, num_partitions=2)
        return df.join(right, on="g").select("g", "k", "c", "e", "x") \
            .order_by("g", "k")
    same(card, build, hb, parts=3)


def test_avg_finish_matches_plain(card):
    rng = np.random.default_rng(3)
    n = (1 << 16) + 5
    for dt in (D(7, 2), D(18, 3), D(20, 4)):
        total = D(min(38, dt.precision + 10), dt.scale)
        vals, valid = DC.decimal_operands(rng, total, n)
        col_ = decimal_column(np.array(vals, dtype=object), total, valid)
        sdata = torch.from_numpy(col_.data)
        svalid = torch.from_numpy(valid)
        cnt = torch.from_numpy(rng.integers(0, 1 << 40, n))
        cnt[::17] = 0
        cvalid = torch.ones(n, dtype=torch.bool)
        ref = DO.avg_finish_plain(sdata, svalid, cnt, cvalid, dt)
        got = DO.avg_finish(sdata.cuda(), svalid.cuda(), cnt.cuda(),
                            cvalid.cuda(), dt)
        assert torch.equal(got[1].cpu(), ref[1])
        assert torch.equal(got[0].cpu(), ref[0])
