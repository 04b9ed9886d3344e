"""The port's kernels on the card against their plain PyTorch versions:
K5 (the compacting stage), K7 (gather), K8 (sort), K9 (keyed
aggregation), K10 (hash join), and TPC-DS q3 end to end against the CPU
run.

Every test needs a CUDA card and skips without one.  This file imports
nothing of JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX for the other tests).
Exact, except double sums within 1e-12 relative (another order)."""

import numpy as np
import pytest
import torch

from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.ops import agg_ops as G
from spark_rapids_tpu_torch.ops import batch_ops as BO
from spark_rapids_tpu_torch.ops import join_ops as J
from spark_rapids_tpu_torch.ops import sort_ops as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return TorchSession(device="cuda")


def data(rng, n, card_=7):
    words = ["", "x", "xy", "brand1", "brand10", "日本", "é"]
    return {
        "a": [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(0, card_, n)],
        "b": rng.integers(0, card_, n).astype(np.int64),
        "s": [None if rng.random() < 0.1 else str(rng.choice(words))
              for _ in range(n)],
        "v": [None if rng.random() < 0.1 else float(x)
              for x in rng.standard_normal(n)],
    }


SCHEMA = T.StructType([T.StructField("a", T.INT), T.StructField("b", T.LONG),
                       T.StructField("s", T.STRING),
                       T.StructField("v", T.DOUBLE)])


def batch(session, rng, n):
    return session.transfers.upload_batch(
        batch_from_pydict(data(rng, n), SCHEMA))


def same(got, ref):
    for g, r in zip(got, ref):
        assert torch.equal(g.validity, r.validity)
        if g.is_string:
            assert torch.equal(g.offsets.long(), r.offsets.long())
            end = int(r.offsets[-1])
            assert torch.equal(g.data[:end], r.data[:end])
        else:
            assert torch.equal(g.data.view(torch.int8),
                               r.data.view(torch.int8))


@pytest.mark.parametrize("unique", [False, True])
def test_gather(card, unique):
    rng = np.random.default_rng(9)
    b = batch(card, rng, 5000)
    idx = rng.permutation(5000) if unique else rng.integers(0, 5000, 7000)
    idx = torch.from_numpy(idx.astype(np.int64)).cuda()
    same(BO.gather_columns(b.columns, idx, card.transfers, unique),
         BO.gather_columns_plain(b.columns, idx, card.transfers, unique))


def test_stage(card):
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo
    rng = np.random.default_rng(4)
    hb = batch_from_pydict(data(rng, 20_000), SCHEMA)
    df = card.create_dataframe(hb).filter(EqualTo(col("a"), lit(3))) \
        .select(Alias(A.Add(col("b"), lit(1)), "b1"), col("s"))
    stage = df.executed_plan()
    b = card.transfers.upload_batch(hb)
    lits = FU.LiteralArgs.upload(stage.promoted, card.transfers)
    idx, comp = FU.fused_stage_compact(stage.program, b, lits,
                                       card.transfers)
    ridx, rcomp = FU.fused_stage_compact_plain(stage.program, b, lits,
                                               card.transfers)
    assert torch.equal(idx, ridx)
    same(comp, rcomp)


def test_join(card):
    rng = np.random.default_rng(2)

    def key(n, hi):
        return DeviceColumn(torch.from_numpy(rng.integers(0, hi, n)).cuda(),
                            torch.from_numpy(rng.random(n) > 0.1).cuda(),
                            T.LONG)
    b, p = key(3000, 700), key(100_000, 900)
    for g, r in zip(J.join_pairs(b, p, card.transfers),
                    J.join_pairs_plain(b, p, card.transfers)):
        assert torch.equal(g, r)


def test_sort(card):
    rng = np.random.default_rng(5)
    b = batch(card, rng, 20_000)
    orders = [S.SortOrder(3, False, False), S.SortOrder(0), S.SortOrder(1)]
    assert torch.equal(S.sort_permutation(b.columns, orders),
                       S.sort_permutation_plain(b.columns, orders))


def test_keyed_aggregate(card):
    rng = np.random.default_rng(3)
    a, bb, s, v = batch(card, rng, 50_000).columns
    kinds = [G.KEYED_SUM_F64, G.KEYED_SUM_I64, G.KEYED_COUNT,
             G.KEYED_COUNT_ALL]
    inputs = [v, bb, v, None]
    got = G.keyed_aggregate([a, bb, s], inputs, kinds, card.transfers)
    ref = G.keyed_aggregate_plain([a, bb, s], inputs, kinds,
                                  card.transfers)
    assert torch.equal(got[0], ref[0])
    for kind, (gd, gv), (rd, rv) in zip(kinds, got[1], ref[1]):
        assert torch.equal(gv, rv)
        if kind == G.KEYED_SUM_F64:
            assert torch.allclose(gd, rd, rtol=1e-12, atol=1e-9)
        else:
            assert torch.equal(gd, rd)


def test_q3_matches_the_cpu_run(card):
    from spark_rapids_tpu_torch.testing import tpcds
    tables = tpcds.q3_tables(tpcds.generate_tables(5))
    names = ("date_dim", "store_sales", "item")
    got = tpcds.q3(*[card.create_dataframe(tables[t])
                     for t in names])[0].collect()
    cpu = TorchSession(device="cpu")
    ref = tpcds.q3(*[cpu.create_dataframe(tables[t])
                     for t in names])[0].collect()
    assert len(got) == len(ref) >= 10
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        assert (g["d_year"], g["brand_id"], g["brand"]) == \
            (r["d_year"], r["brand_id"], r["brand"])
        assert abs(g["sum_agg"] - r["sum_agg"]) <= 1e-12 * abs(r["sum_agg"])
