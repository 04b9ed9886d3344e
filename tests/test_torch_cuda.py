"""The port's kernels on the card against their plain PyTorch versions:
K5 (the compacting stage, with string = and Or), K6 (the computing
projection, with IN, substring views, <, <=, >= and dates), K7 (gather,
with -1 rows), K8 (sort, with string keys), K9 (keyed aggregation, with a
double sum of an int input, double keys and five keys), K10 (hash join,
inner and left outer), K14 (whole-partition windows), and TPC-DS q3, q1,
q7, q15, q12 and q20 end to end against the CPU run.

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


def test_gather_null_rows(card):
    rng = np.random.default_rng(10)
    b = batch(card, rng, 3000)
    idx = rng.integers(-1, 3000, 5000)
    idx = torch.from_numpy(idx.astype(np.int64)).cuda()
    same(BO.gather_columns(b.columns, idx, card.transfers, nullable=True),
         BO.gather_columns_plain(b.columns, idx, card.transfers,
                                 nullable=True))


def test_left_outer_join(card):
    rng = np.random.default_rng(12)

    def key(n, hi):
        return DeviceColumn(torch.from_numpy(rng.integers(0, hi, n)).cuda(),
                            torch.from_numpy(rng.random(n) > 0.2).cuda(),
                            T.LONG)
    for nb, npr in ((3000, 100_000), (0, 500), (50, 0)):
        b, p = key(nb, 700), key(npr, 900)
        for g, r in zip(J.join_pairs(b, p, card.transfers, outer=True),
                        J.join_pairs_plain(b, p, card.transfers, True)):
            assert torch.equal(g, r)


def test_project(card):
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (Alias, col,
                                                         bind_references,
                                                         lit)
    rng = np.random.default_rng(6)
    hb = batch_from_pydict(data(rng, 20_000), SCHEMA)
    exprs = [A.Divide(col("v"), col("a")),
             P.Or(P.EqualTo(col("s"), lit("xy")),
                  P.GreaterThan(col("v"), lit(0.0))),
             P.And(P.EqualTo(col("s"), lit("日本")),
                   P.GreaterThan(col("a"), lit(2)))]
    bound = [bind_references(Alias(e, f"c{j}"), SCHEMA)
             for j, e in enumerate(exprs)]
    program = FU.StageProgram([("project", bound)], SCHEMA, 0)
    b = card.transfers.upload_batch(hb)
    lits = FU.LiteralArgs([])
    same(FU.fused_project(program, b, lits),
         FU.fused_project_plain(program, b, lits))


def test_sort_string_keys(card):
    rng = np.random.default_rng(8)
    b = batch(card, rng, 20_000)
    for orders in ([S.SortOrder(2, True, True)],
                   [S.SortOrder(2, False, False), S.SortOrder(0)]):
        assert torch.equal(
            S.sort_permutation(b.columns, orders, card.transfers),
            S.sort_permutation_plain(b.columns, orders, card.transfers))


@pytest.mark.parametrize("query", ["q1", "q7"])
def test_q1_q7_match_the_cpu_run(card, query):
    from spark_rapids_tpu_torch.testing import tpcds
    tables = tpcds.generate_tables(1)
    recipe, cut, names = {
        "q1": (tpcds.q1, tpcds.q1_tables,
               ("date_dim", "store_returns", "store", "customer")),
        "q7": (tpcds.q7, tpcds.q7_tables,
               ("store_sales", "customer_demographics", "date_dim", "item",
                "promotion"))}[query]
    t = cut(tables)
    got = recipe(*[card.create_dataframe(t[n]) for n in names])[0].collect()
    cpu = TorchSession(device="cpu")
    ref = recipe(*[cpu.create_dataframe(t[n]) for n in names])[0].collect()
    assert len(got) == len(ref) == 100
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-12 * abs(r[k])
            else:
                assert g[k] == r[k]


def test_project_new_emitters(card):
    """IN (strings, numbers, a null and a NaN option), substring views,
    the order comparisons with NaN, and dates."""
    import datetime
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (Alias, col,
                                                         bind_references,
                                                         lit)
    rng = np.random.default_rng(16)
    d = data(rng, 20_000)
    d0 = datetime.date(1999, 2, 22)
    d["d"] = [None if rng.random() < 0.1 else
              d0 + datetime.timedelta(days=int(x))
              for x in rng.integers(-5, 40, 20_000)]
    schema = T.StructType(list(SCHEMA.fields) + [T.StructField("d", T.DATE)])
    exprs = [P.In(col("s"), ["xy", "日本", None]),
             P.In(F.substring("s", 1, 2), ["xy", "br", ""]),
             P.EqualTo(F.substring("s", -2, 5), lit("10")),
             P.EqualTo(F.substring("s", 0, 0), lit("")),
             P.In(col("v"), [0.5, float("nan")]),
             P.LessThan(col("v"), lit(float("nan"))),
             P.GreaterThanOrEqual(col("v"), col("v")),
             P.LessThanOrEqual(col("a"), col("b")),
             P.And(P.GreaterThanOrEqual(col("d"), lit(d0)),
                   P.LessThanOrEqual(col("d"),
                                     lit(datetime.date(1999, 3, 24))))]
    bound = [bind_references(Alias(e, f"c{j}"), schema)
             for j, e in enumerate(exprs)]
    program = FU.StageProgram([("project", bound)], schema, 0)
    b = card.transfers.upload_batch(batch_from_pydict(d, schema))
    lits = FU.LiteralArgs([])
    same(FU.fused_project(program, b, lits),
         FU.fused_project_plain(program, b, lits))


def test_window_reduce(card):
    """K14 against its plain version: int, string and double keys, one
    partition of 2**20 + 3 rows, every row its own partition, and sums
    that wrap."""
    from spark_rapids_tpu_torch.ops import window_ops as W
    rng = np.random.default_rng(17)
    a, bb, s, v = batch(card, rng, 70_000).columns
    kinds = [W.WIN_SUM_F64, W.WIN_SUM_I64, W.WIN_COUNT, W.WIN_COUNT_ALL,
             W.WIN_MEAN]
    for keys in ([a], [s, a], [v], []):
        perm = S.sort_permutation(keys, [S.SortOrder(i) for i in
                                         range(len(keys))],
                                  card.transfers) if keys else \
            torch.arange(70_000, device="cuda")
        cols = BO.gather_columns(keys + [v, bb], perm, card.transfers, True)
        k, (sv, sb) = cols[:len(keys)], cols[len(keys):]
        values = [sv, sb, sv, None, sv]
        got = W.window_reduce(k, values, kinds, 70_000, sv.device)
        ref = W.window_reduce_plain(k, values, kinds, 70_000, sv.device)
        for kind, g, r in zip(kinds, got, ref):
            assert torch.equal(g.validity, r.validity)
            if kind in (W.WIN_SUM_F64, W.WIN_MEAN):
                assert torch.allclose(g.data, r.data, rtol=1e-9,
                                      atol=1e-9, equal_nan=True)
            else:
                assert torch.equal(g.data, r.data)
    n = (1 << 20) + 3
    big = DeviceColumn(torch.from_numpy(rng.integers(
        1 << 62, (1 << 63) - 1, n)).cuda(),
        torch.ones(n, dtype=torch.bool, device="cuda"), T.LONG, True)
    for key in (torch.zeros(n, dtype=torch.int64),
                torch.arange(n, dtype=torch.int64)):
        kc = DeviceColumn(key.cuda(), torch.ones(n, dtype=torch.bool,
                                                 device="cuda"), T.LONG,
                          True)
        got = W.window_reduce([kc], [big], [W.WIN_SUM_I64], n, big.device)
        ref = W.window_reduce_plain([kc], [big], [W.WIN_SUM_I64], n,
                                    big.device)
        assert torch.equal(got[0].data, ref[0].data)


@pytest.mark.parametrize("query", ["q15", "q12", "q20"])
def test_q15_q12_q20_match_the_cpu_run(card, query):
    from spark_rapids_tpu_torch.testing import tpcds
    tables = tpcds.generate_tables(1)
    recipe, cut, names = {
        "q15": (tpcds.q15, tpcds.q15_tables,
                ("catalog_sales", "customer", "customer_address",
                 "date_dim")),
        "q12": (tpcds.q12, tpcds.q12_tables,
                ("web_sales", "item", "date_dim")),
        "q20": (lambda *f: tpcds.q12(*f, prefix="cs"), tpcds.q20_tables,
                ("catalog_sales", "item", "date_dim"))}[query]
    t = cut(tables)
    got = recipe(*[card.create_dataframe(t[n]) for n in names])[0].collect()
    cpu = TorchSession(device="cpu")
    ref = recipe(*[cpu.create_dataframe(t[n]) for n in names])[0].collect()
    assert len(got) == len(ref) == {"q15": 30, "q12": 44, "q20": 100}[query]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-12 * abs(r[k])
            else:
                assert g[k] == r[k]
