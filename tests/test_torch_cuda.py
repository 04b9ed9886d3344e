"""The port's kernels on the card against their plain PyTorch versions:
K5 (the compacting stage, with string = and Or), K6 (the computing
projection, with IN, substring views, <, <=, >= and dates), K7 (gather,
with -1 rows), K8 (sort, with string keys), K9 (keyed aggregation, with a
double sum of an int input, double keys and five keys), K10 (hash join,
inner, left outer, left semi and left anti), K14 (whole-partition
windows), K15d (count distinct, keyed and global), the <>, NOT and
string-to-string emitters in K5 and K6, kernel 1 over string columns, K7c
(concat, with strings), K9's m2 kind, K10 on two and three key columns,
and TPC-DS q3, q1, q7, q15, q12, q20, q13, q19, q16, q17, q10 and q18 end
to end against the CPU run.

Every test needs a CUDA card and skips without one.  This file imports
nothing of JAX, so it runs where JAX is not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q

(``--noconftest``: tests/conftest.py sets up JAX for the other tests).
Exact, except double sums (and m2) within 1e-12 relative (another
order)."""

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


def test_semi_anti_join(card):
    """K10's semi and anti modes: duplicate and null keys on both sides,
    an empty build side."""
    rng = np.random.default_rng(21)

    def key(n, hi):
        return DeviceColumn(torch.from_numpy(rng.integers(0, hi, n)).cuda(),
                            torch.from_numpy(rng.random(n) > 0.1).cuda(),
                            T.LONG)
    p = key(100_000, 900)
    for b in (key(3000, 700), key(0, 1)):
        for mode in ("semi", "anti"):
            got = J.join_pairs(b, p, card.transfers, mode=mode)
            ref = J.join_pairs_plain(b, p, card.transfers, mode=mode)
            assert got[1] is None and torch.equal(got[0], ref[0])


@pytest.mark.parametrize("n", [0, 1, 1000, (1 << 20) + 3])
def test_count_distinct(card, n):
    """K15d against its plain version, keyed (K9's groups) and global, over
    int, long, double (nulls, NaN, -0.0) and string values."""
    rng = np.random.default_rng(22)
    b = batch(card, rng, n)
    a, bb, s, v = b.columns
    if n:
        v.data[: n // 3] = torch.where(v.data[: n // 3] > 0, float("nan"),
                                       -0.0)
    _rep, _res, gid = G.keyed_aggregate([a], [], [], card.transfers,
                                        row_groups=True)
    groups = int(_rep.shape[0])
    for c in (a, bb, v, s):
        assert torch.equal(G.count_distinct(c), G.count_distinct_plain(c))
        if groups:
            assert torch.equal(G.count_distinct(c, gid, groups),
                               G.count_distinct_plain(c, gid, groups))


def test_stage_new_emitters(card):
    """<>, NOT and string = / <> between two columns or substrings of two
    columns, in K5 and K6."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (Alias, col,
                                                         bind_references,
                                                         lit)
    rng = np.random.default_rng(23)
    d = data(rng, 20_000)
    d["t"] = [None if rng.random() < 0.1 else str(rng.choice(
        ["", "x", "xy", "brand1", "brand10", "日本"])) for _ in range(20_000)]
    schema = T.StructType(list(SCHEMA.fields) +
                          [T.StructField("t", T.STRING)])
    exprs = [P.NotEqual(col("s"), col("t")),
             P.EqualTo(col("s"), col("t")),
             P.NotEqual(F.substring("s", 1, 5), F.substring("t", 1, 5)),
             P.NotEqual(col("s"), lit("xy")),
             P.NotEqual(col("v"), lit(0.5)),
             P.NotEqual(col("a"), col("b")),
             P.Not(P.EqualTo(col("s"), col("t"))),
             P.Not(P.LessThan(col("v"), lit(0.0)))]
    b = card.transfers.upload_batch(batch_from_pydict(d, schema))
    lits = FU.LiteralArgs([])
    bound = [bind_references(Alias(e, f"c{j}"), schema)
             for j, e in enumerate(exprs)]
    program = FU.StageProgram([("project", bound)], schema, 0)
    same(FU.fused_project(program, b, lits),
         FU.fused_project_plain(program, b, lits))
    for e in exprs:
        stage = FU.StageProgram([("filter", bind_references(e, schema)),
                                 ("project", [bind_references(
                                     col("b"), schema)])], schema, 0)
        idx, _c = FU.fused_stage_compact(stage, b, lits, card.transfers)
        ridx, _r = FU.fused_stage_compact_plain(stage, b, lits,
                                                card.transfers)
        assert torch.equal(idx, ridx)


def test_kernel1_string_inputs(card):
    """Kernel 1 over a chain that reads string columns (= literal, IN, a
    column-to-column compare) and averages, with nulls."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import col, lit
    rng = np.random.default_rng(24)
    hb = batch_from_pydict(data(rng, 300_000), SCHEMA)
    cond = P.Or(P.And(P.EqualTo(col("s"), lit("brand1")),
                      P.GreaterThanOrEqual(col("v"), lit(-0.5))),
                P.And(P.In(col("s"), ["xy", "日本"]),
                      P.NotEqual(col("a"), lit(3))))
    df = card.create_dataframe(hb).filter(cond).agg(
        F.avg("a").alias("x"), F.avg("v").alias("y"), F.sum("b").alias("z"))
    fx = df.executed_plan()
    assert isinstance(fx, FU.TorchFusedAggExec)
    b = card.transfers.upload_batch(hb)
    lits = FU.LiteralArgs.upload(fx.promoted, card.transfers)
    got = G.global_reduce_plain(*FU.fused_agg_update(fx.program, b, lits),
                                fx.program.fold_kinds)
    ref = G.global_reduce_plain(*FU.fused_agg_update_plain(fx.program, b,
                                                           lits),
                                fx.program.fold_kinds)
    assert torch.equal(got[1], ref[1])
    for j, k in enumerate(fx.program.fold_kinds):
        if k == G.SUM_F64:
            x, y = (w[j].view(torch.float64).item() for w in (got[0],
                                                              ref[0]))
            assert abs(x - y) <= 1e-9 * max(1.0, abs(y))
        else:
            assert got[0][j].item() == ref[0][j].item()


@pytest.mark.parametrize("query", ["q13", "q19", "q16"])
def test_q13_q19_q16_match_the_cpu_run(card, query):
    from spark_rapids_tpu_torch.testing import tpcds
    tables = tpcds.generate_tables(1)
    names = {"q13": ("store_sales", "store", "customer_demographics",
                     "household_demographics", "customer_address",
                     "date_dim"),
             "q19": ("date_dim", "store_sales", "item", "customer",
                     "customer_address", "store"),
             "q16": ("catalog_sales", "date_dim", "customer_address",
                     "call_center", "catalog_returns")}[query]
    t = getattr(tpcds, f"{query}_tables")(tables)
    kw = {"prices": ((1.0, 300.0),) * 3,
          "profits": ((-5000.0, 15000.0),) * 3} if query == "q13" else {}
    recipe = getattr(tpcds, query)
    got = recipe(*[card.create_dataframe(t[n]) for n in names],
                 **kw)[0].collect()
    cpu = TorchSession(device="cpu")
    ref = recipe(*[cpu.create_dataframe(t[n]) for n in names],
                 **kw)[0].collect()
    assert len(got) == len(ref) == {"q13": 1, "q19": 4, "q16": 1}[query]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-12 * abs(r[k])
            else:
                assert g[k] == r[k]


@pytest.mark.parametrize("sizes", [(0, 1), (1000, 0, 1), (4099, 70000, 3)])
def test_concat(card, sizes):
    """K7c against its plain version: strings (empty, null, non-ASCII),
    ints, longs and doubles, inputs of no row, a front slice whose chars
    plane runs past its last offset."""
    rng = np.random.default_rng(sum(sizes))
    parts = [batch(card, rng, n) for n in sizes]
    parts[-1] = parts[-1].front(max(0, sizes[-1] - 1))
    got = BO.concat_batches(parts)
    ref = BO.concat_batches_plain(parts)
    assert got.row_count == ref.row_count == sum(p.row_count for p in parts)
    same(got.columns, ref.columns)
    assert got.columns[2].offsets[-1] == ref.columns[2].offsets[-1]


def test_keyed_m2(card):
    """K9's m2 kind against its plain version: groups of 0, 1 and 2
    present values and one of 2**20 + 3 values near 1e9; int and double
    inputs."""
    n = (1 << 20) + 3
    rng = np.random.default_rng(31)
    g = np.concatenate([[0, 0, 1, 2, 2], np.full(n, 3),
                        rng.integers(4, 400, 5000)]).astype(np.int64)
    m = len(g)
    x = rng.standard_normal(m) * 100.0
    x[5:5 + n] = 1e9 + rng.standard_normal(n)
    valid = rng.random(m) > 0.05
    valid[:2] = False
    key = DeviceColumn(torch.from_numpy(g).cuda(),
                       torch.ones(m, dtype=torch.bool).cuda(), T.LONG)
    dbl = DeviceColumn(torch.from_numpy(x).cuda(),
                       torch.from_numpy(valid).cuda(), T.DOUBLE)
    ints = DeviceColumn(torch.from_numpy(rng.integers(-99, 99, m).astype(
        np.int32)).cuda(), torch.from_numpy(valid).cuda(), T.INT)
    args = ([key], [dbl, ints, dbl], [G.KEYED_M2, G.KEYED_M2, G.KEYED_COUNT],
            card.transfers)
    got = G.keyed_aggregate(*args)
    ref = G.keyed_aggregate_plain(*args)
    assert torch.equal(got[0], ref[0])
    gid = torch.from_numpy(g).cuda()
    for c, (gv, gok), (rv, rok) in zip(args[1], got[1], ref[1]):
        assert torch.equal(gok, rok)
        if gv.dtype == torch.int64:   # the count
            assert torch.equal(gv, rv)
            continue
        # the plain version sums with atomics in another order, so the
        # two means differ in their last places (bounded by 1e-12 of the
        # group's largest |x|), which moves m2 by about n times that
        # squared; 1e-9 of m2 covers the squares' sums
        xv = c.data.double()
        big = torch.zeros_like(gv).scatter_reduce_(
            0, gid, torch.where(c.validity, xv.abs(), 0.0), "amax")
        n_g = torch.zeros_like(gv).index_add_(0, gid, c.validity.double())
        tol = 1e-9 * rv.abs() + n_g * (1e-12 * big) ** 2
        assert bool(((gv - rv).abs() <= tol).all())
    near = torch.from_numpy(x[5:5 + n][valid[5:5 + n]]).cuda()
    exact = float(((near - near.mean()) ** 2).sum())
    assert abs(float(got[1][0][0][3]) - exact) <= 1e-6 * exact


@pytest.mark.parametrize("n_keys", [2, 3])
def test_multikey_join(card, n_keys):
    """K10 on two and three key columns of int and long in all four modes
    against its plain version: duplicates, nulls in one key column, an
    empty build side."""
    rng = np.random.default_rng(n_keys)

    def keys(n, null_col):
        out = []
        for c in range(n_keys):
            dt = T.INT if c == 1 else T.LONG
            data = torch.from_numpy(rng.integers(0, 6, n).astype(
                dt.np_dtype)).cuda()
            valid = torch.from_numpy(rng.random(n) > (0.2 if c == null_col
                                                      else 0.0)).cuda()
            out.append(DeviceColumn(data, valid, dt))
        return out
    probe = keys(200_000, 0)
    for build in (keys(3000, 1), keys(0, 1)):
        for kw in ({}, {"outer": True}, {"mode": "semi"},
                   {"mode": "anti"}):
            got = J.join_pairs(build, probe, card.transfers, **kw)
            ref = J.join_pairs_plain(build, probe, card.transfers, **kw)
            assert torch.equal(got[0], ref[0])
            assert (got[1] is None) == (ref[1] is None)
            if got[1] is not None:
                assert torch.equal(got[1], ref[1])


@pytest.mark.parametrize("query,kw", [("q17", {}),
                                      ("q17", {"same_item": False}),
                                      ("q10", {}), ("q18", {})])
def test_q17_q10_q18_match_the_cpu_run(card, query, kw):
    from spark_rapids_tpu_torch.testing import tpcds
    names = {"q17": ("store_sales", "store_returns", "catalog_sales",
                     "date_dim", "store", "item"),
             "q10": ("customer", "customer_address", "customer_demographics",
                     "store_sales", "web_sales", "catalog_sales",
                     "date_dim"),
             "q18": ("catalog_sales", "customer_demographics", "customer",
                     "customer_address", "date_dim", "item")}[query]
    t = getattr(tpcds, f"{query}_tables")(tpcds.generate_tables(1))
    recipe = getattr(tpcds, query)
    got = recipe(*[card.create_dataframe(t[n]) for n in names],
                 **kw)[0].collect()
    cpu = TorchSession(device="cpu")
    ref = recipe(*[cpu.create_dataframe(t[n]) for n in names],
                 **kw)[0].collect()
    assert len(got) == len(ref) == (0 if query == "q17" and not kw else 100)
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-12 * abs(r[k])
            else:
                assert g[k] == r[k]
