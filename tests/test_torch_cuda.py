"""The port's kernels on the card against their plain PyTorch versions:
K5 (the compacting stage, with string = and Or), K6 (the computing
projection, with IN, substring views, <, <=, >= and dates), K7 (gather,
with -1 rows), K8 (sort, with string keys), K9 (keyed aggregation, with a
double sum of an int input, double keys and five keys), K10 (hash join,
inner, left outer, left semi and left anti), K14 (whole-partition
windows), K15d (count distinct, keyed and global), the <>, NOT and
string-to-string emitters in K5 and K6, kernel 1 over string columns, K7c
(concat, with strings), K9's m2 kind, K10 on two and three key columns,
K14's ranking pass, K10x (the cross join's pairs), K10 on string keys,
K6's div, % and CASE WHEN, K11h, K11r, K7s (and their launch counts),
K9's merge kinds, K14s (running frames), K14b (bounded ROWS frames),
K14o (lag/lead source rows, their default, ntile), K10f (the full outer
join), IS NULL / IS NOT NULL in K5 and K6, K13 (computed strings:
substring and concat), K10's null-safe mode and K5's packed-word IN, K16
(dictionary decode of every type, RLE expansion), K5's code-space mode,
and TPC-DS q3, q1, q7, q15, q12, q20, q13, q19, q16, q17, q10, q18, q6,
q28, q36, q51, q8 and q5 end to end against the CPU run (q3, q18, q51, q8
and q5 also over four partitions; q3, q7 and q19 also from parquet);
out of core: K14c (the running window's carry) chunk by chunk against
its plain version, the external sort against the in-memory one, the
out-of-core FINAL merge (forced re-partition) against the in-memory
merge, and q51 under a 256 KiB pool at 1 and 4 partitions against its
in-memory rows.

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


def test_window_rank(card):
    """K14's ranking pass against its plain version: int, string and
    double keys with ties, NaN, -0.0 and nulls (sorted by K8 first), no
    partition key, and one partition of 2**20 + 3 rows of few peers."""
    from spark_rapids_tpu_torch.ops import window_ops as W
    rng = np.random.default_rng(23)
    n = 70_000
    a, bb, s, v = batch(card, rng, n).columns
    v = DeviceColumn(torch.where(v.data > 1.0, float("nan"),
                                 torch.where(v.data < -1.0, -0.0,
                                             v.data.round())),
                     v.validity, T.DOUBLE)
    for keys, order, dirs in (([a], [v], [(True, True)]),
                              ([s, a], [bb], [(False, False)]),
                              ([], [s, v], [(True, False), (False, True)]),
                              ([v], [a], [(False, True)])):
        every = keys + order
        perm = S.sort_permutation(
            every, [S.SortOrder(i) for i in range(len(keys))] +
            [S.SortOrder(len(keys) + j, *d) for j, d in enumerate(dirs)],
            card.transfers)
        cols = BO.gather_columns(every, perm, card.transfers, True)
        k, o = cols[:len(keys)], cols[len(keys):]
        got = W.window_rank(k, o, list(W.RANKING), n, a.device)
        ref = W.window_rank_plain(k, o, list(W.RANKING), n, a.device)
        for g, r in zip(got, ref):
            assert g.data.dtype == torch.int32
            assert torch.equal(g.data, r.data)
    m = (1 << 20) + 3
    one = DeviceColumn(torch.zeros(m, dtype=torch.int64, device="cuda"),
                       torch.ones(m, dtype=torch.bool, device="cuda"),
                       T.LONG, True)
    peers = DeviceColumn(torch.arange(m, device="cuda") // 7,
                         torch.ones(m, dtype=torch.bool, device="cuda"),
                         T.LONG, True)
    got = W.window_rank([one], [peers], list(W.RANKING), m, one.device)
    ref = W.window_rank_plain([one], [peers], list(W.RANKING), m,
                              one.device)
    for g, r in zip(got, ref):
        assert torch.equal(g.data, r.data)


@pytest.mark.parametrize("sizes", [(3001, 1024), (0, 5), (5, 0), (1, 1)])
def test_cross_pairs(card, sizes):
    got = J.cross_pairs(*sizes, torch.device("cuda"))
    ref = J.cross_pairs_plain(*sizes, torch.device("cuda"))
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def test_string_key_join(card):
    """K10 on string keys, alone and beside an int key, in all four
    modes: prefixes, empty strings, strings over 8 bytes, nulls; int64
    offsets on one side."""
    rng = np.random.default_rng(31)
    stems = ["", "a", "ab", "ab\0", "abcdefgh", "abcdefghi", "abcdefghX",
             "é日", "x" * 40, None]
    tr = card.transfers

    def side(n, pool):
        d = {"s": [pool[x] for x in rng.integers(0, len(pool), n)],
             "a": [int(x) for x in rng.integers(0, 3, n)]}
        return tr.upload_batch(batch_from_pydict(d, T.StructType([
            T.StructField("s", T.STRING), T.StructField("a", T.INT)])))
    probe = side(100_000, stems)
    s64 = probe.columns[0]
    s64 = DeviceColumn(s64.data, s64.validity, T.STRING, s64.all_valid,
                       s64.offsets.to(torch.int64))
    for build in (side(4_000, stems[:-3]), side(16, stems)):
        for keys in ((build.columns[0], s64),
                     ([build.columns[0], build.columns[1]],
                      [probe.columns[0], probe.columns[1]])):
            for kw in ({}, {"outer": True}, {"mode": "semi"},
                       {"mode": "anti"}):
                got = J.join_pairs(*keys, tr, **kw)
                ref = J.join_pairs_plain(*keys, tr, **kw)
                assert torch.equal(got[0], ref[0])
                assert (got[1] is None) == (ref[1] is None)
                if got[1] is not None:
                    assert torch.equal(got[1], ref[1])


def test_project_case_div_remainder(card):
    """K6's div, % and CASE WHEN (numeric, and a string view's validity)
    against its plain version, INT64_MIN div -1 and zero divisors
    included."""
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (Alias,
                                                         bind_references,
                                                         col, lit)
    from spark_rapids_tpu_torch.expressions.conditional import CaseWhen
    rng = np.random.default_rng(37)
    for n in (0, 1, 1000, (1 << 20) + 3):
        b = batch(card, rng, n)
        big = DeviceColumn(torch.from_numpy(rng.choice(
            np.array([-(2 ** 63), 2 ** 63 - 1, -7, 7, 0]), n)).cuda(),
            torch.ones(n, dtype=torch.bool, device="cuda"), T.LONG, True)
        b = type(b)(b.columns + [big], n, b.names + ["m"])
        exprs = [A.IntegralDivide(col("m"), lit(-1)),
                 A.IntegralDivide(col("b"), col("a")),
                 A.Remainder(col("a"), A.Subtract(col("a"), lit(3))),
                 A.Remainder(col("m"), col("b")),
                 CaseWhen([(P.GreaterThan(col("v"), lit(0.0)), col("a"))],
                          col("b")),
                 CaseWhen([(P.EqualTo(A.Remainder(col("b"), lit(2)),
                                      lit(0)), col("s"))])]
        program = FU.StageProgram(
            [("project", [bind_references(Alias(e, f"c{j}"), b.schema)
                          for j, e in enumerate(exprs)])], b.schema, 0)
        lits = FU.LiteralArgs([])
        got = FU.fused_project(program, b, lits)
        torch.cuda.synchronize()
        same(got, FU.fused_project_plain(program, b, lits))


@pytest.mark.parametrize("query", ["q6", "q28", "q36"])
def test_q6_q28_q36_match_the_cpu_run(card, query):
    from spark_rapids_tpu_torch.testing import tpcds
    names = {"q6": ("customer_address", "customer", "store_sales",
                    "date_dim", "item"),
             "q28": ("store_sales",),
             "q36": ("store_sales", "date_dim", "item", "store")}[query]
    t = getattr(tpcds, f"{query}_tables")(tpcds.generate_tables(1))
    recipe = getattr(tpcds, query)
    got = recipe(*[card.create_dataframe(t[n]) for n in names])[0].collect()
    cpu = TorchSession(device="cpu")
    ref = recipe(*[cpu.create_dataframe(t[n]) for n in names])[0].collect()
    assert len(got) == len(ref) == {"q6": 10, "q28": 1, "q36": 100}[query]
    for g, r in zip(got, ref):
        assert g.keys() == r.keys()
        for k in g:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-12 * abs(r[k])
            else:
                assert g[k] == r[k]


def hash_keys(rng, n):
    """Key columns of every type K11h hashes: nulls, -0.0, NaN, empty
    and 40-byte strings, bytes of 0x80 and above."""
    from spark_rapids_tpu_torch.ops.partition_ops import HashColumn
    dev = "cuda"
    valid = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    d = rng.choice(np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf]), n)
    words = ["", "a", "abc", "abcd", "abcde", "é日本", "x" * 40,
             "ÿ\u0080"]
    chars = [str(rng.choice(words)) for _ in range(n)]
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    s = card_column(HostColumn.from_strings(chars), valid)
    return [
        DeviceColumn(torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, n)
                                      .astype(np.int32)).to(dev), valid,
                     T.INT),
        DeviceColumn(torch.from_numpy(rng.integers(-2 ** 62, 2 ** 62, n))
                     .to(dev), valid, T.LONG),
        DeviceColumn(torch.from_numpy(d).to(dev), valid, T.DOUBLE),
        DeviceColumn(torch.from_numpy(rng.random(n) < 0.5).to(dev), valid,
                     T.BOOLEAN),
        HashColumn(torch.from_numpy(d.astype(np.float32)).to(dev), valid,
                   None),
        s,
    ]


def card_column(host, valid):
    return DeviceColumn(torch.from_numpy(host.data).cuda(), valid,
                        host.data_type, False,
                        torch.from_numpy(host.offsets).cuda())


def test_hash_partition_ids_match_plain(card):
    """K11h against its plain version: one to three keys of each type,
    n = 1, 2, 3, 7, 200 and 1024; ids and histogram (rows and chars)
    equal."""
    from spark_rapids_tpu_torch.ops import partition_ops as PO
    rng = np.random.default_rng(41)
    for rows in (0, 1, 1000, (1 << 16) + 3):
        keys = hash_keys(rng, rows)
        for combo in ([0], [1], [2], [3], [4], [5], [0, 5], [2, 1, 5]):
            ks = [keys[j] for j in combo]
            for n in (1, 2, 3, 7, 200, 1024):
                got = PO.hash_partition(ks, n, [keys[5]], [True] * len(ks))
                ref = PO.hash_partition_plain(ks, n, [keys[5]],
                                              [True] * len(ks))
                assert torch.equal(got[0], ref[0]), (rows, combo, n)
                assert torch.equal(got[1], ref[1]), (rows, combo, n)


def test_range_partition_ids_match_plain(card):
    """K11r against its plain version over 3 and 199 bounds of int, long,
    double and string keys, ascending and descending, nulls first and
    last."""
    from spark_rapids_tpu_torch.ops import partition_ops as PO
    from spark_rapids_tpu_torch.ops.sort_ops import (SortOrder,
                                                     sort_permutation)
    rng = np.random.default_rng(43)
    rows = 50_000
    b = batch(card, rng, rows)
    for ords in ([1], [2], [3], [0, 2], [2, 1]):
        for asc, nf in ((True, True), (False, False), (True, False)):
            keys = [b.columns[o] for o in ords]
            orders = [(asc, nf)] * len(ords)
            for nb in (3, 199):
                pick = torch.from_numpy(rng.choice(rows, 4 * nb)).cuda()
                sample = BO.gather_columns(keys, pick, card.transfers)
                perm = sort_permutation(
                    sample, [SortOrder(j, asc, nf) for j in range(len(ords))],
                    card.transfers)
                at = perm[torch.arange(1, nb + 1, device="cuda") * 4 - 1]
                bounds = BO.gather_columns(sample, at, card.transfers,
                                           unique=True)
                got = PO.range_partition(keys, bounds, orders, nb + 1)
                ref = PO.range_partition_plain(keys, bounds, orders, nb + 1)
                assert torch.equal(got[0], ref[0]), (ords, asc, nf, nb)
                assert torch.equal(got[1], ref[1])


def test_split_matches_plain(card):
    """K7s against its plain version: every column of a mixed batch, at 4
    and 200 partitions; each segment equal."""
    from spark_rapids_tpu_torch.ops import partition_ops as PO
    rng = np.random.default_rng(47)
    for rows in (0, 1, 1000, (1 << 17) + 3):
        b = batch(card, rng, rows)
        strings = [c for c in b.columns if c.is_string]
        for n in (4, 200):
            pids, counts = PO.hash_partition([b.columns[1]], n, strings)
            host = card.transfers.read_counts(counts)
            chars = [host[n:2 * n]]
            got = PO.split_columns(b.columns, pids, host[:n], chars,
                                   card.transfers)
            ref = PO.split_columns_plain(b.columns, pids, host[:n], chars)
            for g, r in zip(got, ref):
                same(g, r)


def test_partition_wrappers_count_only_launches(card):
    """K11h, K11r and K7s count a launch only where one is queued: an
    exchange of no rows counts none, one of a row counts one each."""
    from spark_rapids_tpu_torch.ops import partition_ops as PO
    rng = np.random.default_rng(59)
    for rows in (0, 1):
        b = batch(card, rng, rows)
        strings = [c for c in b.columns if c.is_string]
        bounds = BO.gather_columns([b.columns[1]], torch.zeros(
            rows, dtype=torch.int64, device="cuda"), card.transfers)
        PO.HASH_LAUNCHES = PO.RANGE_LAUNCHES = PO.SPLIT_LAUNCHES = 0
        pids, counts = PO.hash_partition([b.columns[1]], 4, strings)
        PO.range_partition([b.columns[1]], bounds, [(True, True)], 4,
                           strings)
        host = card.transfers.read_counts(counts)
        PO.split_columns(b.columns, pids, host[:4], [host[4:8]],
                         card.transfers)
        assert (PO.HASH_LAUNCHES, PO.RANGE_LAUNCHES,
                PO.SPLIT_LAUNCHES) == (rows, rows, rows)
        assert sum(host[:4]) == rows


def test_keyed_merge_kinds_match_plain(card):
    """K9's merge kinds (sums of sums and counts, the Chan merge of (n,
    mean, m2) triples) against their plain version: four partials of a
    group-by, and one group of 2^20 + 3 partial rows."""
    rng = np.random.default_rng(53)
    for rows, groups in ((4 * 1000, 1000), ((1 << 20) + 3, 1)):
        g = torch.from_numpy(rng.integers(0, groups, rows)).cuda()
        ones = torch.ones(rows, dtype=torch.bool, device="cuda")
        n = torch.from_numpy(rng.integers(0, 50, rows).astype(np.float64))
        mean = torch.from_numpy(rng.normal(100.0, 10.0, rows))
        m2 = torch.from_numpy(rng.random(rows) * 40.0)
        mean_valid = (n > 0).cuda()
        cols = [DeviceColumn(g, ones, T.LONG),
                DeviceColumn(n.cuda(), ones, T.DOUBLE),
                DeviceColumn(mean.cuda(), mean_valid, T.DOUBLE),
                DeviceColumn(m2.cuda(), ones, T.DOUBLE),
                DeviceColumn(n.long().cuda(), ones, T.LONG)]
        kinds = [G.KEYED_SUM_F64, G.KEYED_CHAN_MEAN, G.KEYED_CHAN_M2,
                 G.KEYED_SUM_I64]
        inputs = [cols[1], cols[2], cols[3], cols[4]]
        aux = [None, (cols[1], cols[2]), (cols[1], cols[2]), None]
        got = G.keyed_aggregate([cols[0]], inputs, kinds, card.transfers,
                                aux=aux)
        ref = G.keyed_aggregate_plain([cols[0]], inputs, kinds,
                                      card.transfers, aux=aux)
        assert torch.equal(got[0], ref[0])
        for (gv, gok), (rv, rok), kind in zip(got[1], ref[1], kinds):
            assert torch.equal(gok, rok)
            if kind == G.KEYED_SUM_I64:
                assert torch.equal(gv, rv)
            else:
                assert torch.allclose(gv, rv, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("query", ["q3", "q18"])
def test_queries_over_four_partitions_match_one(card, query):
    """q3 (a string-key PARTIAL/FINAL, a range sort and a limit) and q18
    (a rollup over partitions) at 4 partitions on the card equal the
    CPU run at one partition."""
    from spark_rapids_tpu_torch.testing import tpcds
    names = {"q3": ("date_dim", "store_sales", "item"),
             "q18": ("catalog_sales", "customer_demographics", "customer",
                     "customer_address", "date_dim", "item")}[query]
    t = getattr(tpcds, f"{query}_tables")(tpcds.generate_tables(5))
    recipe = getattr(tpcds, query)
    got = recipe(*tpcds.partitioned_frames(card, t, names, 4))[0].collect()
    cpu = TorchSession(device="cpu")
    ref = recipe(*[cpu.create_dataframe(t[n]) for n in names])[0].collect()
    assert len(got) == len(ref) and len(ref) >= 10
    for g, r in zip(got, ref):
        for k in g:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-9 * abs(r[k])
            else:
                assert g[k] == r[k]


def frame_inputs(rng, n, big):
    """Sorted partition keys (runs of 1 to 9 rows, one of ``big`` rows in
    the middle), an order key with ties, and values of each kind: doubles
    with NaN, +-inf, -0.0 and nulls, ints, longs and dates with nulls."""
    sizes = []
    while sum(sizes) < n - big:
        sizes.append(int(rng.integers(1, 10)))
    sizes.insert(len(sizes) // 2, big)
    g = np.repeat(np.arange(len(sizes)), sizes)[:n]
    dev = "cuda"
    valid = torch.from_numpy(rng.random(n) > 0.15).to(dev)
    d = rng.standard_normal(n) * 100
    special = rng.random(n)
    d = np.where(special < 0.01, np.nan, d)
    d = np.where((special > 0.01) & (special < 0.015), np.inf, d)
    d = np.where((special > 0.015) & (special < 0.02), -np.inf, d)
    d = np.where((special > 0.02) & (special < 0.03), -0.0, d)
    key = DeviceColumn(torch.from_numpy(g).to(dev),
                       torch.ones(n, dtype=torch.bool, device=dev), T.LONG,
                       True)
    order = DeviceColumn(torch.from_numpy(
        np.concatenate([np.sort(rng.integers(0, 4, s)) for s in sizes])[:n]
        .astype(np.int64)).to(dev), torch.ones(n, dtype=torch.bool,
                                               device=dev), T.LONG, True)
    ints = rng.integers(-1000, 1000, n)
    values = {
        T.DOUBLE: DeviceColumn(torch.from_numpy(d).to(dev), valid, T.DOUBLE),
        T.LONG: DeviceColumn(torch.from_numpy(ints * 3_000_000_000).to(dev),
                             valid, T.LONG),
        T.INT: DeviceColumn(torch.from_numpy(ints.astype(np.int32)).to(dev),
                            valid, T.INT),
        T.DATE: DeviceColumn(torch.from_numpy((ints + 11000).astype(
            np.int32)).to(dev), valid, T.DATE),
    }
    return key, order, values


def same_frame(got, ref, absum=None):
    """Validity, integers, NaN and infinities exact; finite doubles within
    1e-9 of the frame's sum of |x| (exact without ``absum``)."""
    assert torch.equal(got.validity, ref.validity)
    g = torch.where(ref.validity, got.data, torch.zeros((), dtype=
                                                        got.data.dtype,
                                                        device="cuda"))
    r = torch.where(ref.validity, ref.data, torch.zeros((), dtype=
                                                        ref.data.dtype,
                                                        device="cuda"))
    if not g.dtype.is_floating_point:
        assert torch.equal(g, r)
        return
    assert torch.equal(torch.isnan(g), torch.isnan(r))
    inf = torch.isinf(r)
    assert torch.equal(torch.where(inf, g, 0.0), torch.where(inf, r, 0.0))
    ok = torch.isfinite(r)
    limit = 0.0 if absum is None else 1e-9 * absum + 1e-12
    d = torch.where(ok, (g - r).abs(), 0.0)
    assert bool((d <= limit).all()), float(d.max())


def test_window_frames_match_plain(card):
    """K14s and K14b against their plain versions over one sorted batch
    whose middle partition spans more than three tiles: every kind (sum
    of longs and doubles, count, count(*), mean, min and max of double,
    long, int and date) over running, RANGE, whole-partition and
    reverse frames and over bounded ROWS frames."""
    from spark_rapids_tpu_torch.ops import window_ops as W
    rng = np.random.default_rng(51)
    n = 20_000
    key, order, values = frame_inputs(rng, n, 3 * 1024 + 517)
    dev = key.device
    frames = [("rows", None, 0), ("rows", None, 2), ("rows", None, -2),
              ("range", None, 0), ("rows", None, None), ("rows", 0, None),
              ("rows", 3, None), ("rows", -1, None)]
    bounded = [("rows", -1, 1), ("rows", -2, 0), ("rows", 0, 2),
               ("rows", -3, -1), ("rows", 1, 3), ("rows", -40, 5)]
    kinds = [(W.WIN_SUM_F64, T.DOUBLE), (W.WIN_SUM_I64, T.LONG),
             (W.WIN_COUNT, T.DOUBLE), (W.WIN_COUNT_ALL, None),
             (W.WIN_MEAN, T.DOUBLE)] + \
        [(k, t) for k in (W.WIN_MIN, W.WIN_MAX)
         for t in (T.DOUBLE, T.LONG, T.INT, T.DATE)]
    for fk, lo, hi in frames + bounded:
        for kind, t in kinds:
            f = W.FrameAgg(kind, fk, lo, hi)
            if kind in (W.WIN_MIN, W.WIN_MAX) and not (
                    f.bounded or (lo is None and hi in (None, 0)) or
                    (lo == 0 and hi is None)):
                continue   # refused, as the JAX program refuses it
            v = None if t is None else values[t]
            fn = W.window_bounded if f.bounded else W.window_running
            plain = W.window_bounded_plain if f.bounded else \
                W.window_running_plain
            args = ([key], [f], [v], n, dev) if f.bounded else \
                ([key], [order], [f], [v], n, dev)
            got, = fn(*args)
            torch.cuda.synchronize()
            ref, = plain(*args)
            absum = None
            if kind in (W.WIN_SUM_F64, W.WIN_MEAN) and not f.bounded:
                a = DeviceColumn(torch.where(torch.isfinite(v.data),
                                             v.data.abs(), 0.0),
                                 v.validity, T.DOUBLE)
                absum = plain(*(([key], [W.FrameAgg(W.WIN_SUM_F64, fk, lo,
                                                    hi)], [a], n, dev)
                                if f.bounded else
                                ([key], [order], [W.FrameAgg(
                                    W.WIN_SUM_F64, fk, lo, hi)], [a], n,
                                    dev)))[0].data
            same_frame(got, ref, absum)
    # a small window after a long prefix: K14b folds the frame itself
    m = (1 << 20) + 3
    one = DeviceColumn(torch.zeros(m, dtype=torch.int64, device=dev),
                       torch.ones(m, dtype=torch.bool, device=dev), T.LONG,
                       True)
    x = DeviceColumn(torch.full((m,), 1e9, dtype=torch.float64,
                                device=dev), torch.ones(m, dtype=torch.bool,
                                                        device=dev),
                     T.DOUBLE, True)
    x.data[-3:] = torch.tensor([1e-3, 2e-3, 3e-3], dtype=torch.float64)
    got, = W.window_bounded([one], [W.FrameAgg(W.WIN_SUM_F64, "rows", -1,
                                               0)], [x], m, dev)
    assert float(got.data[-1]) == 2e-3 + 3e-3
    for kind in (W.WIN_SUM_F64, W.WIN_MAX):
        f = W.FrameAgg(kind, "rows", None, 0)
        got, = W.window_running([one], [], [f], [x], m, dev)
        ref, = W.window_running_plain([one], [], [f], [x], m, dev)
        same_frame(got, ref, torch.full((m,), 1e9 * m, device=dev))


def test_window_offset_ntile_fill_match_plain(card):
    """K14o against its plain version: lag and lead maps of several
    offsets, ntile of 1, 3, 7 and more tiles than rows, and a default of
    each fixed-width type filled into a gather's -1 rows."""
    from spark_rapids_tpu_torch.ops import window_ops as W
    rng = np.random.default_rng(53)
    n = 20_000
    key, _order, values = frame_inputs(rng, n, 5000)
    dev = key.device
    offsets = [-1, -2, 1, 3, 0, -5000, 4999]
    for g, r in zip(W.window_offset([key], offsets, n, dev),
                    W.window_offset_plain([key], offsets, n, dev)):
        assert torch.equal(g, r)
    for g, r in zip(W.window_ntile([key], [1, 3, 7, 6000], n, dev),
                    W.window_ntile_plain([key], [1, 3, 7, 6000], n, dev)):
        assert torch.equal(g.data, r.data)
    m, = W.window_offset([key], [-2], n, dev)
    for t, default in ((T.DOUBLE, -99.5), (T.LONG, -(2 ** 40)),
                       (T.INT, -7), (T.DATE, 11111)):
        col, = BO.gather_columns([values[t]], m, card.transfers,
                                 nullable=True)
        same_frame(W.window_fill(col, m, default),
                   W.window_fill_plain(col, m, default))


def test_frame_wrappers_count_only_launches(card):
    from spark_rapids_tpu_torch.ops import window_ops as W
    rng = np.random.default_rng(55)
    key, order, values = frame_inputs(rng, 3000, 1100)
    before = (W.FRAME_LAUNCHES, W.BOUNDED_LAUNCHES, W.OFFSET_LAUNCHES)
    f = [W.FrameAgg(W.WIN_MAX, "rows", None, 0),
         W.FrameAgg(W.WIN_SUM_F64, "range", None, 0)]
    W.window_running([key], [order], f, [values[T.DOUBLE]] * 2, 3000,
                     key.device)
    W.window_bounded([key], [W.FrameAgg(W.WIN_MIN, "rows", -2, 2)],
                     [values[T.INT]], 3000, key.device)
    W.window_offset([key], [1, -1], 3000, key.device)
    W.window_ntile([key], [4], 3000, key.device)
    W.window_running([], [], [], [], 0, key.device)
    after = (W.FRAME_LAUNCHES, W.BOUNDED_LAUNCHES, W.OFFSET_LAUNCHES)
    assert [a - b for a, b in zip(after, before)] == [1, 1, 2]


def test_full_outer_join_matches_plain(card):
    """K10f against its plain version: int keys with nulls on both sides
    and repeated build keys, a string key, two keys, an empty probe side
    and an empty build side; pairs, unmatched build rows and the pair
    count equal."""
    rng = np.random.default_rng(57)
    tr = card.transfers

    def side(n, card_):
        d = {"k": [None if rng.random() < 0.1 else int(x)
                   for x in rng.integers(0, card_, n)],
             "s": [None if rng.random() < 0.1 else str(x)
                   for x in rng.integers(0, card_, n)],
             "a": [int(x) for x in rng.integers(0, 3, n)]}
        return tr.upload_batch(batch_from_pydict(d, T.StructType([
            T.StructField("k", T.LONG), T.StructField("s", T.STRING),
            T.StructField("a", T.INT)])))
    probe, build = side(200_000, 90_000), side(64_000, 96_000)
    for b, p in ((build, probe), (side(0, 5), probe), (build, side(0, 5)),
                 (side(1, 5), side(1, 5))):
        for keys in ((b.columns[0], p.columns[0]),
                     (b.columns[1], p.columns[1]),
                     ([b.columns[0], b.columns[2]],
                      [p.columns[0], p.columns[2]])):
            before = (J.LAUNCHES, J.FULL_LAUNCHES)
            got = J.join_pairs(*keys, tr, mode="full")
            assert (J.LAUNCHES, J.FULL_LAUNCHES) == (before[0],
                                                      before[1] + 1)
            ref = J.join_pairs_plain(*keys, tr, mode="full")
            assert got[2] == ref[2]
            assert torch.equal(got[0], ref[0])
            assert torch.equal(got[1], ref[1])


def test_null_checks_in_stage_and_project(card):
    """IS NULL and IS NOT NULL in K5 (a filter) and K6 (a column and a
    CASE over an int and a date) against the CPU run."""
    import datetime
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import col
    from spark_rapids_tpu_torch.expressions.predicates import (IsNotNull,
                                                               IsNull)
    rng = np.random.default_rng(59)
    n = 5000
    d = {"a": [None if rng.random() < 0.3 else int(x)
               for x in rng.integers(0, 100, n)],
         "b": [int(x) for x in rng.integers(0, 100, n)],
         "da": [None if rng.random() < 0.3 else
                datetime.date(2000, 1, 1) + datetime.timedelta(int(x))
                for x in rng.integers(0, 400, n)],
         "db": [datetime.date(2001, 1, 1)] * n}

    def build(s):
        df = s.create_dataframe(d)
        return df.filter(IsNotNull(col("b"))).select(
            IsNull(col("a")).alias("na"),
            F.when(IsNotNull(col("a")), col("a")).otherwise(col("b"))
            .alias("ab"),
            F.when(IsNotNull(col("da")), col("da")).otherwise(col("db"))
            .alias("d")).filter(IsNotNull(col("ab")))
    assert build(card).collect() == build(TorchSession(device="cpu")) \
        .collect()


def test_right_and_full_joins_match_the_cpu_run(card):
    """Right and full outer joins through TorchSession on the card, on an
    int key and a string key (USING: the right key, the coalesce), at one
    and three partitions, against the CPU run."""
    rng = np.random.default_rng(61)

    def data(n):
        return {"k": [None if rng.random() < 0.1 else int(x)
                      for x in rng.integers(0, 500, n)],
                "s": [None if rng.random() < 0.1 else f"s{x}"
                      for x in rng.integers(0, 500, n)],
                "v": [float(x) for x in rng.standard_normal(n)]}
    left, right = data(4000), data(3000)
    right["w"] = right.pop("v")

    def rows(s, how, on, parts):
        return sorted(map(str, s.create_dataframe(left, num_partitions=parts)
                          .join(s.create_dataframe(right,
                                                   num_partitions=parts),
                                on=on, how=how).collect()))
    cpu = TorchSession(device="cpu")
    for how in ("right", "full"):
        for on in ("k", "s"):
            for parts in (1, 3):
                assert rows(card, how, on, parts) == rows(cpu, how, on, 1)


@pytest.mark.parametrize("parts", [1, 4])
def test_q51_matches_the_cpu_run(card, parts):
    from spark_rapids_tpu_torch.testing import tpcds
    names = ("web_sales", "store_sales", "date_dim")
    t = tpcds.q51_tables(tpcds.generate_tables(5))
    got = tpcds.q51(*tpcds.partitioned_frames(card, t, names, parts)
                    )[0].collect()
    cpu = TorchSession(device="cpu")
    ref = tpcds.q51(*[cpu.create_dataframe(t[n]) for n in names]
                    )[0].collect()
    assert len(got) == len(ref) == 100
    for g, r in zip(got, ref):
        for k in g:
            if isinstance(r[k], float):
                assert abs(g[k] - r[k]) <= 1e-9 * abs(r[k])
            else:
                assert g[k] == r[k]


def _strings(rng, n, null_frac=0.1):
    stems = ["", "a", "abcdefg", "abcdefgh", "abcdefghijklmno", "x" * 40,
             "ÿé", "日本語x"]
    return [None if rng.random() < null_frac else
            stems[int(rng.integers(0, len(stems)))] for _ in range(n)]


def test_k13_matches_plain(card):
    """K13 (substring at every pos class, with and without a length;
    concat of literals and columns with nulls on either side; with a row
    map) against its plain version: offsets, chars and validity equal,
    one launch per call, none for 0 rows."""
    from spark_rapids_tpu_torch.ops import string_ops as SO
    rng = np.random.default_rng(63)
    tr = card.transfers
    dev = card.device
    for n in (0, 1, 1000, (1 << 20) + 3):
        b = tr.upload_batch(batch_from_pydict(
            {"a": _strings(rng, n), "b": _strings(rng, n, 0.2)},
            T.StructType([T.StructField("a", T.STRING),
                          T.StructField("b", T.STRING)])))
        a, c = b.columns
        rows = torch.from_numpy(rng.integers(0, max(n, 1), n // 2)).to(dev) \
            if n else None
        calls = [((SO.SUBSTRING, [a]), {"pos": p, "length": ln})
                 for p, ln in ((1, 5), (2, 3), (0, 2), (-1, None),
                               (-3, 2), (-50, 4), (41, None), (1, 0))]
        calls += [((SO.CONCAT, [b"store", a, b"#"]), {}),
                  ((SO.CONCAT, [a, c]), {}), ((SO.CONCAT, [b"web"]), {}),
                  ((SO.CONCAT, [c, None]), {})]
        for (op, parts), kw in calls:
            for r in ((None, rows) if n else (None,)):
                m = n if r is None else r.shape[0]
                before = SO.LAUNCHES
                got = SO.string_column(op, parts, m, dev, tr, rows=r, **kw)
                assert SO.LAUNCHES == before + (1 if m else 0)
                ref = SO.string_column_plain(op, parts, m, dev, tr, rows=r,
                                             **kw)
                assert torch.equal(got.offsets, ref.offsets)
                assert torch.equal(got.validity, ref.validity)
                assert torch.equal(got.data, ref.data)


@pytest.mark.parametrize("how", ["inner", "outer", "semi", "anti", "full"])
def test_null_safe_join_matches_plain(card, how):
    """K10's null-safe mode against its plain version in every mode, on
    an int key, a string key and two keys, 10% null keys on both sides."""
    rng = np.random.default_rng(67)
    tr = card.transfers

    def side(n, card_):
        d = {"k": [None if rng.random() < 0.1 else int(x)
                   for x in rng.integers(0, card_, n)],
             "s": [None if rng.random() < 0.1 else f"k{x}"
                   for x in rng.integers(0, card_, n)]}
        return tr.upload_batch(batch_from_pydict(d, T.StructType([
            T.StructField("k", T.LONG), T.StructField("s", T.STRING)])))
    build, probe = side(64_000, 90_000), side(200_000, 90_000)
    kw = {"outer": True} if how == "outer" else \
        {} if how == "inner" else {"mode": how}
    for keys in ((build.columns[0], probe.columns[0]),
                 (build.columns[1], probe.columns[1]),
                 (build.columns, probe.columns)):
        got = J.join_pairs(*keys, tr, null_safe=True, **kw)
        ref = J.join_pairs_plain(*keys, tr, null_safe=True, **kw)
        for g, r in zip(got, ref):
            if isinstance(g, torch.Tensor):
                assert torch.equal(g, r)
            else:
                assert g == r


def test_long_string_in_matches_the_cpu_run(card):
    """K5's packed-word IN over 128 five-byte literals (q8's list) and a
    substring view, against the CPU run."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import lit
    from spark_rapids_tpu_torch.expressions.predicates import In
    from spark_rapids_tpu_torch.testing.tpcds import Q8_ZIPS
    rng = np.random.default_rng(71)
    pool = list(Q8_ZIPS[:40]) + ["30411", "12345", "ÿÿÿ", "2412", ""]
    d = {"z": [None if rng.random() < 0.1 else
               str(rng.choice(pool)) + str(rng.choice(["", "-1234"]))
               for _ in range(100_000)]}

    def rows(s):
        df = s.create_dataframe(d)
        return df.filter(In(F.substring("z", 1, 5),
                            [lit(z) for z in Q8_ZIPS])).collect()
    got = rows(card)
    assert got == rows(TorchSession(device="cpu")) and got


@pytest.mark.parametrize("query", ["q8", "q5"])
def test_q8_q5_match_the_cpu_run(card, query):
    from spark_rapids_tpu_torch.testing import tpcds
    names = tuple(getattr(tpcds, f"Q{query[1:]}_COLUMNS"))
    t = getattr(tpcds, f"{query}_tables")(tpcds.generate_tables(2))
    for parts in (1, 4):
        got = getattr(tpcds, query)(*tpcds.partitioned_frames(
            card, t, names, parts))[0].collect()
        cpu = TorchSession(device="cpu")
        ref = getattr(tpcds, query)(*[cpu.create_dataframe(t[n])
                                      for n in names])[0].collect()
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            for k in g:
                if isinstance(r[k], float):
                    assert abs(g[k] - r[k]) <= 1e-9 * max(abs(r[k]), 1.0)
                else:
                    assert g[k] == r[k]


def _dictionary(session, rng, dt, size):
    """``size`` values of ``dt`` on the card, 10% of them null."""
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    valid = rng.random(size) >= 0.1
    if dt == T.STRING:
        words = ["", "x", "abcdefg", "abcdefgh", "日本語です", "é" * 20]
        return session.transfers.upload_column(HostColumn.from_strings(
            [None if not ok else words[i % 6] + str(i)
             for i, ok in enumerate(valid)]))
    data = rng.integers(-10 ** 6, 10 ** 6, size)
    if dt == T.BOOLEAN:
        data = data % 2 == 0
    return session.transfers.upload_column(HostColumn(
        data.astype(dt.np_dtype), valid, dt))


@pytest.mark.parametrize("dt", [T.STRING, T.BOOLEAN, T.INT, T.DATE, T.LONG,
                                T.DOUBLE])
@pytest.mark.parametrize("size", [0, 1, 7, 70000])
def test_k16_dictionary_matches_plain(card, dt, size):
    """K16's dictionary forms against the plain version: 10% null codes,
    null values, an empty dictionary (every row null); counted once a
    launch."""
    from spark_rapids_tpu_torch.ops import decode_ops as D
    rng = np.random.default_rng(size)
    tr = card.transfers
    values = _dictionary(card, rng, dt, size)
    n = 100_003
    codes = torch.from_numpy(rng.integers(0, max(size, 1), n).astype(
        np.int32)).cuda()
    valid = torch.from_numpy(rng.random(n) >= 0.1).cuda()
    for mask in (None, valid):
        before = D.DICT_LAUNCHES
        got = D.decode_dictionary(codes, mask, values, tr)
        assert D.DICT_LAUNCHES == before + 1
        same([got], [D.decode_dictionary_plain(codes, mask, values, tr)])


@pytest.mark.parametrize("dt", [T.BOOLEAN, T.INT, T.LONG, T.DOUBLE])
def test_k16_rle_matches_plain(card, dt):
    from spark_rapids_tpu_torch.ops import decode_ops as D
    rng = np.random.default_rng(3)
    ends = np.cumsum(rng.integers(1, 1001, 300))
    n = int(ends[-1])
    vals = _dictionary(card, rng, dt, 300)
    dends = torch.from_numpy(ends.astype(np.int32)).cuda()
    for m in (n, n + 17):
        got = D.decode_rle(vals.data, vals.validity, dends, m, dt)
        same([got], [D.decode_rle_plain(vals.data, vals.validity, dends, m,
                                        dt)])


@pytest.mark.parametrize("what", ["=", "IN", "<>", "IS NULL", "OR"])
def test_code_space_stage_matches_decoded_stage(card, what):
    """K5's code-space mode against K5 over the decoded strings and the
    plain version."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar import encoding as ENC
    from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
    from spark_rapids_tpu_torch.columnar.column import HostColumn
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions import predicates as P
    from spark_rapids_tpu_torch.expressions.base import (bind_references,
                                                         col, lit)
    rng = np.random.default_rng(5)
    n = 200_001
    names = [f"v{i}é" for i in range(300)]
    arr = pa.DictionaryArray.from_arrays(
        pa.array(rng.integers(0, 300, n).astype(np.int32),
                 mask=rng.random(n) < 0.1), pa.array(names))
    hb = HostColumnarBatch([ENC.HostDictionaryColumn(arr),
                            HostColumn(np.arange(n, dtype=np.int64), None,
                                       T.LONG)], n, ["s", "k"])
    tr = card.transfers
    b = tr.upload_batch(hb, ENC.EncodingSettings())
    assert isinstance(b.columns[0], ENC.DictionaryColumn)
    cond = {"=": P.EqualTo(col("s"), lit("v3é")),
            "IN": P.In(col("s"), ["v1é", "v9é", "none"]),
            "<>": P.NotEqual(col("s"), lit("v5é")),
            "IS NULL": P.IsNull(col("s")),
            "OR": P.Or(P.EqualTo(col("s"), lit("v3é")),
                       P.GreaterThan(col("k"), lit(n - 100, T.LONG)))}[what]
    ops = [("filter", bind_references(cond, b.schema)),
           ("project", [bind_references(col("s"), b.schema)])]
    program = FU.StageProgram(ops, b.schema, 0)
    lits = FU.LiteralArgs([])
    coded, cb, clits, kept = program.for_batch(b, lits, tr)
    assert coded.n_tables == 1 and kept == (0,)
    before = FU.CODE_SPACE_LAUNCHES
    got = FU.fused_stage_compact(coded, cb, clits, tr)
    assert FU.CODE_SPACE_LAUNCHES == before + 1
    plain = FU.fused_stage_compact_plain(coded, cb, clits, tr)
    over = FU.fused_stage_compact(program, ENC.materialize_batch(b, tr),
                                  lits, tr)
    assert torch.equal(got[0], plain[0])
    assert torch.equal(got[0], over[0])


@pytest.mark.parametrize("query", ["q3", "q7", "q19"])
def test_parquet_queries_match_memory(card, query, tmp_path):
    """q3, q7 and q19 from parquet on the card equal the in-memory run on
    the card and the parquet run on the CPU."""
    from spark_rapids_tpu_torch.testing import tpcds
    tables = tpcds.generate_tables(1)
    columns = getattr(tpcds, f"{query.upper()}_COLUMNS")
    root = tpcds.write_parquet_tables(tables, str(tmp_path), 1, columns)
    recipe = getattr(tpcds, query)
    cpu = TorchSession(device="cpu")
    got = recipe(*tpcds.parquet_frames(card, root, columns))[0].collect()
    assert got == recipe(*tpcds.parquet_frames(cpu, root, columns))[0] \
        .collect()
    cut = getattr(tpcds, f"{query}_tables")(tables)
    assert got == recipe(*[card.create_dataframe(cut[t])
                           for t in columns])[0].collect()
    assert len(got) == {"q3": 11, "q7": 100, "q19": 4}[query]


def test_code_space_fused_aggregate_matches_the_cpu_run(card, tmp_path):
    """Kernel 1 with a conjunct over a dictionary column in code space
    (its lookup table a runtime argument) against the CPU run."""
    import pyarrow as pa
    import pyarrow.parquet as pq
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exec import fused as FU
    from spark_rapids_tpu_torch.expressions.base import col, lit
    from spark_rapids_tpu_torch.expressions.predicates import EqualTo, Or
    rng = np.random.default_rng(9)
    n = 300_000
    words = np.array([f"w{i}é" for i in range(50)], dtype=object)
    pq.write_table(pa.table({
        "s": pa.array(words[rng.integers(0, 50, n)],
                      mask=rng.random(n) < 0.1),
        "k": rng.integers(0, 1000, n)}), tmp_path / "t.parquet",
        row_group_size=100_000)

    def run(session):
        return session.read.parquet(str(tmp_path / "t.parquet")).filter(
            Or(EqualTo(col("s"), lit("w3é")), EqualTo(col("s"),
                                                       lit("w7é")))) \
            .agg(F.count("k").alias("n"), F.sum("k").alias("sk")).collect()
    before = FU.LAUNCHES
    got = run(card)
    assert FU.LAUNCHES == before + 3    # one a row group
    assert got == run(TorchSession(device="cpu"))
    assert got[0]["n"] > 0


# -- out of core (K14c, the external sort, the out-of-core merge) --

@pytest.fixture
def runtime_reset():
    """The memory runtime shaped anew by the test's session, and dropped
    after it (the pool is a process's)."""
    from spark_rapids_tpu_torch.memory import device_manager as DM
    DM.shutdown()
    yield
    DM.shutdown()


def same_carry(got, ref):
    """Two K14c carries: the key row, the state and every aggregate's
    value (where valid) and validity, exactly."""
    assert (got is None) == (ref is None)
    if got is None:
        return
    same(got.keys, ref.keys)
    assert torch.equal(got.state, ref.state)
    for g, r in zip(got.values, ref.values):
        assert (g is None) == (r is None)
        if g is not None:
            dt = {torch.int32: T.INT, torch.int64: T.LONG,
                  torch.float64: T.DOUBLE}[r[0].dtype]
            same_frame(DeviceColumn(g[0], g[1], dt),
                       DeviceColumn(r[0], r[1], dt))


def test_running_fixup_matches_plain(card):
    """K14c against its plain version chunk by chunk over a sorted stream
    (chunks of 0, 1, 1000, 5000 and 1000 rows; the first form, a chunk
    continuing the carry whole, a group boundary at row 0, a group and
    a peer run across a boundary; int, string and long partition keys
    with nulls, a double order key with NaN, +-inf, -0.0 and nulls; every
    kind K14c carries); each fixed column and the carry (key row, rows,
    rank, dense rank, aggregates).  The kernel fixes the window columns in
    place (the plain version, run first, leaves them as they were)."""
    from spark_rapids_tpu_torch.ops import window_ops as W
    from spark_rapids_tpu_torch.testing import fixup_cases as FC
    rng = np.random.default_rng(31)
    sizes = (0, 1, 1000, 5000, 1000)
    pk, ok, outs_a, outs_b = FC.stream(rng, "cuda", card.transfers, sizes)
    for kinds, outs in ((FC.KINDS_A, outs_a), (FC.KINDS_B, outs_b)):
        ref = FC.run_stream(W.running_fixup_plain, pk, ok, kinds, outs,
                            card.transfers, sizes)
        before = W.FIXUP_LAUNCHES
        got = FC.run_stream(W.running_fixup, pk, ok, kinds, outs,
                            card.transfers, sizes)
        assert W.FIXUP_LAUNCHES - before == sum(k > 0 for k in sizes)
        torch.cuda.synchronize()
        start = 0
        for k, (gf, gc), (rf, rc) in zip(sizes, got, ref):
            for g, r, o in zip(gf, rf, outs):
                same_frame(g, r)
                # fixed in place (an empty tensor has no address)
                assert k == 0 or \
                    g.data.data_ptr() == o.data[start:].data_ptr()
            same_carry(gc, rc)
            start += k


def test_external_sort_matches_in_memory(card, runtime_reset):
    """The external sort (forceOutOfCore, merge batches of 700 rows) over
    ascending and descending keys, nulls first and last, NaN, -0.0 and
    strings whose widths differ between runs, against the in-memory
    sort on the CPU."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exec import sort as SX
    from spark_rapids_tpu_torch.exec.sort import SortSpec
    rng = np.random.default_rng(5)
    n = 5000
    d = data(rng, n)
    d["s"] = [None if rng.random() < 0.05 else "w" * int(rng.integers(
        0, 3 if i < n // 2 else 30)) for i in range(n)]
    d["v"] = [None if x is None else (float("nan") if rng.random() < 0.05
                                      else x) for x in d["v"]]
    specs = lambda: [SortSpec(F.col("s"), False, True),
                     SortSpec(F.col("v"), True, False),
                     SortSpec(F.col("a"), False, False),
                     SortSpec(F.col("b"), True, True)]
    prev = SX._MERGE_OUT_ROWS
    SX._MERGE_OUT_ROWS = 700
    try:
        s = TorchSession({"spark.rapids.sql.test.sort.forceOutOfCore":
                          "true"}, device="cuda")
        before = SX.EXTERNAL_SORT_EVENTS
        got = s.create_dataframe(d, 2, SCHEMA).order_by(*specs()).collect()
        assert SX.EXTERNAL_SORT_EVENTS > before
    finally:
        SX._MERGE_OUT_ROWS = prev
    ref = TorchSession(device="cpu").create_dataframe(
        d, 2, SCHEMA).order_by(*specs()).collect()
    assert len(got) == len(ref) == n
    for g, r in zip(got, ref):
        assert repr(g) == repr(r)


def test_out_of_core_merge_matches_in_memory(card, runtime_reset):
    """The FINAL group-by re-partitioned twice on the host
    (FORCE_REPARTITION_BELOW_DEPTH = 2), each bucket through K9's merge
    kinds, against the in-memory merge on the CPU."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.exec import aggregate as A
    rng = np.random.default_rng(6)
    d = data(rng, 6000, 40)

    def q(s):
        return s.create_dataframe(d, 3, SCHEMA).group_by("a", "s").agg(
            F.sum("v").alias("sv"), F.count("b").alias("c"),
            F.avg("b").alias("ab")).collect()
    before = A.REPARTITION_EVENTS
    A.FORCE_REPARTITION_BELOW_DEPTH = 2
    try:
        got = q(TorchSession(device="cuda"))
    finally:
        A.FORCE_REPARTITION_BELOW_DEPTH = 0
    assert A.REPARTITION_EVENTS > before
    ref = q(TorchSession(device="cpu"))
    key = lambda r: (r["a"] is None, r["a"] or 0, r["s"] is None,
                     r["s"] or "")
    got.sort(key=key)
    ref.sort(key=key)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert (g["a"], g["s"], g["c"]) == (r["a"], r["s"], r["c"])
        for k in ("sv", "ab"):
            assert (g[k] is None) == (r[k] is None)
            if r[k] is not None:
                assert abs(g[k] - r[k]) <= 1e-9 * max(1.0, abs(r[k]))


@pytest.mark.parametrize("parts", [1, 4])
def test_q51_out_of_core_matches_in_memory(card, runtime_reset, parts):
    """q51 at sf 5 under a 256 KiB pool: every window runs the chunked
    running path over the external sort (K14c), at 4 partitions the
    FINAL group-by re-partitions; the rows equal the in-memory run."""
    from spark_rapids_tpu_torch.exec import aggregate as A
    from spark_rapids_tpu_torch.exec import window as WX
    from spark_rapids_tpu_torch.memory import device_manager as DM
    from spark_rapids_tpu_torch.ops import window_ops as W
    from spark_rapids_tpu_torch.testing import tpcds
    names = ("web_sales", "store_sales", "date_dim")
    t = tpcds.q51_tables(tpcds.generate_tables(5))
    ref = tpcds.q51(*tpcds.partitioned_frames(card, t, names, parts)
                    )[0].collect()
    DM.shutdown()
    s = TorchSession({"spark.rapids.tpu.memory.pool.size": "256k"},
                     device="cuda")
    ev = (WX.RUNNING_WINDOW_EVENTS, W.FIXUP_LAUNCHES, A.REPARTITION_EVENTS)
    got = tpcds.q51(*tpcds.partitioned_frames(s, t, names, parts)
                    )[0].collect()
    assert got == ref and len(got) == 100
    assert WX.RUNNING_WINDOW_EVENTS - ev[0] >= 3
    assert W.FIXUP_LAUNCHES > ev[1]
    if parts > 1:
        assert A.REPARTITION_EVENTS > ev[2]
    assert DM.memory_stats()["device_to_host"] > 0
