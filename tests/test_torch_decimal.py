"""Decimals on the port (K12, the decimal kinds of K9, K1 and K3, the
decimal avg finish, K8's decimal words) against the JAX package, on the
same unscaled values, and the three faults of the reference this slice
found (ROADMAP queue 3).

- Types: Spark's result types and the JAX gate, over a grid of operand
  types, equal the JAX package's ``decimal_math``.
- Arrow: decimal64 and decimal128 columns (nulls, negatives, values past
  2^53 and past 2^64) survive Arrow -> port -> Arrow and a collect,
  exactly.
- K12's plain version (what the CPU runs and the card holds the Triton
  kernels against) equals the JAX device kernels ``tpu_binary_eval`` and
  ``compare`` bit for bit: the same validity (overflow and a zero divisor
  give NULL) and the same unscaled values where valid.
- The decimal sum kinds' plain versions (K9's over groups, K3's over
  buffer rows, K1's through the recipe's decimal form) equal
  ``_segment_reduce`` and ``_global_reduce`` bit for bit, and the
  recipe's decimal form equals the JAX DataFrame API and exact integers.
- The avg finish gives Spark's value (Python ``decimal``, ROUND_HALF_UP
  twice), and K8's decimal128 words order as the integers.
- Faults of the reference, each shown, then held to its consistent form:
  (1) a decimal cast takes the unscaled integer (``cast(1.50 as double)``
  is 150.0; its ``d + 0.0`` is 1.5, as the port's cast); (2) ``avg`` of a
  decimal is 10^4 too small (its ``sum/count`` is right, as the port's
  avg); (3) SQL compares a decimal with a literal through fault 1 (its
  DataFrame ``GreaterThan`` is right, as the port).
- What the port does not run is refused by name: an operation the JAX
  gate sends to its host tier, a decimal min, max, first or last, a
  decimal group or join key, a parquet decimal column."""

import decimal
import gc
import itertools

import jax.numpy as jnp
import numpy as np
import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.expressions import arithmetic as JA
from spark_rapids_tpu.expressions import decimal_math as JDM
from spark_rapids_tpu.expressions import predicates as JP
from spark_rapids_tpu.expressions.base import Alias as JAlias
from spark_rapids_tpu.expressions.base import EvalContext as JCtx
from spark_rapids_tpu.expressions.base import TCol
from spark_rapids_tpu.expressions.base import col as jcol
from spark_rapids_tpu.expressions.base import lit as jlit
from spark_rapids_tpu.expressions.cast import Cast as JCast
from spark_rapids_tpu.ops.agg_ops import _global_reduce, _segment_reduce
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import (HostColumnarBatch,
                                                   batch_from_arrow,
                                                   decimal_column,
                                                   host_column)
from spark_rapids_tpu_torch.columnar.column import (DeviceColumn,
                                                    decimal128_words,
                                                    decimal_value,
                                                    unscaled_ints)
from spark_rapids_tpu_torch.expressions import arithmetic as A
from spark_rapids_tpu_torch.expressions import decimal_math as DM
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions.base import (BoundReference, Col,
                                                     EvalContext, col, lit)
from spark_rapids_tpu_torch.expressions.cast import Cast
from spark_rapids_tpu_torch.io.multifile import host_arrow
from spark_rapids_tpu_torch.ops import agg_ops as G
from spark_rapids_tpu_torch.ops import decimal_ops as DO
from spark_rapids_tpu_torch.ops import sort_ops as S
from spark_rapids_tpu_torch.testing import decimal_cases as DC
from spark_rapids_tpu_torch.testing.tpcds import spark_decimal_avg


@pytest.fixture(autouse=True, scope="module")
def _collect_outside_reference_locks():
    """The JAX package's ``aux/events.py`` retires a ring sink from a
    weakref finalizer under the plain lock ``RingBufferSink.__init__``
    holds, so a cyclic collection landing there deadlocks the process.
    This module's fixtures and tests run with automatic collection off;
    it collects once they are done."""
    gc.disable()
    yield
    gc.enable()
    gc.collect()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The plain versions run many small tensor ops; a pool of intra-op
    threads in each pytest worker makes them contend for the cores.  This
    module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


Dec = decimal.Decimal
D = T.DecimalType
N = 400
#: the types of the operand grid (an int or long partner as its own type)
GRID = [D(1, 0), D(5, 2), D(7, 2), D(10, 4), D(18, 0), D(18, 6), D(19, 2),
        D(25, 5), D(38, 0), D(38, 10), T.INT, T.LONG]


def jtype(dt):
    if isinstance(dt, T.DecimalType):
        return JT.DecimalType(dt.precision, dt.scale)
    return {T.INT: JT.INT, T.LONG: JT.LONG}[dt]


@pytest.mark.parametrize("op", DM.OPS)
def test_result_types_and_gate_match_jax(op):
    for lt, rt in itertools.product(GRID, GRID):
        if not isinstance(lt, D) and not isinstance(rt, D):
            continue
        ref = JDM.binary_result_type(op, jtype(lt), jtype(rt))
        got = DM.binary_result_type(op, lt, rt)
        assert (got.precision, got.scale) == (ref.precision, ref.scale)
        assert (DM.device_supported(op, lt, rt) is None) == \
            (JDM.device_supported(op, jtype(lt), jtype(rt)) is None)
        assert (DM.compare_supported(lt, rt) is None) == \
            (JDM.compare_supported(jtype(lt), jtype(rt)) is None)


ARROW_VALUES = {
    D(18, 2): [Dec("1.50"), None, Dec("-0.01"), Dec("90071992547409.93"),
               Dec("-9999999999999999.99"), Dec("0.00")],
    D(38, 6): [Dec("1.500000"), None, Dec("-0.000001"),
               Dec("18446744073709551616.000001"),
               Dec("-99999999999999999999999999999999.999999"),
               Dec("9007199254740993.123456")],
}


@pytest.mark.parametrize("dt", list(ARROW_VALUES))
def test_arrow_round_trip_is_exact(dt):
    values = ARROW_VALUES[dt]
    arr = pa.array(values, type=pa.decimal128(dt.precision, dt.scale))
    hb = batch_from_arrow(pa.table({"v": arr}))
    assert hb.schema.types == [dt]
    assert host_arrow(hb.columns[0]).equals(arr)
    assert hb.to_pydict()["v"] == values
    rows = TorchSession(device="cpu").create_dataframe(hb).collect()
    assert [r["v"] for r in rows] == values
    assert all(r["v"].as_tuple().exponent == -dt.scale
               for r in rows if r["v"] is not None)


# -- K12 against the JAX device kernels ---------------------------------------

def operands(dt, n: int, seed: int):
    """(unscaled ints, validity) of ``dt`` (an int or long partner too)."""
    rng = np.random.default_rng(seed)
    if isinstance(dt, D):
        return DC.decimal_operands(rng, dt, n)
    hi = 2 ** 31 if dt == T.INT else 2 ** 62
    vals = [int(x) for x in rng.integers(-hi, hi, n)]
    vals[3] = 0
    return vals, rng.random(n) > 0.1


def jax_col(vals, valid, dt) -> TCol:
    if isinstance(dt, D) and dt.is_decimal128:
        data = jnp.asarray(decimal128_words(vals))
    else:
        data = jnp.asarray(np.array(vals, dtype=dt.np_dtype))
    return TCol(data, jnp.asarray(valid), jtype(dt))


def port_col(vals, valid, dt) -> Col:
    if isinstance(dt, D):
        c = decimal_column(np.array(vals, dtype=object), dt, valid)
        return Col(torch.from_numpy(c.data), torch.from_numpy(valid))
    return Col(torch.tensor(vals, dtype=dt.torch_dtype),
               torch.from_numpy(valid))


def plane_ints(data) -> list:
    return unscaled_ints(np.asarray(data))


BINARY = {"add": A.Add, "sub": A.Subtract, "mul": A.Multiply,
          "div": A.Divide, "rem": A.Remainder}
K12_CASES = [("add", D(7, 2), D(7, 2)), ("sub", D(7, 2), T.INT),
             ("add", D(18, 4), D(7, 2)), ("add", D(20, 4), D(30, 6)),
             ("sub", D(30, 6), T.LONG), ("add", D(38, 10), D(38, 10)),
             ("sub", D(38, 0), D(19, 2)), ("mul", D(7, 2), D(7, 2)),
             ("mul", D(7, 2), T.INT), ("mul", D(18, 4), D(18, 4)),
             ("mul", D(18, 9), D(10, 0)), ("div", D(7, 2), D(7, 2)),
             ("div", D(7, 2), T.INT), ("div", D(5, 2), D(4, 1)), ("div", D(8, 0), D(3, 3)),
             ("rem", D(18, 4), D(7, 2)), ("rem", D(7, 2), T.INT)]


@pytest.mark.parametrize("op,lt,rt", K12_CASES,
                         ids=[f"{o}-{l}-{r}" for o, l, r in K12_CASES])
def test_k12_plain_matches_jax_tpu_binary_eval(op, lt, rt):
    out = DM.check_binary(op, lt, rt, op)
    xv, xm = operands(lt, N, 1)
    yv, ym = operands(rt, N, 2)
    ref = JDM.tpu_binary_eval(op, jax_col(xv, xm, lt), jax_col(yv, ym, rt),
                              jtype(out), JCtx([], "tpu", N), jnp)
    e = BINARY[op](BoundReference(0, lt), BoundReference(1, rt))
    assert e.data_type == out
    got = e.eval(EvalContext([port_col(xv, xm, lt), port_col(yv, ym, rt)],
                             N, torch.device("cpu")))
    ok = np.asarray(ref.valid)
    assert np.array_equal(got.valid.numpy(), ok)
    assert (~ok).any()   # nulls in, and overflow or a zero divisor
    want = [v for v, m in zip(plane_ints(ref.data), ok) if m]
    have = [v for v, m in zip(plane_ints(got.data.numpy()), ok) if m]
    assert have == want


COMPARE_CASES = [(D(7, 2), D(18, 4)), (D(7, 2), T.INT), (D(20, 4), D(30, 6)),
                 (D(30, 6), T.LONG), (D(18, 0), D(18, 18))]


@pytest.mark.parametrize("lt,rt", COMPARE_CASES,
                         ids=[f"{l}-{r}" for l, r in COMPARE_CASES])
def test_k12_compare_matches_jax(lt, rt):
    xv, xm = operands(lt, N, 3)
    yv, ym = operands(rt, N, 3)   # equal rows where the types allow it
    ref = np.asarray(JDM.compare(jax_col(xv, xm, lt), jax_col(yv, ym, rt),
                                 JCtx([], "tpu", N), jnp))
    cols = [port_col(xv, xm, lt), port_col(yv, ym, rt)]
    ctx = EvalContext(cols, N, torch.device("cpu"))
    a, b = BoundReference(0, lt), BoundReference(1, rt)
    for cls, want in ((P.LessThan, ref < 0), (P.EqualTo, ref == 0),
                      (P.GreaterThan, ref > 0), (P.LessThanOrEqual, ref <= 0),
                      (P.GreaterThanOrEqual, ref >= 0),
                      (P.NotEqual, ref != 0)):
        got = cls(a, b).eval(ctx)
        assert np.array_equal(got.data.numpy(), want), cls.__name__
        assert np.array_equal(got.valid.numpy(), xm & ym)


def test_casts_follow_spark_and_null_on_overflow():
    cases = [(D(7, 2), D(11, 6)), (D(18, 4), D(10, 1)), (D(30, 6), D(25, 2)),
             (D(20, 4), D(38, 10)), (T.INT, D(12, 2)), (T.LONG, D(30, 4)),
             (T.LONG, D(15, 0))]
    for src, dst in cases:
        vals, valid = operands(src, N, 4)
        got = Cast(BoundReference(0, src), dst).eval(EvalContext(
            [port_col(vals, valid, src)], N, torch.device("cpu")))
        s = src.scale if isinstance(src, D) else 0
        q = Dec(1).scaleb(-dst.scale)
        with decimal.localcontext() as ctx:
            ctx.prec = 100
            want = [Dec(v).scaleb(-s).quantize(q, decimal.ROUND_HALF_UP)
                    for v in vals]
        fits = [abs(w) < Dec(10) ** (dst.precision - dst.scale) for w in want]
        assert got.valid.tolist() == [bool(m) and f
                                      for m, f in zip(valid, fits)]
        have = plane_ints(got.data.numpy())
        assert [h for h, ok in zip(have, got.valid.tolist()) if ok] == \
            [int(w.scaleb(dst.scale)) for w, ok
             in zip(want, got.valid.tolist()) if ok]


# -- the decimal sum kinds against _segment_reduce and _global_reduce --------

@pytest.mark.parametrize("dt", [D(17, 2), D(28, 2), D(36, 4)])
def test_k9_and_k3_decimal_sums_match_jax(dt):
    rng = np.random.default_rng(6)
    n, g = 3000, 40
    vals, valid = DC.decimal_operands(rng, dt, n)
    # groups numbered in order of first appearance, as K9 numbers them
    seg = np.concatenate([np.arange(g), rng.integers(0, g, n - g)])
    c = decimal_column(np.array(vals, dtype=object), dt, valid)
    col_ = DeviceColumn(torch.from_numpy(c.data), torch.from_numpy(valid),
                        dt)
    jx = jnp.asarray(c.data)
    inrow = jnp.ones(n, dtype=bool)
    ref, ref_ok = _segment_reduce("sum", jx, jnp.asarray(valid),
                                  jnp.asarray(seg), inrow, g, jnp)
    key = DeviceColumn(torch.from_numpy(seg), torch.ones(n, dtype=torch.bool),
                       T.LONG)
    kind = G.KEYED_SUM_DEC128 if dt.is_decimal128 else G.KEYED_SUM_I64
    _rep, [(got, ok)] = G.keyed_aggregate_plain([key], [col_], [kind], None)
    assert np.array_equal(ok.numpy(), np.asarray(ref_ok))
    assert np.array_equal(got.numpy(), np.asarray(ref))
    gref, gok = _global_reduce("sum", jx, jnp.asarray(valid), inrow, jnp)
    words, wvalid, kinds = G.pack_columns([col_], [(0, "sum", True, dt)])
    gw, gv = G.global_reduce_plain(words, wvalid, kinds)
    assert bool(gv[0]) == bool(gok)
    assert np.array_equal(gw.numpy(), np.asarray(gref).reshape(-1))


def test_decimal64_to_decimal128_sum_in_k9():
    rng = np.random.default_rng(8)
    vals, valid = DC.decimal_operands(rng, D(18, 2), 500)
    c = decimal_column(np.array(vals, dtype=object), D(18, 2), valid)
    col_ = DeviceColumn(torch.from_numpy(c.data), torch.from_numpy(valid),
                        D(18, 2))
    key = DeviceColumn(torch.zeros(500, dtype=torch.int64),
                       torch.ones(500, dtype=torch.bool), T.LONG)
    _rep, [(got, ok)] = G.keyed_aggregate_plain(
        [key], [col_], [G.KEYED_SUM_DEC128], None)
    assert bool(ok[0])
    assert plane_ints(got.numpy()) == [sum(v for v, m in zip(vals, valid)
                                           if m)]


def recipe_table(n: int, seed: int = 7):
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 20, n).astype(np.int64)
    w = rng.integers(-1000, 1000, n).astype(np.int32)
    d = DC.cents(rng, n, -300.0, 300.0)
    return k, w, d


def test_recipe_decimal_form_matches_jax_and_exact():
    k, w, d = recipe_table(3000)
    hb = HostColumnarBatch([host_column(k), host_column(w),
                            decimal_column(d, DC.MONEY)], len(k),
                           ["k", "w", "d"])
    port = DC.recipe_decimal(TorchSession(device="cpu").create_dataframe(
        hb, num_partitions=4))
    assert [port.schema.types[port.schema.field_index(n)]
            for n in DC.RECIPE_SUM_TYPES] == list(DC.RECIPE_SUM_TYPES.values())
    got = port.collect()[0]
    exact = DC.recipe_decimal_exact(k, w, d)
    for name, dt in DC.RECIPE_SUM_TYPES.items():
        assert got[name] == decimal_value(exact[name], dt.scale)
    jdf = TpuSession({"spark.rapids.sql.enabled": "false"}).create_dataframe(
        {"k": k, "w": w,
         "d": host_arrow(decimal_column(d, DC.MONEY))}, num_partitions=4)
    from spark_rapids_tpu.expressions import hashing as JH
    ref = (jdf.filter(JP.GreaterThan(jcol("w"), jlit(0)))
           .select(JAlias(JA.Add(jcol("k"), jlit(1)), "k1"),
                   JAlias(JA.Multiply(jcol("d"), jlit(2)), "d2"),
                   JAlias(JA.Subtract(jcol("d"), jcol("w")), "dw"),
                   JAlias(JA.Multiply(jcol("d"), jcol("w")), "dm"),
                   JAlias(JA.Multiply(JA.Multiply(jcol("d"), jcol("w")),
                                      jcol("d")), "dd"),
                   JAlias(JH.Murmur3Hash(jcol("k"), jcol("w")), "h"))
           .agg(JF.sum("k1").alias("sk"), JF.sum("d2").alias("s2"),
                JF.sum("dw").alias("sw"), JF.sum("dm").alias("sm"),
                JF.sum("dd").alias("sd"), JF.sum("h").alias("sh"))
           .collect()[0])
    assert ref == got


def test_avg_finish_follows_spark():
    rng = np.random.default_rng(9)
    for dt in (D(7, 2), D(12, 3), D(18, 0), D(20, 4)):
        total = D(min(38, dt.precision + 10), dt.scale)
        vals, valid = DC.decimal_operands(rng, total, 300)
        counts = rng.integers(0, 1 << 40, 300)
        counts[::11] = 0
        counts[1::13] = 1
        c = decimal_column(np.array(vals, dtype=object), total, valid)
        data, ok = DO.avg_finish_plain(
            torch.from_numpy(c.data), torch.from_numpy(valid),
            torch.from_numpy(counts), torch.ones(300, dtype=torch.bool), dt)
        want = [spark_decimal_avg(v, int(n), dt) if m else None
                for v, n, m in zip(vals, counts, valid)]
        assert ok.tolist() == [x is not None for x in want]
        out = D(min(38, dt.precision + 4), dt.scale + 4)
        assert [decimal_value(u, out.scale) for u, m
                in zip(plane_ints(data.numpy()), ok.tolist()) if m] == \
            [x for x in want if x is not None]


def test_k8_decimal128_words_order_as_integers():
    rng = np.random.default_rng(10)
    vals, valid = DC.decimal_operands(rng, D(30, 2), 500)
    c = decimal_column(np.array(vals, dtype=object), D(30, 2), valid)
    col_ = DeviceColumn(torch.from_numpy(c.data), torch.from_numpy(valid),
                        D(30, 2))
    for asc, nulls_first in ((True, True), (False, False)):
        perm = S.sort_permutation_plain(
            [col_], [S.SortOrder(0, asc, nulls_first)]).tolist()
        present = sorted((v for v, m in zip(vals, valid) if m),
                         reverse=not asc)
        nulls = [None] * int((~valid).sum())
        want = nulls + present if nulls_first else present + nulls
        assert [vals[i] if valid[i] else None for i in perm] == want


# -- the faults of the reference, pinned --------------------------------------

FAULT_VALUES = [Dec("1.50"), Dec("2.50"), Dec("99.50"), Dec("146.01"),
                Dec("-0.05"), None]


def jax_frame(engine):
    conf = {"spark.rapids.sql.enabled": "false"} if engine == "cpu" else {}
    s = TpuSession(conf)
    return s, s.create_dataframe(
        {"d": pa.array(FAULT_VALUES, type=pa.decimal128(7, 2)),
         "k": np.arange(len(FAULT_VALUES), dtype=np.int64)})


def port_frame():
    return TorchSession(device="cpu").create_dataframe(
        {"d": FAULT_VALUES, "k": np.arange(len(FAULT_VALUES),
                                           dtype=np.int64)},
        schema=T.StructType([T.StructField("d", D(7, 2)),
                             T.StructField("k", T.LONG)]))


@pytest.mark.parametrize("engine", ["cpu", "device"])
def test_fault1_cast_of_a_decimal_uses_the_unscaled_integer(engine):
    _s, jdf = jax_frame(engine)
    j = jdf.select(JAlias(JCast(jcol("d"), JT.DOUBLE), "c"),
                   JAlias(JA.Add(jcol("d"), jlit(0.0)), "z"),
                   JAlias(JCast(jcol("d"), JT.DecimalType(11, 6)), "e")
                   ).collect()
    assert j[0] == {"c": 150.0, "z": 1.5, "e": Dec("0.000150")}  # fault 1
    p = port_frame().select(Cast(col("d"), T.DOUBLE).alias("c"),
                            Cast(col("d"), D(11, 6)).alias("e")).collect()
    assert [r["c"] for r in p] == [r["z"] for r in j]
    assert [r["e"] for r in p] == [None if v is None else v.quantize(
        Dec("0.000001")) for v in FAULT_VALUES]


@pytest.mark.parametrize("engine", ["cpu", "device"])
def test_fault2_avg_of_a_decimal_is_too_small(engine):
    _s, jdf = jax_frame(engine)
    j = jdf.agg(JF.avg("d").alias("a"), JF.sum("d").alias("s"),
                JF.count("d").alias("n")).collect()[0]
    s, n = j["s"], j["n"]
    assert j["a"] != Dec(s) / n and abs(j["a"]) < abs(s / n) / 1000
    p = port_frame().agg(F.avg("d").alias("a")).collect()[0]["a"]
    assert p == spark_decimal_avg(int(s.scaleb(2)), n, D(7, 2))
    assert p.as_tuple().exponent == -6
    assert abs(p - s / n) < Dec("0.000001")


@pytest.mark.parametrize("engine", ["cpu", "device"])
def test_fault3_sql_compares_a_decimal_through_the_cast(engine):
    s, jdf = jax_frame(engine)
    s.create_or_replace_temp_view("t", jdf)
    sql = s.sql("select d > 100.00 as g, d between 100.00 and 150.00 as b "
                "from t").collect()
    assert sql[2]["g"] is True and sql[3]["b"] is False   # fault 3
    frame = jdf.select(JAlias(JP.GreaterThan(jcol("d"), jlit(100.0)),
                              "g")).collect()
    port = port_frame().select(
        P.GreaterThan(col("d"), lit(Dec("100.00"))).alias("g")).collect()
    assert port == frame
    assert [r["g"] for r in port] == [False, False, False, True, False, None]


# -- refused by name ---------------------------------------------------------

def test_what_the_port_does_not_run_is_refused_by_name():
    s = TorchSession(device="cpu")
    schema = T.StructType([T.StructField("d", D(7, 2)),
                           T.StructField("b", D(20, 2)),
                           T.StructField("k", T.LONG)])
    df = s.create_dataframe({"d": [Dec("1.50")], "b": [Dec("2.00")],
                             "k": [1]}, schema=schema)
    with pytest.raises(NotImplementedError, match="decimal multiply"):
        df.select(A.Multiply(col("b"), col("b")).alias("x")).collect()
    with pytest.raises(NotImplementedError, match="decimal divide"):
        df.select(A.Divide(col("b"), col("d")).alias("x")).collect()
    for fn in (F.min, F.max, F.first, F.last):
        with pytest.raises(NotImplementedError, match="decimal"):
            df.group_by("k").agg(fn("d").alias("x")).collect()
        with pytest.raises(NotImplementedError, match="decimal"):
            df.agg(fn("d").alias("x")).collect()
    with pytest.raises(NotImplementedError, match="decimal"):
        df.group_by("d").agg(F.count("k").alias("n")).collect()
    with pytest.raises(NotImplementedError, match="decimal"):
        df.join(df.select(col("d"), col("k").alias("k2")), on="d").collect()
    with pytest.raises(NotImplementedError, match="decimal"):
        Cast(BoundReference(0, D(20, 2)), T.DOUBLE)


def test_a_parquet_decimal_column_is_refused_by_name(tmp_path):
    import pyarrow.parquet as pq
    pq.write_table(pa.table({"v": pa.array([Dec("1.50")],
                                           type=pa.decimal128(7, 2))}),
                   tmp_path / "t.parquet")
    with pytest.raises(NotImplementedError, match="parquet decimal"):
        TorchSession(device="cpu").read.parquet(
            str(tmp_path / "t.parquet")).collect()
