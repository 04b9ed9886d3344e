"""The slice end to end: bench.py's recipe -- filter(w > t), project k+1,
v*2.0 and murmur3(k, w), sum all three -- on TorchSession(device="cpu")
against TpuSession on JAX-CPU, both fed the same seeded numpy planes (the
port through batch_from_numpy, the JAX package through its HostColumn),
compared with spark_rapids_tpu/testing/rowcompare.py::rows_equal.

sk and sh must match exactly; sv within 1e-12 * sum|v2| (the two engines
sum in different orders)."""

import gc

import numpy as np
import pytest

from spark_rapids_tpu.columnar.batch import HostColumnarBatch as JBatch
from spark_rapids_tpu.columnar.batch import batch_from_pydict as \
    jax_batch_from_pydict
from spark_rapids_tpu.columnar.column import HostColumn as JColumn
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_numpy
from spark_rapids_tpu_torch.exec import stage_compiler


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


F64_RTOL = 1e-12
INT64_MAX = 2 ** 63 - 1
SCHEMA = T.StructType([T.StructField("k", T.LONG),
                       T.StructField("v", T.DOUBLE),
                       T.StructField("w", T.INT)])


def recipe(df, threshold, pkg):
    import importlib
    F = importlib.import_module(f"{pkg}.functions")
    A = importlib.import_module(f"{pkg}.expressions.arithmetic")
    H = importlib.import_module(f"{pkg}.expressions.hashing")
    P = importlib.import_module(f"{pkg}.expressions.predicates")
    B = importlib.import_module(f"{pkg}.expressions.base")
    return (df
            .filter(P.GreaterThan(B.col("w"), B.lit(threshold)))
            .select(B.Alias(A.Add(B.col("k"), B.lit(1)), "k1"),
                    B.Alias(A.Multiply(B.col("v"), B.lit(2.0)), "v2"),
                    B.Alias(H.Murmur3Hash(B.col("k"), B.col("w")), "h"))
            .agg(F.sum("k1").alias("sk"), F.sum("v2").alias("sv"),
                 F.sum("h").alias("sh")))


def bench_data(n):
    """bench.py's _build_data (seed 7), no nulls."""
    rng = np.random.default_rng(7)
    return {"k": rng.integers(0, 1 << 20, n).astype(np.int64),
            "v": rng.standard_normal(n),
            "w": rng.integers(-1000, 1000, n).astype(np.int32)}


def planes(n, seed, variant):
    """(data, validity) per column.  ``nulls``: nulls in every column, k at
    INT64_MAX in part (k + 1 wraps), -0.0 in v; ``nan`` adds NaN and inf."""
    rng = np.random.default_rng(seed)
    k = rng.integers(0, 1 << 40, n).astype(np.int64)
    k[rng.random(n) < 0.3] = INT64_MAX
    v = rng.standard_normal(n)
    v[rng.random(n) < 0.05] = -0.0
    if variant == "nan":
        v[rng.random(n) < 0.01] = np.nan
        v[rng.random(n) < 0.01] = np.inf
    w = rng.integers(-1000, 1000, n).astype(np.int32)
    return [(k, rng.random(n) > 0.2), (v, rng.random(n) > 0.2),
            (w, rng.random(n) > 0.2)]


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def run_both(jax_session, cols, parts, threshold):
    n = len(cols[0][0])
    jhb = JBatch([JColumn.from_numpy(d, v) for d, v in cols], n,
                 ["k", "v", "w"])
    ref = recipe(jax_session.create_dataframe(jhb, num_partitions=parts),
                 threshold, "spark_rapids_tpu").collect()
    port = TorchSession(device="cpu")
    got = recipe(port.create_dataframe(batch_from_numpy(cols, SCHEMA),
                                       num_partitions=parts),
                 threshold, "spark_rapids_tpu_torch").collect()
    return ref, got


def assert_match(ref, got, cols, threshold):
    assert rows_equal(ref, got, check_order=True) is None, (ref, got)
    r, g = ref[0], got[0]
    assert g["sk"] == r["sk"] and g["sh"] == r["sh"]
    if r["sv"] is None or not np.isfinite(r["sv"]):
        assert g["sv"] == r["sv"] or (np.isnan(r["sv"]) and np.isnan(g["sv"]))
        return
    (_k, _kv), (v, vv), (w, wv) = cols
    sel = wv & (w > threshold) & vv
    assert abs(g["sv"] - r["sv"]) <= F64_RTOL * np.abs(v[sel] * 2.0).sum()


@pytest.mark.parametrize("n", [0, 1, 7, 4099])
@pytest.mark.parametrize("parts", [1, 4])
def test_recipe_matches_jax_with_nulls(jax_session, n, parts):
    cols = planes(n, seed=n * 10 + parts, variant="nulls")
    ref, got = run_both(jax_session, cols, parts, 0)
    assert_match(ref, got, cols, 0)


@pytest.mark.parametrize("n,parts,threshold", [(7, 1, 0), (4099, 4, 0),
                                               (4099, 4, -500)])
def test_recipe_matches_jax_with_nan(jax_session, n, parts, threshold):
    cols = planes(n, seed=n + parts, variant="nan")
    ref, got = run_both(jax_session, cols, parts, threshold)
    assert_match(ref, got, cols, threshold)


def test_filter_that_keeps_no_row_gives_null_sums(jax_session):
    cols = planes(4099, seed=1, variant="nulls")
    ref, got = run_both(jax_session, cols, 4, 1000)
    assert got == [{"sk": None, "sv": None, "sh": None}]
    assert_match(ref, got, cols, 1000)


def test_bench_data_matches_jax(jax_session):
    d = bench_data(4099)
    ref = recipe(jax_session.create_dataframe(jax_batch_from_pydict(d),
                                              num_partitions=4),
                 0, "spark_rapids_tpu").collect()
    port = TorchSession(device="cpu")
    got = recipe(port.create_dataframe(d, num_partitions=4), 0,
                 "spark_rapids_tpu_torch").collect()
    cols = [(d["k"], np.ones(4099, bool)), (d["v"], np.ones(4099, bool)),
            (d["w"], np.ones(4099, bool))]
    assert_match(ref, got, cols, 0)


def test_repeat_and_other_threshold_build_nothing():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(bench_data(1000), num_partitions=4)
    first = recipe(df, 0, "spark_rapids_tpu_torch").collect()
    built = stage_compiler.stats()
    assert recipe(df, 0, "spark_rapids_tpu_torch").collect() == first
    recipe(df, 5, "spark_rapids_tpu_torch").collect()
    after = stage_compiler.stats()
    assert after["builds"] == built["builds"]
    assert after["hits"] >= built["hits"] + 2


def test_table_stays_on_device_and_one_sync_per_query():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(bench_data(1000), num_partitions=4)
    recipe(df, 0, "spark_rapids_tpu_torch").collect()
    before = s.transfers.stats()
    recipe(df, 3, "spark_rapids_tpu_torch").collect()
    after = s.transfers.stats()
    assert after["syncs"] - before["syncs"] == 1
    # only the literal table goes up: the scan's columns stayed resident
    assert after["h2d_copies"] - before["h2d_copies"] == 1
    # three result columns, data and validity each
    assert after["d2h_copies"] - before["d2h_copies"] == 6


def test_explain_shows_one_fused_stage():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(bench_data(100), num_partitions=4)
    text = recipe(df, 0, "spark_rapids_tpu_torch").explain()
    assert "TorchFusedAgg[mode=partial" in text
    assert "TorchHashAggregate[final" in text
    assert "TorchExchange[SinglePartition]" in text
    assert "$lit0=0" in text


def test_outside_the_slice_is_refused():
    """A filter that feeds no aggregate runs since the compacting stage
    came in; a group-by over several partitions since the exchanges came
    in (PARTIAL, a hash exchange, FINAL)."""
    from spark_rapids_tpu_torch import functions as F
    from spark_rapids_tpu_torch.expressions.base import col, lit
    from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
    s = TorchSession(device="cpu")
    d = bench_data(10)
    rows = s.create_dataframe(d).filter(
        GreaterThan(col("w"), lit(0))).collect()
    assert [r["k"] for r in rows] == d["k"][d["w"] > 0].tolist()
    df = s.create_dataframe(d, num_partitions=2)
    got = df.group_by("w").agg(F.sum("v").alias("sv")).collect()
    want = {int(w): float(d["v"][d["w"] == w].sum())
            for w in np.unique(d["w"])}
    assert {r["w"]: r["sv"] for r in got}.keys() == want.keys()
    for r in got:
        assert abs(r["sv"] - want[r["w"]]) <= 1e-12 * max(1.0, abs(
            want[r["w"]]))
