"""count(DISTINCT) (functions.count_distinct, K15d's plain version in
ops/agg_ops.py count_distinct_plain, over K9's groups or one group)
against the JAX package's F.count_distinct (exec/aggregate.py:510
_complete_collect with ops/agg_ops.py collect_phase1/2, on JAX-CPU), on
the same seeded inputs.

Counts are exact.  Keyed results are compared without regard to order
(the port numbers groups in order of first appearance); the sums beside
them within 1e-9 relative.  The cases: nulls (never counted), NaN (one
value), -0.0 and 0.0 (one value), long, int, double and string values,
an empty input (a global count of 0) and one row."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import fused as FU
from spark_rapids_tpu_torch.expressions.base import col, lit
from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
from spark_rapids_tpu_torch.ops import agg_ops as G


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
    threads in each pytest worker makes them contend for the cores (the
    port's test files took 125 s at -n 6 with torch's default threads and
    61 s on one thread each, on an 8-core machine under load).  This
    module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEMA = T.StructType([T.StructField("g", T.INT), T.StructField("l", T.LONG),
                       T.StructField("i", T.INT), T.StructField("d", T.DOUBLE),
                       T.StructField("s", T.STRING)])
VALUES = ("l", "i", "d", "s")


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def jax_schema(schema):
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in schema.fields])


def table(rng, n, groups):
    def nulls(xs, frac=0.15):
        return [None if rng.random() < frac else x for x in xs]
    specials = np.array([0.0, -0.0, np.nan, 1.5, -2.25, np.inf])
    return {
        "g": nulls([int(x) for x in rng.integers(0, groups, n)], 0.05),
        "l": nulls([int(x) for x in rng.integers(-4, 4, n)]),
        "i": nulls([int(x) for x in rng.integers(0, 9, n)]),
        "d": nulls([float(x) for x in rng.choice(specials, n)]),
        "s": nulls([str(x) for x in rng.choice(
            ["", "a", "ab", "ab\0", "日本", "é", "brand10"], n)]),
    }


def jax_counts(jax_session, data, keyed):
    """The JAX package's rows: the string column's distinct count in a
    query of its own (with a string count(DISTINCT) beside it, the JAX
    package counts a double's -0.0 and 0.0 apart, against its own result
    without one and Spark's rule), the others, the sum and the row count
    in a second; keyed rows by group."""
    jdf = jax_session.create_dataframe(data, jax_schema(SCHEMA))

    def run(*aggs):
        q = jdf.group_by("g").agg(*aggs) if keyed else jdf.agg(*aggs)
        return {r.get("g"): r for r in q.collect()}
    out = run(*[JF.count_distinct(c).alias(f"n_{c}") for c in VALUES
                if c != "s"],
              JF.sum("d").alias("sd"), JF.count("*").alias("rows"))
    for g, r in run(JF.count_distinct("s").alias("n_s")).items():
        out[g]["n_s"] = r["n_s"]
    return [out[g] for g in out]


@pytest.mark.parametrize("n,groups,keyed", [
    (500, 7, True), (300, 300, True), (1, 1, True), (500, 7, False),
    (300, 300, False), (1, 1, False), (0, 1, False)])
def test_count_distinct_matches_jax(jax_session, n, groups, keyed):
    rng = np.random.default_rng(n + groups)
    data = table(rng, n, groups)
    ref = jax_counts(jax_session, data, keyed)
    df = TorchSession(device="cpu").create_dataframe(data, schema=SCHEMA)
    aggs = [F.count_distinct(c).alias(f"n_{c}") for c in VALUES] + \
        [F.sum("d").alias("sd"), F.count("*").alias("rows")]
    got = (df.group_by("g").agg(*aggs) if keyed else df.agg(*aggs)) \
        .collect()
    assert rows_equal(ref, got, check_order=False,
                      approx_float=True) is None, (ref, got)
    for r in got:
        for c in VALUES:
            assert isinstance(r[f"n_{c}"], int)
    if not keyed:
        assert len(got) == 1
        if n == 0:
            assert got[0]["n_l"] == 0 and got[0]["sd"] is None


def test_special_values_count_once():
    s = TorchSession(device="cpu")
    vals = [0.0, -0.0, float("nan"), float("nan"), None, 1.0]
    df = s.create_dataframe({"d": vals, "g": [1, 1, 1, 2, 2, 2]})
    assert df.agg(F.count_distinct("d").alias("n")).collect() == [{"n": 3}]
    assert df.group_by("g").agg(F.count_distinct("d").alias("n")) \
        .collect() == [{"g": 1, "n": 2}, {"g": 2, "n": 2}]


def test_plain_version_counts_per_group():
    dev = torch.device("cpu")
    v = DeviceColumn(torch.tensor([3, 3, 4, 3, 9, 9], dtype=torch.int64),
                     torch.tensor([True, True, True, True, False, True]),
                     T.LONG)
    gid = torch.tensor([0, 0, 0, 1, 1, 2], dtype=torch.int64)
    assert G.count_distinct(v, gid, 3).tolist() == [2, 1, 1]
    assert G.count_distinct(v).tolist() == [3]
    empty = DeviceColumn(torch.zeros(0, dtype=torch.int64),
                         torch.zeros(0, dtype=torch.bool), T.LONG)
    assert G.count_distinct(empty).tolist() == [0]
    assert G.count_distinct_plain(v, gid, 3).device == dev
    with pytest.raises(ValueError, match="one group"):
        G.count_distinct(v, None, 2)
    with pytest.raises(NotImplementedError, match="BooleanType"):
        G.count_distinct(DeviceColumn(torch.ones(2, dtype=torch.bool),
                                      torch.ones(2, dtype=torch.bool),
                                      T.BOOLEAN))


def test_plans_and_refusals():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(table(np.random.default_rng(3), 50, 4),
                            schema=SCHEMA)
    q = df.filter(GreaterThan(col("i"), lit(2))).agg(
        F.count_distinct("s").alias("n"), F.sum("l").alias("t"))
    plan = q.executed_plan()
    assert isinstance(plan, FU.TorchFusedAggExec)
    assert "count(DISTINCT s)" in plan.node_string()
    # the chain runs as a stage below, whose rows K15d reads
    assert not plan.ops
    assert isinstance(plan.child, FU.TorchFusedStageExec)
    rows = [r for r in df.collect() if r["i"] is not None and r["i"] > 2]
    assert q.collect() == [{
        "n": len({r["s"] for r in rows if r["s"] is not None}),
        "t": sum(r["l"] for r in rows if r["l"] is not None)}]
    # over several partitions: COMPLETE behind an exchange of the raw rows
    # by the keys, or of everything into one partition
    two = s.create_dataframe(table(np.random.default_rng(4), 50, 4),
                             num_partitions=2, schema=SCHEMA)
    one = s.create_dataframe(table(np.random.default_rng(4), 50, 4),
                             schema=SCHEMA)
    assert two.agg(F.count_distinct("l")).collect() == \
        one.agg(F.count_distinct("l")).collect()
    by_g = [two.group_by("g").agg(F.count_distinct("l")).collect(),
            one.group_by("g").agg(F.count_distinct("l")).collect()]
    assert sorted(by_g[0], key=str) == sorted(by_g[1], key=str)
    with pytest.raises(NotImplementedError, match="of an expression"):
        df.agg(F.count_distinct(F.substring("s", 1, 1))).collect()

