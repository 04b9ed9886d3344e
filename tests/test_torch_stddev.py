"""The variance family in a group-by (exec/aggregate.py over K9's count
and m2 kinds in ops/agg_ops.py, then K6's finish), ``Subtract`` and
``Sqrt`` against the JAX package (keyed_agg_trace's m2 kind,
ops/agg_ops.py:490-502, with expressions/aggregates.py's StddevSamp and
VarianceSamp finishes; expressions/arithmetic.py Subtract and
mathexprs.py Sqrt), on JAX-CPU, on the same seeded inputs.

Groups hold 0, 1 and 2 present values (NULL, NULL and a value for
stddev_samp) and many; one group's values sit near 1e9 with small noise
(m2's two passes keep it within 1e-6 relative, where a one-pass sum of
squares would lose it); inputs are int and double.  Rows are compared
without regard to order, doubles within 1e-6 relative.  Subtract wraps on
overflow; Sqrt gives NaN below 0 and null for a null."""

import gc
import math

import numpy as np
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec.aggregate import TorchKeyedAggregateExec
from spark_rapids_tpu_torch.exec.fused import StageProgram
from spark_rapids_tpu_torch.expressions.arithmetic import Subtract
from spark_rapids_tpu_torch.expressions.base import (Alias, bind_references,
                                                     col, lit)
from spark_rapids_tpu_torch.expressions.mathexprs import Sqrt
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


SCHEMA = T.StructType([T.StructField("g", T.LONG), T.StructField("x", T.DOUBLE),
                       T.StructField("i", T.INT)])


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def jax_schema(schema):
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in schema.fields])


def data(rng):
    """Group 0: no present value; 1: one; 2: two; 3: 500 values near 1e9;
    4 to 9: many small ones; nulls scattered."""
    g = [0, 0, 1, 2, 2] + [3] * 500 + list(rng.integers(4, 10, 400))
    n = len(g)
    x = rng.standard_normal(n) * 10.0
    x[5:505] = 1e9 + rng.standard_normal(500) * 0.5
    xs = [float(v) for v in x]
    ints = [int(v) for v in rng.integers(-50, 50, n)]
    xs[0] = xs[1] = None
    ints[0] = ints[1] = None
    for j in rng.integers(6, n, 40):
        xs[j] = None
        ints[j] = None
    return {"g": [int(v) for v in g], "x": xs, "i": ints}


def aggs(fn):
    return [fn.stddev_samp("x").alias("sx"), fn.stddev_samp("i").alias("si"),
            fn.stddev("x").alias("sx2"), fn.var_samp("x").alias("vx"),
            fn.avg("x").alias("ax"), fn.count("x").alias("cx"),
            fn.stddev_pop("i").alias("pi"), fn.var_pop("x").alias("px")]


def test_keyed_stddev_matches_jax(jax_session):
    from spark_rapids_tpu import functions as JF
    d = data(np.random.default_rng(5))
    ref = jax_session.create_dataframe(d, jax_schema(SCHEMA)) \
        .group_by("g").agg(*aggs(JF)).collect()
    df = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .group_by("g").agg(*aggs(F))
    got = df.collect()
    assert rows_equal(ref, got, check_order=False,
                      approx_float=True) is None, (ref, got)
    by = {r["g"]: r for r in got}
    assert by[0]["sx"] is None and by[1]["sx"] is None
    assert by[2]["sx"] is not None and by[3]["sx"] > 0.1
    # the stddev of 1e9 + N(0, 0.5): within 1e-6 of numpy's two-pass one
    x3 = np.array([v for gg, v in zip(d["g"], d["x"]) if gg == 3 and
                   v is not None])
    assert abs(by[3]["sx"] - x3.std(ddof=1)) <= 1e-6 * x3.std(ddof=1)
    # count, avg's count and the two stddevs' counts share K9 slots
    agg = df.executed_plan()
    assert isinstance(agg, TorchKeyedAggregateExec)
    kinds = [k for _o, k, _dt in agg.inputs]
    assert kinds.count(G.KEYED_M2) == 2 and len(kinds) == 5


def test_m2_plain_version_folds_two_passes():
    """K9's plain m2 against the formula on a group whose one-pass sum of
    squares cancels (values near 1e9)."""
    import torch
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    rng = np.random.default_rng(8)
    x = 1e9 + rng.standard_normal(1000)
    key = DeviceColumn(torch.from_numpy(np.arange(1000) % 2),
                       torch.ones(1000, dtype=torch.bool), T.LONG)
    val = DeviceColumn(torch.from_numpy(x), torch.ones(1000,
                                                       dtype=torch.bool),
                       T.DOUBLE)
    s = TorchSession(device="cpu")
    rep, ((m2, ok),) = G.keyed_aggregate([key], [val], [G.KEYED_M2],
                                         s.transfers)
    for g in range(2):
        part = x[g::2]
        want = ((part - part.mean()) ** 2).sum()
        assert abs(float(m2[g]) - want) <= 1e-6 * want and bool(ok[g])


def test_subtract_and_sqrt_match_jax(jax_session):
    from spark_rapids_tpu.expressions import arithmetic as JA
    from spark_rapids_tpu.expressions import mathexprs as JM
    from spark_rapids_tpu.expressions.base import Alias as JAlias
    from spark_rapids_tpu.expressions.base import col as jcol
    from spark_rapids_tpu.expressions.base import lit as jlit
    schema = T.StructType([T.StructField("a", T.LONG),
                           T.StructField("b", T.INT),
                           T.StructField("x", T.DOUBLE)])
    d = {"a": [2 ** 63 - 1, -(2 ** 63), 5, None, 7, 0],
         "b": [-1, 1, 9, 3, None, 0],
         "x": [4.0, -1.0, float("nan"), None, 0.0, -0.0]}
    ref = jax_session.create_dataframe(d, jax_schema(schema)).select(
        JAlias(JA.Subtract(jcol("a"), jcol("b")), "d"),
        JAlias(JA.Subtract(jcol("b"), jlit(3)), "e"),
        JAlias(JM.Sqrt(jcol("x")), "r"),
        JAlias(JM.Sqrt(JA.Subtract(jcol("x"), jlit(1.0))), "q")).collect()
    exprs = [Alias(Subtract(col("a"), col("b")), "d"),
             Alias(Subtract(col("b"), lit(3)), "e"),
             Alias(Sqrt(col("x")), "r"),
             Alias(Sqrt(Subtract(col("x"), lit(1.0))), "q")]
    df = TorchSession(device="cpu").create_dataframe(d, schema=schema) \
        .select(*exprs)
    got = df.collect()
    assert rows_equal(ref, got, check_order=True) is None, (ref, got)
    assert got[0]["d"] == -(2 ** 63)   # wraps
    # sqrt(-0.0) is -0.0 on both, as IEEE has it
    assert math.copysign(1.0, got[5]["r"]) == math.copysign(
        1.0, ref[5]["r"]) == -1.0
    # K6 has a kernel form for both: its emitted source
    program = StageProgram([("project", [bind_references(e, schema)
                                         for e in exprs])], schema, 0)
    source = program.kernel_for((True, True, True)).source
    assert "tl.sqrt(" in source and " - " in source
