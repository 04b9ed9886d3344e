"""The cross join on the port (exec/joins.py
TorchBroadcastNestedLoopJoinExec over ops/join_ops.py cross_pairs, K10x's
plain version, and K7) against the JAX package: its ``cross_pairs``
(ops/join_ops.py:251, on JAX-CPU) for the pairs, and its SQL ``select *
from a, b`` (a BroadcastNestedLoopJoinExec[cross]) for the rows, on the
same seeded inputs, an empty side included.

Pairs are probe-major on both sides, so they are compared in order and
exactly; rows are compared in order (the left side's rows in order, each
with every right row in order)."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.exec.joins import (
    TorchBroadcastNestedLoopJoinExec)
from spark_rapids_tpu_torch.ops import join_ops as J


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


SIZES = [(0, 3), (3, 0), (1, 1), (7, 5), (2, 9)]


def sides(n_left, n_right, seed=3):
    rng = np.random.default_rng(seed + 10 * n_left + n_right)
    left = {"a": [int(x) for x in rng.integers(-5, 5, n_left)],
            "s": [None if rng.random() < 0.2 else f"s{int(x)}"
                  for x in rng.integers(0, 100, n_left)]}
    right = {"b": [None if rng.random() < 0.2 else float(x)
                   for x in rng.standard_normal(n_right)],
             "t": [f"t{int(x)}" * int(x % 3) for x in
                   rng.integers(0, 100, n_right)]}
    return left, right


@pytest.mark.parametrize("n_left,n_right", SIZES)
def test_cross_pairs_match_jax(n_left, n_right):
    from spark_rapids_tpu.columnar.batch import batch_from_pydict
    from spark_rapids_tpu.ops import join_ops as JJ
    left, right = sides(n_left, n_right)
    lb = batch_from_pydict({"a": np.array(left["a"], np.int64)}).to_device()
    rb = batch_from_pydict({"b": np.zeros(n_right)}).to_device()
    l_idx, r_idx, keep, _bucket = JJ.cross_pairs(lb, rb)
    keep = np.asarray(keep)
    probe, build = J.cross_pairs(n_left, n_right, torch.device("cpu"))
    assert probe.dtype == build.dtype == torch.int64
    assert probe.tolist() == np.asarray(l_idx)[keep].tolist()
    assert build.tolist() == np.asarray(r_idx)[keep].tolist()


@pytest.mark.parametrize("n_left,n_right", SIZES)
def test_cross_join_rows_match_jax_sql(n_left, n_right):
    from spark_rapids_tpu import types as JT
    left, right = sides(n_left, n_right)
    js = TpuSession({"spark.rapids.sql.enabled": "true"})
    lschema = JT.StructType([JT.StructField("a", JT.LONG),
                             JT.StructField("s", JT.STRING)])
    rschema = JT.StructType([JT.StructField("b", JT.DOUBLE),
                             JT.StructField("t", JT.STRING)])
    js.create_or_replace_temp_view(
        "l", js.create_dataframe(left, lschema, num_partitions=1))
    js.create_or_replace_temp_view(
        "r", js.create_dataframe(right, rschema, num_partitions=1))
    ref = js.sql("select * from l, r").collect()
    from spark_rapids_tpu_torch import types as T
    s = TorchSession(device="cpu")
    df = s.create_dataframe(left, schema=T.StructType([
        T.StructField("a", T.LONG), T.StructField("s", T.STRING)])).join(
        s.create_dataframe(right, schema=T.StructType([
            T.StructField("b", T.DOUBLE), T.StructField("t", T.STRING)])),
        how="cross")
    got = df.collect()
    assert len(got) == len(ref) == n_left * n_right
    assert rows_equal(ref, got, check_order=True, approx_float=False) \
        is None, (ref, got)
    assert isinstance(df.executed_plan(), TorchBroadcastNestedLoopJoinExec)


def test_cross_joins_outside_the_port_are_refused():
    s = TorchSession(device="cpu")
    a = s.create_dataframe({"x": [1]})
    with pytest.raises(ValueError, match="no keys"):
        a.join(a, on="x", how="cross")
    with pytest.raises(NotImplementedError, match="condition"):
        a.join(a, how="cross", condition=object())
    with pytest.raises(NotImplementedError, match="without keys"):
        a.join(a, how="inner")
