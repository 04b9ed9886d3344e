"""The hash join's modules (ops/join_ops.py, K10, and exec/joins.py) against
the JAX package's inner equi-join (exec/joins.py with ops/join_ops.py, run
on JAX-CPU as tests/test_joins.py runs it), on the same seeded inputs.

Rows are compared with rowcompare.rows_equal, without regard to order (a
join's output order is not part of its contract); keys and values are
exact.  On the CPU the wrapper runs K10's plain version."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec import joins as PJ
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


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def side(rng, n, hi, null_frac, name):
    """Keys in [0, hi) (a list with None where null_frac asks for nulls,
    else an int64 array) and double values."""
    keys = rng.integers(0, hi, n).astype(np.int64)
    vals = rng.standard_normal(n).round(3)
    if null_frac:
        keys = [None if rng.random() < null_frac else int(k) for k in keys]
    return {"k": keys, name: vals}


def both(jax_session, left, right, schema_l=None, schema_r=None):
    """The JAX package's rows (both keys long) and the port's, with the
    port's schemas where given."""
    ref = jax_session.create_dataframe(left).join(
        jax_session.create_dataframe(right), on="k").collect()
    s = TorchSession(device="cpu")
    df = s.create_dataframe(left, schema=schema_l).join(
        s.create_dataframe(right, schema=schema_r), on="k")
    return ref, df.collect(), df


@pytest.mark.parametrize("nl,nr,hi,nulls", [(0, 5, 3, 0.0), (5, 0, 3, 0.0),
                                             (1, 1, 1, 0.0),
                                             (40, 300, 25, 0.2),
                                             (500, 60, 80, 0.1)])
def test_inner_join_matches_jax(jax_session, nl, nr, hi, nulls):
    rng = np.random.default_rng(nl * 1000 + nr)
    left = side(rng, nl, hi, nulls, "lv")
    right = side(rng, nr, hi, nulls, "rv")
    ref, got, df = both(jax_session, left, right)
    assert rows_equal(ref, got, check_order=False) is None, (ref, got)
    assert df.columns == ["k", "lv", "rv"]


def test_int_keys_join_long_keys(jax_session):
    rng = np.random.default_rng(4)
    left = side(rng, 50, 20, 0.1, "lv")
    right = side(rng, 70, 20, 0.1, "rv")
    schema_l = T.StructType([T.StructField("k", T.INT),
                             T.StructField("lv", T.DOUBLE)])
    ref, got, _ = both(jax_session, left, right, schema_l=schema_l)
    assert rows_equal(ref, got, check_order=False) is None


def test_pairs_are_in_probe_then_build_order():
    rng = np.random.default_rng(8)
    b = rng.integers(0, 6, 40)
    p = rng.integers(0, 8, 90)
    bv, pv = rng.random(40) > 0.2, rng.random(90) > 0.2
    s = TorchSession(device="cpu")
    build = DeviceColumn(torch.from_numpy(b), torch.from_numpy(bv), T.LONG)
    probe = DeviceColumn(torch.from_numpy(p), torch.from_numpy(pv), T.LONG)
    syncs = s.transfers.stats()["syncs"]
    pr, br = J.join_pairs(build, probe, s.transfers)
    assert s.transfers.stats()["syncs"] - syncs == 1
    want = [(i, j) for i in range(90) for j in range(40)
            if pv[i] and bv[j] and p[i] == b[j]]
    assert list(zip(pr.tolist(), br.tolist())) == want


@pytest.mark.parametrize("small_left", [True, False])
def test_build_side_is_the_smaller_side(jax_session, monkeypatch,
                                        small_left):
    rng = np.random.default_rng(11)
    small = side(rng, 12, 30, 0.0, "sv")
    big = side(rng, 400, 30, 0.0, "bv")
    left, right = (small, big) if small_left else (big, small)
    seen = []
    real = PJ.join_pairs

    def spy(build, probe, transfers):
        seen.append((build.row_count, probe.row_count))
        return real(build, probe, transfers)
    monkeypatch.setattr(PJ, "join_pairs", spy)
    ref, got, df = both(jax_session, left, right)
    assert seen == [(12, 400)]
    assert rows_equal(ref, got, check_order=False) is None
    # the USING projection: key, then the left side's values, then the
    # right side's, whichever side was built
    names = ["k", "sv", "bv"] if small_left else ["k", "bv", "sv"]
    assert df.columns == names and list(got[0]) == names
    join = df.executed_plan().children[0]
    assert isinstance(join, PJ.TorchHashJoinExec)
    assert join.schema.names == ["k", names[1], "k", names[2]]


def test_joins_outside_the_port_are_refused_by_name():
    s = TorchSession(device="cpu")
    a = s.create_dataframe({"k": [1, 2], "s": [1.5, 2.5]})
    b = s.create_dataframe({"k": [1, 3], "s": [1.5, 3.5], "v": [1.0, 2.0]})
    with pytest.raises(NotImplementedError, match="full_outer joins"):
        a.join(b, on="k", how="full_outer").collect()
    # several key columns join (tests/test_torch_multikey_join.py), and
    # string keys (tests/test_torch_string_join.py), but not a double
    # among them, nor more than eight
    with pytest.raises(NotImplementedError, match="DoubleType"):
        a.join(b, on=["k", "s"]).collect()
    wide = s.create_dataframe({f"c{i}": [1, 2] for i in range(9)})
    with pytest.raises(NotImplementedError, match="9 key columns"):
        wide.join(wide, on=[f"c{i}" for i in range(9)]).collect()
    with pytest.raises(NotImplementedError, match="DoubleType"):
        a.join(b, on="s").collect()
    from spark_rapids_tpu_torch.expressions.base import col, lit
    from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
    with pytest.raises(NotImplementedError, match="condition"):
        a.join(b, on="k", condition=GreaterThan(col("v"), lit(1.0)))
    with pytest.raises(NotImplementedError, match="without keys"):
        a.join(b)
    # a join over several partitions runs behind two hash exchanges
    parts = s.create_dataframe({"k": [1, 2, 3, 4]}, num_partitions=2)
    got = parts.join(b, on="k").collect()
    assert got == [{"k": 1, "s": 1.5, "v": 1.0}, {"k": 3, "s": 3.5,
                                                  "v": 2.0}]

