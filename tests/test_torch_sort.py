"""The sort's modules (ops/sort_ops.py, K8, and exec/sort.py) against the
JAX package's ORDER BY (exec/sort.py over ops/sort_ops.py
sort_gather_batch, on JAX-CPU), on the same seeded inputs.

Keys hold NaN, -0.0, +-inf, nulls and ties; a row-number column shows
that ties keep their input order (both sorts are stable).  Rows are
compared in order with rowcompare.rows_equal, exactly."""

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
from spark_rapids_tpu_torch.ops import sort_ops as S


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


def data(n, seed):
    rng = np.random.default_rng(seed)
    pool = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.5, -2.25, 3.0]
    d = [None if rng.random() < 0.1 else float(rng.choice(pool))
         for _ in range(n)]
    a = [None if rng.random() < 0.15 else int(x)
         for x in rng.integers(-3, 4, n)]
    b = rng.integers(-(1 << 40), 1 << 40, n).astype(np.int64)
    b[rng.random(n) < 0.3] = 7
    return {"i": np.arange(n, dtype=np.int64), "d": d, "a": a, "b": b}


def _specs(pkg_f, keys):
    out = []
    for name, asc, nulls_first in keys:
        fn = pkg_f.asc if asc else pkg_f.desc
        out.append(fn(name) if nulls_first is None
                   else fn(name, nulls_first=nulls_first))
    return out


ORDERS = [
    [("d", True, None)],
    [("d", False, None)],
    [("d", True, False)],
    [("a", True, None), ("d", False, None)],
    [("a", False, True), ("b", True, None)],
    [("b", False, None), ("d", True, True), ("a", True, False)],
]


@pytest.mark.parametrize("n", [0, 1, 200])
@pytest.mark.parametrize("keys", ORDERS)
def test_order_by_matches_jax(jax_session, n, keys):
    d = data(n, seed=n + len(keys))
    schema = T.StructType([T.StructField("i", T.LONG),
                           T.StructField("d", T.DOUBLE),
                           T.StructField("a", T.INT),
                           T.StructField("b", T.LONG)])
    ref = jax_session.create_dataframe(d).order_by(
        *_specs(JF, keys)).collect()
    got = TorchSession(device="cpu").create_dataframe(d, schema=schema) \
        .order_by(*_specs(F, keys)).collect()
    assert rows_equal(ref, got, check_order=True,
                      approx_float=False) is None, (keys, ref, got)


def test_names_and_ascending_flag_like_jax(jax_session):
    d = data(100, seed=3)
    ref = jax_session.create_dataframe(d).order_by(
        "a", "b", ascending=False).collect()
    got = TorchSession(device="cpu").create_dataframe(d).order_by(
        "a", "b", ascending=False).collect()
    assert rows_equal(ref, got, check_order=True,
                      approx_float=False) is None


def test_plain_words_follow_the_sql_order():
    x = torch.tensor([float("nan"), float("inf"), 1.0, 0.0, -0.0, -1.0,
                      float("-inf")], dtype=torch.float64)
    col = DeviceColumn(x, torch.ones(7, dtype=torch.bool), T.DOUBLE,
                       all_valid=True)
    perm = S.sort_permutation([col], [S.SortOrder(0)])
    # -0.0 equals 0.0, so those two keep their input order
    assert perm.tolist() == [6, 5, 3, 4, 2, 1, 0]
    perm = S.sort_permutation([col], [S.SortOrder.desc(0)])
    assert perm.tolist() == [0, 1, 2, 3, 4, 5, 6]


def test_sorts_outside_the_port_are_refused():
    s = TorchSession(device="cpu")
    with pytest.raises(NotImplementedError, match="BooleanType"):
        s.create_dataframe({"b": np.array([True, False])}).order_by("b") \
            .collect()
    # over several partitions a range exchange comes first
    got = s.create_dataframe({"k": np.arange(4)[::-1].copy()},
                             num_partitions=2).order_by("k").collect()
    assert [r["k"] for r in got] == [0, 1, 2, 3]

