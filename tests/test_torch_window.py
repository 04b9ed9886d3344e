"""Whole-partition windows on the port (exec/window.py TorchWindowExec,
ops/window_ops.py compute_windows and window_reduce's plain version, K14)
against the JAX package's windows (exec/window.py over ops/window_ops.py
compute_windows, on JAX-CPU), on the same inputs, at one partition.

Counterparts of tests/test_window.py's test_whole_partition_agg,
test_window_no_partition, test_window_string_partition_keys,
test_window_with_column_and_expr, test_window_int_sum_types and
test_window_sum_nan_inf_no_poison, each over the whole partition (the
frame the port runs), plus double, date and null keys, long sums that
wrap and an all-null partition.  Rows are compared in order (both sort
stably by the partition keys) with rowcompare.rows_equal: keys, counts
and long sums exact, double sums and means within 1e-6 relative (the JAX
package takes prefix-sum differences, the port sums each partition)."""

import datetime
import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.expressions import arithmetic as JA
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
from spark_rapids_tpu_torch.expressions import arithmetic as A
from spark_rapids_tpu_torch.expressions.base import Alias


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


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def _data():
    return {
        "g": [1, 1, 1, 2, 2, None, 3, 3, 3, 3],
        "o": [3, 1, 2, 5, 5, 1, None, 2, 9, 4],
        "v": [1.0, 2.0, None, 4.0, 5.0, 6.0, 7.0, None, 9.0, 10.0],
    }


def both(jax_session, data, build):
    """Rows of ``build(functions module, DataFrame)`` on the JAX package
    and on the port (CPU), each over ``data`` at one partition."""
    ref = build(JF, jax_session.create_dataframe(data, num_partitions=1),
                JA).collect()
    got = build(F, TorchSession(device="cpu").create_dataframe(data), A) \
        .collect()
    return ref, got


def same(ref, got):
    assert len(ref) == len(got)
    assert rows_equal(ref, got, check_order=True, approx_float=True) \
        is None, (ref, got)


AGGS = {"sum": lambda f: f.sum("v"), "count": lambda f: f.count("v"),
        "avg": lambda f: f.avg("v")}


@pytest.mark.parametrize("agg", list(AGGS))
def test_whole_partition_agg(jax_session, agg):
    def build(f, df, _a):
        return df.select(f.col("g"), f.col("v"), Alias(
            AGGS[agg](f).over(f.Window.partition_by("g")), "a")) \
            if f is F else df.select(f.col("g"), f.col("v"), f.Alias(
                AGGS[agg](f).over(f.Window.partition_by("g")), "a"))
    same(*both(jax_session, _data(), build))


def named(f, e, name):
    return Alias(e, name) if f is F else f.Alias(e, name)


def test_window_no_partition(jax_session):
    def build(f, df, _a):
        w = f.Window.partition_by()
        return df.select(f.col("o"), f.col("v"),
                         named(f, f.sum("v").over(w), "s"),
                         named(f, f.count().over(w), "c"),
                         named(f, f.avg("o").over(w), "m"))
    same(*both(jax_session, _data(), build))


def test_window_string_partition_keys(jax_session):
    data = {"g": ["a", "a", "b", None, "b", "a", "", "é", None, ""],
            "o": [3, 1, 2, 5, 4, 2, 7, 8, 9, 1],
            "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0, None, 9.0, 10.0]}

    def build(f, df, _a):
        w = f.Window.partition_by("g")
        return df.select(f.col("g"), f.col("o"),
                         named(f, f.sum("v").over(w), "rs"),
                         named(f, f.count().over(w), "c"))
    same(*both(jax_session, data, build))


def test_window_with_column_and_expr(jax_session):
    def build(f, df, a):
        return df.with_column("pct", a.Divide(
            f.col("v"), f.sum("v").over(f.Window.partition_by("g"))))
    ref, got = both(jax_session, _data(), build)
    same(ref, got)
    assert list(got[0]) == ["g", "o", "v", "pct"]


def test_window_int_sum_types(jax_session):
    data = {"g": [1, 1, 2, 2], "o": [1, 2, 1, 2],
            "i": np.array([5, 6, 7, 8], dtype=np.int32)}

    def build(f, df, _a):
        w = f.Window.partition_by("g")
        return df.select(f.col("g"), named(f, f.sum("i").over(w), "s"),
                         named(f, f.count("*").over(w), "c"))
    ref, got = both(jax_session, data, build)
    same(ref, got)
    assert all(isinstance(r["s"], int) for r in got)


def test_window_sum_nan_inf_no_poison(jax_session):
    """A NaN or an infinity changes only its own partition's sum: NaN, or
    +inf with -inf, gives NaN."""
    d = {"g": [0, 0, 0, 1, 1, 2, 2, 3, 3], "o": list(range(9)),
         "v": [1.0, float("nan"), 2.0, float("inf"), 3.0, float("-inf"),
               float("inf"), 4.0, 5.0]}

    def build(f, df, _a):
        w = f.Window.partition_by("g")
        return df.select(f.col("g"), f.col("o"),
                         named(f, f.sum("v").over(w), "rs"),
                         named(f, f.avg("v").over(w), "ra"))
    ref, got = both(jax_session, d, build)
    same(ref, got)
    assert [r["rs"] for r in got][3:5] == [float("inf")] * 2
    assert [r["rs"] for r in got][7:] == [9.0, 9.0]


def test_double_date_and_null_keys_and_wrapping_sums(jax_session):
    """Double keys (-0.0 with 0.0, every NaN together, null apart), date
    keys, long sums that wrap, and a partition whose values are all
    null (its sum and average null, its count 0)."""
    rng = np.random.default_rng(5)
    n = 200
    pool = [0.0, -0.0, float("nan"), 1.5, None]
    first = datetime.date(1999, 2, 20)
    d = {"p": [pool[int(x)] for x in rng.integers(0, len(pool), n)],
         "day": [first + datetime.timedelta(days=int(x))
                 for x in rng.integers(0, 4, n)],
         "w": rng.integers(2 ** 62, 2 ** 63 - 1, n).astype(np.int64),
         "v": [None if x < 0.3 else float(x) for x in rng.random(n)]}
    d["v"] = [None if p == 1.5 else v for p, v in zip(d["p"], d["v"])]

    def build(f, df, _a):
        wp, wd = f.Window.partition_by("p"), f.Window.partition_by("day")
        return df.select(f.col("p"), f.col("day"), f.col("v"),
                         named(f, f.sum("w").over(wp), "sw"),
                         named(f, f.sum("v").over(wp), "sv"),
                         named(f, f.avg("v").over(wp), "av"),
                         named(f, f.count("v").over(wp), "cv"),
                         named(f, f.sum("w").over(wd), "dw"))
    ref, got = both(jax_session, d, build)
    same(ref, got)
    assert isinstance(got[0]["day"], datetime.date)
    empty = [r for r in got if r["p"] == 1.5]
    assert empty and all(r["sv"] is None and r["av"] is None and
                         r["cv"] == 0 for r in empty)


def test_window_refused_by_name():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(_data())
    # running and bounded ROWS frames run (tests/test_torch_window_frames
    # .py); a bounded RANGE frame and a min/max frame the JAX program does
    # not run are refused
    ranged = df.select(Alias(F.sum("v").over(
        F.Window.partition_by("g").order_by("o").range_between(-1, 1)),
        "r"))
    with pytest.raises(NotImplementedError,
                       match="RANGE BETWEEN 1 PRECEDING"):
        ranged.collect()
    reverse = df.select(Alias(F.max("v").over(
        F.Window.partition_by("g").order_by("o").rows_between(
            -1, F.Window.unboundedFollowing)), "r"))
    with pytest.raises(NotImplementedError, match="min/max"):
        reverse.collect()
    with pytest.raises(ValueError, match="filter"):
        df.filter(F.sum("v").over(F.Window.partition_by("g")))
    # over several partitions a hash exchange on the keys comes first
    parts = s.create_dataframe(_data(), num_partitions=2)
    one = s.create_dataframe(_data())

    def sums(frame):
        return sorted(r["a"] for r in frame.select(Alias(F.sum("v").over(
            F.Window.partition_by("g")), "a")).collect()
            if r["a"] is not None)
    assert sums(parts) == pytest.approx(sums(one), rel=1e-12)


def test_one_window_node_per_spec_and_no_sync():
    """Two functions of one spec share a window exec; a bare input needs
    no projection; the window itself reads nothing back to the host."""
    s = TorchSession(device="cpu")
    df = s.create_dataframe(_data()).select(
        F.col("g"), Alias(F.sum("v").over(F.Window.partition_by("g")), "a"),
        Alias(F.count().over(F.Window.partition_by("g")), "c"))
    plan = df.executed_plan()
    windows = []

    def visit(node):
        if isinstance(node, TorchWindowExec):
            windows.append(node)
        for c in node.children:
            visit(c)
    visit(plan)
    assert len(windows) == 1 and len(windows[0].window_cols) == 2
    assert windows[0].program.computed == []
    before = s.transfers.stats()["syncs"]
    df.collect()
    # K8's sort of an int key reads nothing; the download syncs once
    assert s.transfers.stats()["syncs"] - before == 1
