"""TPC-DS q51 on the port (TorchSession(device="cpu"), every kernel's
plain version) against the JAX package's ``sql(Q51_SQL)`` on its CPU
engine over ``register_tables`` at sf 1, at 1, 2 and 3 partitions, and
against ``q51_numpy``.

- The recipe (spark_rapids_tpu_torch/testing/tpcds.py q51) equals the
  JAX rows in order under rowcompare.rows_equal(approx_float=True): the
  items, dates and the 100 rows exact, the cumulative sums within 1e-6
  relative (the engines add in other orders, which round the last bits
  of a cumulative sum apart).
  The JAX engine types the date CASE as a timestamp at midnight UTC
  (ROADMAP queue 3); the test reads it back as the date.
- The plan: the two running sums and the two running maxima are K14s
  frames, the full outer join is K10f's mode, both CASE columns and
  the filter compute in K6 and K5.
- A repeated query builds nothing, and its syncs are counted."""

import datetime
import gc

import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import register_tables
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.exec import stage_compiler
from spark_rapids_tpu_torch.exec.joins import FULL_OUTER, TorchHashJoinExec
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
from spark_rapids_tpu_torch.ops import window_ops as W
from spark_rapids_tpu_torch.testing import tpcds


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


SF = 1
NAMES = ("web_sales", "store_sales", "date_dim")


@pytest.fixture(scope="module")
def tables():
    return tpcds.q51_tables(tpcds.generate_tables(SF))


def jax_rows(parts):
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    register_tables(s, sf=SF, num_partitions=parts, tables=set(NAMES))
    rows = s.sql(tpcds.Q51_SQL).collect()
    for r in rows:
        if isinstance(r["d_date"], datetime.datetime):
            r["d_date"] = r["d_date"].date()
    return rows


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_q51_matches_jax_sql_and_numpy(tables, parts):
    s = TorchSession(device="cpu")
    got = tpcds.q51(*tpcds.partitioned_frames(s, tables, NAMES,
                                              parts))[0].collect()
    ref = jax_rows(parts)
    assert len(got) == len(ref) == 100
    assert rows_equal(ref, got, check_order=True, approx_float=True) \
        is None, (ref, got)
    assert rows_equal(tpcds.q51_numpy(tables), got, check_order=True,
                      approx_float=True) is None
    assert all(isinstance(r["d_date"], datetime.date) for r in got)
    assert all(r["web_cumulative"] > r["store_cumulative"] for r in got)
    assert any(r["web_sales"] is None for r in got) and \
        any(r["store_sales"] is None for r in got)


def nodes(node):
    yield node
    for c in node.children:
        yield from nodes(c)


def test_plan_routes_frames_and_the_full_join(tables):
    s = TorchSession(device="cpu")
    q51 = tpcds.q51(*[s.create_dataframe(tables[n]) for n in NAMES])[0]
    plan = q51.executed_plan()
    windows = [n for n in nodes(plan) if isinstance(n, TorchWindowExec)]
    assert len(windows) == 3
    kinds = [k for w in windows for k, _e in w.lowered]
    assert all(isinstance(k, W.FrameAgg) and not k.bounded and
               k.running_form() == (0, W.TAKE_ROWS, 0) for k in kinds)
    assert sorted(k.kind for k in kinds) == sorted(
        [W.WIN_SUM_F64] * 2 + [W.WIN_MAX] * 2)
    join, = [n for n in nodes(plan) if isinstance(n, TorchHashJoinExec)
             and n.how == FULL_OUTER]
    assert len(join.left_keys) == 2 and not join.coalesce_keys


def test_repeated_query_builds_nothing(tables):
    """Syncs of q51: the two date compactions, the two ``IS NOT NULL``
    compactions, the two date joins' sizes, the two group counts, the
    full join's one read (pairs and unmatched rows together), the
    filter's compaction and the download: 11."""
    s = TorchSession(device="cpu")
    fs = [s.create_dataframe(tables[n]) for n in NAMES]
    first = tpcds.q51(*fs)[0].collect()
    built = stage_compiler.stats()["builds"]
    before = s.transfers.stats()
    assert tpcds.q51(*fs)[0].collect() == first
    after = s.transfers.stats()
    assert stage_compiler.stats()["builds"] == built
    assert after["syncs"] - before["syncs"] == 11
