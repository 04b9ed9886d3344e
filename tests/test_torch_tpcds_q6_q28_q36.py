"""TPC-DS q6, q28 and q36 on the port (TorchSession(device="cpu"), every
kernel's plain version) against the JAX package's sql(QUERIES[...]) on
its CPU engine (``spark.rapids.sql.enabled`` false: the numpy engine the
north star names as the reference side; tests/test_tpcds.py holds it
equal to the JAX device path), on the same generated tables at sf 1.

- Each recipe of spark_rapids_tpu_torch/testing/tpcds.py equals the JAX
  package's rows in order under rowcompare.rows_equal(approx_float=True)
  (keys, counts and ranks exact; averages, sums and their ratio within
  1e-6 relative: the engines add in other orders), and equals the numpy
  version: q6 10 rows, q28 1, q36 100.
- The plans: q6 runs its month subquery eagerly (``DataFrame.scalar``)
  and joins on the string key ``i_category`` (left outer, K10); q28
  cross-joins six global aggregates (five
  TorchBroadcastNestedLoopJoinExec, K10x); q36 ranks within a rollup's
  parents (a ranking window over an ORDER BY with computed keys, K14's
  ranking pass) and sorts by a CASE WHEN (K6's string view).
- A repeated query builds nothing, and its syncs are counted."""

import gc

import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import register_tables
from spark_rapids_tpu.testing.tpcds_queries import QUERIES
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.exec import stage_compiler
from spark_rapids_tpu_torch.exec.joins import (
    TorchBroadcastNestedLoopJoinExec, TorchHashJoinExec)
from spark_rapids_tpu_torch.exec.sort import TorchSortExec
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
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
TABLES = {
    "q6": ("customer_address", "customer", "store_sales", "date_dim",
           "item"),
    "q28": ("store_sales",),
    "q36": ("store_sales", "date_dim", "item", "store"),
}
ROWS = {"q6": 10, "q28": 1, "q36": 100}


@pytest.fixture(scope="module")
def tables():
    return tpcds.generate_tables(SF)


@pytest.fixture(scope="module")
def jax_rows():
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    register_tables(s, sf=SF, num_partitions=1,
                    tables={t for ts in TABLES.values() for t in ts})
    return {q: s.sql(QUERIES[q]).collect() for q in TABLES}


def frames(session, tables, query):
    cut = getattr(tpcds, f"{query}_tables")(tables)
    return [session.create_dataframe(cut[t]) for t in TABLES[query]]


@pytest.mark.parametrize("query", list(TABLES))
def test_query_matches_jax_sql_and_numpy(tables, jax_rows, query):
    got = getattr(tpcds, query)(*frames(TorchSession(device="cpu"),
                                        tables, query))[0].collect()
    ref = jax_rows[query]
    assert len(got) == ROWS[query] == len(ref)
    assert rows_equal(ref, got, check_order=True,
                      approx_float=True) is None, (ref, got)
    numpy_rows = getattr(tpcds, f"{query}_numpy")(
        getattr(tpcds, f"{query}_tables")(tables))
    assert rows_equal(numpy_rows, got, check_order=True,
                      approx_float=True) is None
    if query == "q36":
        # the grand total, then the categories, then the classes
        assert [r["lochierarchy"] for r in got[:2]] == [2, 1]
        assert {r["rank_within_parent"] for r in got} >= {1, 2, 3}


def nodes(node):
    yield node
    for c in node.children:
        yield from nodes(c)


def test_plans_route_as_the_jax_plan_does(tables):
    s = TorchSession(device="cpu")
    q6, parts = tpcds.q6(*frames(s, tables, "q6"))
    assert parts["month"] == 1212
    joins = [n for n in nodes(q6.executed_plan())
             if isinstance(n, TorchHashJoinExec)]
    strings = [j for j in joins if
               [k.data_type for k in j.left_keys] == [T.STRING]]
    assert len(joins) == 5 and len(strings) == 1
    assert strings[0].how == "left_outer"
    q28 = tpcds.q28(*frames(s, tables, "q28"))[0].executed_plan()
    crosses = [n for n in nodes(q28)
               if isinstance(n, TorchBroadcastNestedLoopJoinExec)]
    assert len(crosses) == 5
    q36 = tpcds.q36(*frames(s, tables, "q36"))[0].executed_plan()
    window, = [n for n in nodes(q36) if isinstance(n, TorchWindowExec)]
    assert window.orders == [(True, True)] and \
        len(window.partition_exprs) == 2
    assert window.program.computed   # the CASE key and the ratio: K6
    sort, = [n for n in nodes(q36) if isinstance(n, TorchSortExec)]
    assert sort.keys.computed        # the CASE sort key: K6


# q6: the subquery (its date compaction, the distinct's group count, its
# download), the month's dates, five join sizes, five chars totals
# (gathers that move ca_state or i_category and may repeat rows), the
# category averages' and the states' group counts, the HAVING
# compaction, the sort's string key length, the download.  q28: one
# compaction per bucket (K1, K3 and K15d read nothing back; the cross
# joins are sized on the host), the download.  q36: the dates and the
# stores compactions, three join sizes, two chars totals, the rollup's
# group count, the window's and the sort's string key lengths (the CASE
# views), the download.
SYNCS = {"q6": 20, "q28": 7, "q36": 11}


@pytest.mark.parametrize("query", list(TABLES))
def test_repeated_query_builds_nothing(tables, query):
    s = TorchSession(device="cpu")
    fs = frames(s, tables, query)
    recipe = getattr(tpcds, query)
    first = recipe(*fs)[0].collect()
    built = stage_compiler.stats()["builds"]
    before = s.transfers.stats()
    assert recipe(*fs)[0].collect() == first
    after = s.transfers.stats()
    assert stage_compiler.stats()["builds"] == built
    assert after["syncs"] - before["syncs"] == SYNCS[query]
