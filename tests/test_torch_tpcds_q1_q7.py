"""TPC-DS q1 and q7 on the port (TorchSession(device="cpu"), every kernel's
plain version) against the JAX package's sql(QUERIES["q1"]) and
sql(QUERIES["q7"]) on its CPU engine (``spark.rapids.sql.enabled``
false: the numpy engine the north star names as the reference side;
tests/test_tpcds.py holds it equal to the JAX device path), on the same
generated tables at sf 1.

- Each recipe of spark_rapids_tpu_torch/testing/tpcds.py equals the JAX
  package's rows in order under rowcompare.rows_equal(approx_float=True)
  (keys exact, averages within 1e-6 relative: the engines add in other
  orders), with 100 rows, and equals the numpy version of the query.
- q1's customer_total_return CTE runs once per collect() through
  TorchCteCacheExec, and again at the next collect().
- A repeated query builds nothing, and its syncs are counted."""

import gc

import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import register_tables
from spark_rapids_tpu.testing.tpcds_queries import QUERIES
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.exec import stage_compiler
from spark_rapids_tpu_torch.exec.basic import TorchCteCacheExec
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
Q1_TABLES = ("date_dim", "store_returns", "store", "customer")
Q7_TABLES = ("store_sales", "customer_demographics", "date_dim", "item",
             "promotion")


@pytest.fixture(scope="module")
def tables():
    return tpcds.generate_tables(SF)


@pytest.fixture(scope="module")
def jax_rows():
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    register_tables(s, sf=SF, num_partitions=1,
                    tables=set(Q1_TABLES + Q7_TABLES))
    return {q: s.sql(QUERIES[q]).collect() for q in ("q1", "q7")}


def frames(session, tables, query):
    if query == "q1":
        t = tpcds.q1_tables(tables)
        return [session.create_dataframe(t[n]) for n in Q1_TABLES]
    t = tpcds.q7_tables(tables)
    return [session.create_dataframe(t[n]) for n in Q7_TABLES]


RECIPES = {"q1": (tpcds.q1, tpcds.q1_tables, tpcds.q1_numpy),
           "q7": (tpcds.q7, tpcds.q7_tables, tpcds.q7_numpy)}


@pytest.mark.parametrize("query", ["q1", "q7"])
def test_query_matches_jax_sql_and_numpy(tables, jax_rows, query):
    recipe, cut, numpy_query = RECIPES[query]
    got = recipe(*frames(TorchSession(device="cpu"), tables, query))[0] \
        .collect()
    assert len(got) == 100
    assert rows_equal(jax_rows[query], got, check_order=True,
                      approx_float=True) is None
    assert rows_equal(numpy_query(cut(tables)), got, check_order=True,
                      approx_float=True) is None


def cte_execs(plan):
    found = []

    def visit(node):
        if isinstance(node, TorchCteCacheExec) and \
                all(node is not f for f in found):
            found.append(node)
        for c in node.children:
            visit(c)
    visit(plan)
    return found


def test_q1_cte_runs_once_per_collect(tables):
    s = TorchSession(device="cpu")
    out = tpcds.q1(*frames(s, tables, "q1"))[0]
    plan = out.executed_plan()
    ctes = cte_execs(plan)
    # one exec, read by the join chain and by the average by store
    assert len(ctes) == 1
    assert plan.tree_string().count("TorchCteCache") == 2
    from spark_rapids_tpu_torch.plan.base import ExecContext
    for epoch in (1, 2):
        parts = plan.execute(ExecContext(s.device, s.transfers))
        assert len(parts) == 1 and ctes[0].runs == epoch
    assert "TorchFusedProject(P[ctr_store_sk, (avg_return * $lit0" in \
        plan.tree_string()
    assert "TorchHashJoin[left_outer, ctr_store_sk = ctr_store_sk]" in \
        plan.tree_string()


# q1: the date and state compactions, four join sizes, the chars totals of
# c_customer_id gathered behind the customer and the outer joins, two group
# counts, the filter's survivors, the sort key's longest length, the
# download.  q7: three compactions, four join sizes, the chars totals of
# i_item_id behind the item and the promotion joins, the group count, the
# sort key's longest length, the download.
@pytest.mark.parametrize("query,syncs", [("q1", 13), ("q7", 12)])
def test_repeated_query_builds_nothing(tables, query, syncs):
    s = TorchSession(device="cpu")
    fs = frames(s, tables, query)
    recipe = RECIPES[query][0]
    first = recipe(*fs)[0].collect()
    built = stage_compiler.stats()["builds"]
    before = s.transfers.stats()
    assert recipe(*fs)[0].collect() == first
    after = s.transfers.stats()
    assert stage_compiler.stats()["builds"] == built
    assert after["syncs"] - before["syncs"] == syncs
