"""TPC-DS q15, q12 and q20 on the port (TorchSession(device="cpu"), every
kernel's plain version) against the JAX package's sql(QUERIES[...]) on
its CPU engine (``spark.rapids.sql.enabled`` false: the numpy engine the
north star names as the reference side; tests/test_tpcds.py holds it
equal to the JAX device path), on the same generated tables at sf 1.

- Each recipe of spark_rapids_tpu_torch/testing/tpcds.py equals the JAX
  package's rows in order under rowcompare.rows_equal(approx_float=True)
  (keys exact, sums and ratios within 1e-6 relative: the engines add in
  other orders), with 30 (q15), 44 (q12) and 100 (q20) rows, as the JAX
  package gives them, and equals the numpy version of the query.
- q12's plan has one window exec over the keyed aggregate, and its share
  is a computing projection (K6) over the window's column.
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
    "q15": ("catalog_sales", "customer", "customer_address", "date_dim"),
    "q12": ("web_sales", "item", "date_dim"),
    "q20": ("catalog_sales", "item", "date_dim"),
}
RECIPES = {
    "q15": (tpcds.q15, tpcds.q15_tables, tpcds.q15_numpy),
    "q12": (tpcds.q12, tpcds.q12_tables, tpcds.q12_numpy),
    "q20": (lambda *dfs: tpcds.q12(*dfs, prefix="cs"), tpcds.q20_tables,
            tpcds.q20_numpy),
}
ROWS = {"q15": 30, "q12": 44, "q20": 100}


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
    cut = RECIPES[query][1](tables)
    return [session.create_dataframe(cut[t]) for t in TABLES[query]]


@pytest.mark.parametrize("query", list(TABLES))
def test_query_matches_jax_sql_and_numpy(tables, jax_rows, query):
    recipe, cut, numpy_query = RECIPES[query]
    got = recipe(*frames(TorchSession(device="cpu"), tables, query))[0] \
        .collect()
    assert len(got) == ROWS[query] == len(jax_rows[query])
    assert rows_equal(jax_rows[query], got, check_order=True,
                      approx_float=True) is None
    assert rows_equal(numpy_query(cut(tables)), got, check_order=True,
                      approx_float=True) is None


def test_q12_plans_a_window_over_the_group_by(tables):
    out = tpcds.q12(*frames(TorchSession(device="cpu"), tables, "q12"))[0]
    tree = out.executed_plan().tree_string()
    assert tree.count("TorchWindow[") == 1
    assert "TorchFusedProject(P[i_item_id" in tree
    assert "TorchKeyedAggregate[complete, keys=[i_item_id, i_item_desc, " \
        "i_category, i_class, i_current_price]" in tree
    q15 = tpcds.q15(*frames(TorchSession(device="cpu"), tables, "q15"))[0]
    assert "IN ('85669'" in q15.executed_plan().tree_string()


# q15: the date compaction, three join sizes, the chars totals of ca_state
# and ca_zip behind the address join and again behind the date join (one
# read each), the filter's survivors, the group count, the sort key's
# longest length, the download.  q12 and q20: the item and date
# compactions, two join sizes, the chars totals of the four item strings
# behind each join (one read each), the group count, the window key's
# longest length (K8), the four string sort keys' longest lengths (one
# read), the download.  K14 reads nothing back.
@pytest.mark.parametrize("query,syncs", [("q15", 10), ("q12", 10),
                                         ("q20", 10)])
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
