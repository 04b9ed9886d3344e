"""TPC-DS q3, q1, q7, q12, q16, q17v and q18 over tables cut into 2 and 3
partitions (the port's ``testing/tpcds.py partitioned_frames``, the JAX
package's ``register_tables`` rule: a table under 1000 rows stays whole)
on the port (TorchSession(device="cpu"), every kernel's plain version)
against the JAX package's sql(QUERIES[...]) on its CPU engine over
``register_tables(num_partitions=2 / 3)``, on the same generated tables
at sf 1 (at sf 0.02 every fact table has under 1000 rows and stays
whole, so nothing of a query's fact side would be exchanged).

- Each query's rows equal the JAX package's under
  rowcompare.rows_equal(approx_float=True) (keys and counts exact,
  averages and stddev_samp within 1e-6 relative), in order, and the
  port's own one-partition rows.  q17v is q17 with ``and sr_item_sk =
  cs_item_sk`` removed (ROADMAP queue 3).
- The plans go through the exchanges: q3 PARTIAL, a hash exchange on
  the string key and FINAL, then a range exchange before the sort; q16
  a count(DISTINCT) behind a raw-row exchange; q18 a rollup's PARTIAL and
  FINAL; q12 a window behind a hash exchange."""

import gc

import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import register_tables
from spark_rapids_tpu.testing.tpcds_queries import QUERIES
from spark_rapids_tpu_torch import TorchSession
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
    "q3": ("date_dim", "store_sales", "item"),
    "q1": ("date_dim", "store_returns", "store", "customer"),
    "q7": ("store_sales", "customer_demographics", "date_dim", "item",
           "promotion"),
    "q12": ("web_sales", "item", "date_dim"),
    "q16": ("catalog_sales", "date_dim", "customer_address", "call_center",
            "catalog_returns"),
    "q17v": ("store_sales", "store_returns", "catalog_sales", "date_dim",
             "store", "item"),
    "q18": ("catalog_sales", "customer_demographics", "customer",
            "customer_address", "date_dim", "item"),
}
ROWS = {"q3": 11, "q1": 100, "q7": 100, "q12": 44, "q16": 1, "q17v": 100,
        "q18": 100}
#: a piece of each query's physical plan over several partitions
PLANS = {"q3": ("TorchKeyedAggregate[partial",
                "HashPartitioning(d_year, i_brand_id, i_brand, 2)",
                "RangePartitioning", "TorchKeyedAggregate[final"),
         "q16": ("TorchKeyedAggregate[complete",),
         "q18": ("TorchExpand", "TorchKeyedAggregate[final"),
         "q12": ("TorchWindow", "HashPartitioning(i_class")}


def sql(query: str) -> str:
    if query == "q17v":
        return QUERIES["q17"].replace(" and sr_item_sk = cs_item_sk", "")
    return QUERIES[query]


def recipe(query: str):
    name = "q17" if query == "q17v" else query
    fn = getattr(tpcds, name)
    cut = getattr(tpcds, f"{name}_tables")
    kw = {"same_item": False} if query == "q17v" else {}
    return fn, cut, kw


@pytest.fixture(scope="module")
def tables():
    return tpcds.generate_tables(SF)


@pytest.fixture(scope="module")
def jax_rows():
    rows = {}
    for parts in (2, 3):
        s = TpuSession({"spark.rapids.sql.enabled": "false"})
        register_tables(s, sf=SF, num_partitions=parts,
                        tables={t for ts in TABLES.values() for t in ts})
        for q in TABLES:
            rows[(q, parts)] = s.sql(sql(q)).collect()
    return rows


def run(tables, query: str, parts: int, explain: bool = False):
    fn, cut, kw = recipe(query)
    frames = tpcds.partitioned_frames(TorchSession(device="cpu"),
                                      cut(tables), TABLES[query], parts)
    df = fn(*frames, **kw)[0]
    return df.explain() if explain else df.collect()


@pytest.mark.parametrize("parts", [2, 3])
@pytest.mark.parametrize("query", list(TABLES))
def test_query_over_partitions_matches_jax_sql(tables, jax_rows, query,
                                               parts):
    got = run(tables, query, parts)
    ref = jax_rows[(query, parts)]
    assert len(got) == len(ref) == ROWS[query]
    assert rows_equal(ref, got, check_order=True,
                      approx_float=True) is None, (ref, got)
    one = run(tables, query, 1)
    assert rows_equal(one, got, check_order=True,
                      approx_float=True) is None


@pytest.mark.parametrize("query", list(PLANS))
def test_plans_exchange(tables, query):
    text = run(tables, query, 2, explain=True)
    for piece in PLANS[query]:
        assert piece in text, (piece, text)
    assert "TorchExchange" in text
