"""TPC-DS q35 and q35v on the port (TorchSession(device="cpu"), every
kernel's plain version) against the JAX package's sql(QUERIES["q35"]) on
its CPU engine (``spark.rapids.sql.enabled`` false, the reference side
the north star names), on the same generated tables at sf 1, at 1 and 2
partitions.

- q35 as written keeps no row: its ``d_year = 2002`` finds no date, the
  generator's ``date_dim`` ending in 2001.  q35v is the same text with
  ``d_year = 2001`` (each of its three subqueries), as q17v drops one
  conjunct of q17, and gives 100 rows.
- Each equals the JAX package's rows in order under
  rowcompare.rows_equal(approx_float=True) (keys, counts, mins and maxes
  exact, averages within 1e-6 relative), and numpy's.
- The plans: one 6-key group-by whose count(*) is one K9 slot and whose
  min, max and avg of the three dependant counts are K9's min and max
  kinds, a double sum and a count; at 2 partitions PARTIAL, a hash
  exchange and FINAL, which merges through K9's min and max kinds."""

import gc

import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import register_tables
from spark_rapids_tpu.testing.tpcds_queries import QUERIES
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.exec.aggregate import TorchKeyedAggregateExec
from spark_rapids_tpu_torch.ops import agg_ops as G
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
    threads in each pytest worker makes them contend for the cores.  This
    module runs on one thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 1
TABLES = ("customer", "customer_address", "customer_demographics",
          "store_sales", "web_sales", "catalog_sales", "date_dim")
#: the year of each query: q35 as written, and q35v
YEARS = {"q35": 2002, "q35v": 2001}
ROWS = {"q35": 0, "q35v": 100}


def sql(query: str) -> str:
    text = QUERIES["q35"]
    if query == "q35":
        return text
    assert text.count("d_year = 2002") == 3
    return text.replace("d_year = 2002", "d_year = 2001")


@pytest.fixture(scope="module")
def tables():
    return tpcds.generate_tables(SF)


@pytest.fixture(scope="module")
def jax_rows():
    rows = {}
    for parts in (1, 2):
        s = TpuSession({"spark.rapids.sql.enabled": "false"})
        register_tables(s, sf=SF, num_partitions=parts, tables=set(TABLES))
        for q in YEARS:
            rows[(q, parts)] = s.sql(sql(q)).collect()
    return rows


def run(tables, query: str, parts: int):
    frames = tpcds.partitioned_frames(TorchSession(device="cpu"),
                                      tpcds.q35_tables(tables), TABLES, parts)
    return tpcds.q35(*frames, year=YEARS[query])[0]


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("query", list(YEARS))
def test_q35_matches_jax_sql_and_numpy(tables, jax_rows, query, parts):
    got = run(tables, query, parts).collect()
    ref = jax_rows[(query, parts)]
    assert len(got) == len(ref) == ROWS[query]
    assert rows_equal(ref, got, check_order=True,
                      approx_float=True) is None, (ref, got)
    numpy_rows = tpcds.q35_numpy(tpcds.q35_tables(tables),
                                 year=YEARS[query])
    assert rows_equal(numpy_rows, got, check_order=True,
                      approx_float=True) is None


def keyed_aggregates(node):
    if isinstance(node, TorchKeyedAggregateExec):
        yield node
    for c in node.children:
        yield from keyed_aggregates(c)


def test_plans_fold_min_and_max_in_k9(tables):
    one = [a for a in keyed_aggregates(
        run(tables, "q35v", 1).executed_plan()) if a.layout.aggs]
    assert len(one) == 1 and one[0].layout.num_keys == 6
    kinds = [kind for _o, kind, _dt in one[0].inputs]
    # count(*) once; per dependant count its min, max, double sum, count
    assert kinds.count(G.KEYED_COUNT_ALL) == 1
    assert kinds.count(G.KEYED_MIN) == kinds.count(G.KEYED_MAX) == 3
    assert len(kinds) == 13
    two = [a for a in keyed_aggregates(
        run(tables, "q35v", 2).executed_plan()) if a.layout.aggs]
    modes = sorted(a.mode for a in two)
    assert modes == ["final", "partial"]
    final, = [a for a in two if a.mode == "final"]
    merged = [kind for _o, kind, _a in final.merges]
    assert merged.count(G.KEYED_MIN) == merged.count(G.KEYED_MAX) == 3
