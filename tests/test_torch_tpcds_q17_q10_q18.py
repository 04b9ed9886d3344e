"""TPC-DS q17, q10 and q18 on the port (TorchSession(device="cpu"), every
kernel's plain version) against the JAX package's sql(QUERIES[...]) on
its CPU engine (``spark.rapids.sql.enabled`` false: the numpy engine the
north star names as the reference side; tests/test_tpcds.py holds it
equal to the JAX device path), on the same generated tables at sf 1.

- Each recipe of spark_rapids_tpu_torch/testing/tpcds.py equals the JAX
  package's rows in order under rowcompare.rows_equal(approx_float=True)
  (keys and counts exact, averages and stddev_samp within 1e-6
  relative: the engines add in other orders), and equals the numpy
  version.
- q17 as written gives no row on this generator (catalog_sales draws its
  customer and item apart, so the second join's two keys meet about six
  times and the date filters drop those); with the conjunct
  `` and sr_item_sk = cs_item_sk`` removed from the SQL and from the
  recipe (``same_item=False``) it gives 100 rows, some with a
  stddev_samp.  q10 gives 100 rows; q18 100, the grand total first.
- The plans: q17 joins on three and two key columns, q10 plans a semi
  join and two existence-marker left joins over distinct customers, q18
  an Expand of five grouping sets into a keyed aggregate.
- A repeated query builds nothing, and its syncs are counted."""

import gc

import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import register_tables
from spark_rapids_tpu.testing.tpcds_queries import QUERIES
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.exec import stage_compiler
from spark_rapids_tpu_torch.exec.aggregate import TorchKeyedAggregateExec
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


SF = 1
TABLES = {
    "q17": ("store_sales", "store_returns", "catalog_sales", "date_dim",
            "store", "item"),
    "q10": ("customer", "customer_address", "customer_demographics",
            "store_sales", "web_sales", "catalog_sales", "date_dim"),
    "q18": ("catalog_sales", "customer_demographics", "customer",
            "customer_address", "date_dim", "item"),
}
#: the one conjunct the q17 variant drops from the SQL
Q17_ITEM = " and sr_item_sk = cs_item_sk"
#: (query, the q17 variant): rows
CASES = {("q17", False): 0, ("q17", True): 100, ("q10", False): 100,
         ("q18", False): 100}


def q17_variant_sql() -> str:
    sql = QUERIES["q17"]
    assert sql.count(Q17_ITEM) == 1
    return sql.replace(Q17_ITEM, "")


@pytest.fixture(scope="module")
def tables():
    return tpcds.generate_tables(SF)


@pytest.fixture(scope="module")
def jax_rows():
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    register_tables(s, sf=SF, num_partitions=1,
                    tables={t for ts in TABLES.values() for t in ts})
    rows = {(q, False): s.sql(QUERIES[q]).collect() for q in TABLES}
    rows[("q17", True)] = s.sql(q17_variant_sql()).collect()
    return rows


def frames(session, tables, query):
    cut = getattr(tpcds, f"{query}_tables")(tables)
    return [session.create_dataframe(cut[t]) for t in TABLES[query]]


def kwargs(query, variant):
    return {"same_item": False} if variant else {}


@pytest.mark.parametrize("query,variant", list(CASES))
def test_query_matches_jax_sql_and_numpy(tables, jax_rows, query, variant):
    kw = kwargs(query, variant)
    recipe = getattr(tpcds, query)
    got = recipe(*frames(TorchSession(device="cpu"), tables, query),
                 **kw)[0].collect()
    ref = jax_rows[(query, variant)]
    assert len(got) == CASES[(query, variant)] == len(ref)
    assert rows_equal(ref, got, check_order=True,
                      approx_float=True) is None, (ref, got)
    numpy_rows = getattr(tpcds, f"{query}_numpy")(
        getattr(tpcds, f"{query}_tables")(tables), **kw)
    assert rows_equal(numpy_rows, got, check_order=True,
                      approx_float=True) is None
    if query == "q17" and variant:
        sd = [r["store_sales_quantitystdev"] for r in got]
        assert any(x is not None for x in sd) and None in sd
    if query == "q18":
        assert all(got[0][k] is None for k in tpcds.Q18_KEYS)
        assert got[1]["i_item_id"] is not None and \
            got[1]["ca_country"] is None


def keyed_aggregates(node):
    if isinstance(node, TorchKeyedAggregateExec):
        yield node
    for c in node.children:
        yield from keyed_aggregates(c)


def test_plans_route_as_the_jax_plan_does(tables):
    s = TorchSession(device="cpu")
    q17 = tpcds.q17(*frames(s, tables, "q17"))[0].executed_plan()
    tree = q17.tree_string()
    assert "ss_customer_sk = ss_customer_sk, ss_item_sk = ss_item_sk, " \
        "ss_ticket_number = ss_ticket_number]" in tree
    assert "ss_customer_sk = ss_customer_sk, ss_item_sk = ss_item_sk]" \
        in tree
    # nine aggregates in nine K9 slots (each quantity's count, sum and
    # m2: count, avg and stddev_samp share the count), then K6's finish
    agg, = keyed_aggregates(q17)
    assert len(agg.layout.aggs) == 9 and len(agg.inputs) == 9
    assert agg.finish is not None
    q10 = tpcds.q10(*frames(s, tables, "q10"))[0].executed_plan()
    tree = q10.tree_string()
    assert tree.count("TorchHashJoin[left_semi") == 1
    assert tree.count("TorchHashJoin[left_outer") == 2
    distinct = [a for a in keyed_aggregates(q10) if not a.layout.aggs]
    assert len(distinct) == 2
    agg = [a for a in keyed_aggregates(q10) if a.layout.aggs]
    assert len(agg) == 1 and agg[0].layout.num_keys == 8
    assert len(agg[0].inputs) == 1 and agg[0].finish is None
    q18 = tpcds.q18(*frames(s, tables, "q18"))[0].executed_plan()
    tree = q18.tree_string()
    assert "TorchExpand[5 projections]" in tree
    assert "keys=[i_item_id, ca_country, ca_state, ca_county, " \
        "__grouping_id]" in tree


# q17: three compactions (its three date copies), seven join sizes,
# three chars totals (gathers that move strings and may repeat rows), the
# group count, the sort's string keys' longest lengths (one read), the
# download.  q10: five compactions (the addresses, the dates three times,
# the filter m1 OR m2), eight join sizes, three chars totals, three group
# counts (the two distinct customer sets, the group-by), the sort's
# lengths, the download.  q18: four compactions (dates, cd1, customers,
# addresses), six join sizes, three chars totals, the group count over the
# five grouping sets (K7c reads nothing back), the sort's lengths, the
# download.
SYNCS = {"q17": 16, "q10": 21, "q18": 16}


@pytest.mark.parametrize("query", ["q17", "q10", "q18"])
def test_repeated_query_builds_nothing(tables, query):
    s = TorchSession(device="cpu")
    fs = frames(s, tables, query)
    recipe = getattr(tpcds, query)
    kw = kwargs(query, query == "q17")
    first = recipe(*fs, **kw)[0].collect()
    built = stage_compiler.stats()["builds"]
    before = s.transfers.stats()
    assert recipe(*fs, **kw)[0].collect() == first
    after = s.transfers.stats()
    assert stage_compiler.stats()["builds"] == built
    assert after["syncs"] - before["syncs"] == SYNCS[query]

