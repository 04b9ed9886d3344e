"""TPC-DS q3 on the port (TorchSession(device="cpu"), every kernel's plain
version) against the JAX package on its CPU engine
(``spark.rapids.sql.enabled`` false: the numpy engine the north star
names as the reference side; tests/test_tpcds.py holds it equal to the
JAX device path), on the same generated tables.

- The port's copy of the generator (spark_rapids_tpu_torch/testing/
  tpcds.py) gives the JAX generator's arrays, column by column, on every
  table q3, q1 and q7 read.
- q3 through the port's DataFrame API (join, group_by, agg, order_by,
  limit) equals the JAX package's sql(QUERIES["q3"]) in order, under
  rowcompare.rows_equal(approx_float=True): keys exact, sums within 1e-6
  relative (the engines add in other orders).  At sf 5 it has 47 rows;
  smaller scales leave no item with i_manufact_id = 128.
- With the item filter and the limit dropped, the join, the string group
  key and the sort see ten thousand rows; the same recipe runs on the JAX
  package's DataFrames."""

import gc
import importlib

import numpy as np
import pytest

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import generate_tables as jax_generate
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


SF = 5
TABLES = ("date_dim", "store_sales", "item")


@pytest.fixture(scope="module")
def tables():
    return tpcds.q3_tables(tpcds.generate_tables(SF))


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "false"})


def port_frames(session, tables):
    return [session.create_dataframe(tables[t]) for t in TABLES]


def test_generator_copy_matches_jax():
    mine = tpcds.generate_tables(0.2)
    ref = jax_generate(0.2)
    assert mine.keys() == ref.keys()
    # q3's tables, then the others q1, q7, q15, q12 and q20 read (every
    # column: customer's c_current_addr_sk, item's i_item_desc,
    # i_category, i_class and i_current_price, date_dim's d_date and
    # d_qoy among them)
    for t in TABLES + ("store_returns", "customer", "store",
                       "customer_demographics", "promotion",
                       "catalog_sales", "web_sales", "customer_address"):
        assert mine[t].keys() == ref[t].keys()
        for c in ref[t]:
            assert mine[t][c].dtype == ref[t][c].dtype, (t, c)
            assert np.array_equal(mine[t][c], ref[t][c]), (t, c)


def test_q3_matches_jax_sql(tables):
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    register_tables(s, sf=SF, num_partitions=1, tables=set(TABLES))
    ref = s.sql(QUERIES["q3"]).collect()
    got = tpcds.q3(*port_frames(TorchSession(device="cpu"), tables))[0] \
        .collect()
    assert len(got) >= 10
    assert rows_equal(ref, got, check_order=True, approx_float=True) \
        is None
    assert rows_equal(tpcds.q3_numpy(tables), got, check_order=True,
                      approx_float=True) is None


def jax_q3(date_dim, store_sales, item, manufact_id=128, limit=100):
    """The port's q3 recipe on the JAX package's DataFrames."""
    F = importlib.import_module("spark_rapids_tpu.functions")
    B = importlib.import_module("spark_rapids_tpu.expressions.base")
    P = importlib.import_module("spark_rapids_tpu.expressions.predicates")
    col, lit, Alias = B.col, B.lit, B.Alias
    dt = date_dim.filter(P.EqualTo(col("d_moy"), lit(11)))
    ss = store_sales.select(Alias(col("ss_sold_date_sk"), "d_date_sk"),
                            col("ss_item_sk"), col("ss_ext_sales_price"))
    it = item if manufact_id is None else \
        item.filter(P.EqualTo(col("i_manufact_id"), lit(manufact_id)))
    it = it.select(Alias(col("i_item_sk"), "ss_item_sk"), col("i_brand_id"),
                   col("i_brand"))
    out = (dt.join(ss, on="d_date_sk").join(it, on="ss_item_sk")
           .group_by("d_year", "i_brand_id", "i_brand")
           .agg(F.sum("ss_ext_sales_price").alias("sum_agg"))
           .select(col("d_year"), Alias(col("i_brand_id"), "brand_id"),
                   Alias(col("i_brand"), "brand"), col("sum_agg"))
           .order_by("d_year", F.desc("sum_agg"), "brand_id"))
    return out if limit is None else out.limit(limit)


@pytest.mark.parametrize("limit", [None, 100])
def test_q3_without_the_item_filter_matches_jax(jax_session, tables, limit):
    ref = jax_q3(*[jax_session.create_dataframe(tables[t]) for t in TABLES],
                 manufact_id=None, limit=limit).collect()
    got = tpcds.q3(*port_frames(TorchSession(device="cpu"), tables),
                   manufact_id=None, limit=limit)[0].collect()
    assert len(got) == len(ref) == (limit or len(ref)) and len(ref) >= 100
    if limit is None:
        assert len(ref) > 5000
    assert rows_equal(ref, got, check_order=True, approx_float=True) \
        is None


def test_q3_plan_syncs_and_builds(tables):
    s = TorchSession(device="cpu")
    frames = port_frames(s, tables)
    out = tpcds.q3(*frames)[0]
    text = out.explain()
    for node in ("TorchLimit[100]", "TorchSort[d_year ASC",
                 "TorchKeyedAggregate[complete, keys=[d_year, i_brand_id, "
                 "i_brand]", "TorchHashJoin[inner", "TorchSelect[",
                 "TorchFusedStage(F[(d_moy = $lit0"):
        assert node in text, text
    assert text.count("TorchHashJoin") == 2
    assert text.count("TorchFusedStage") == 2
    first = out.collect()
    built = stage_compiler.stats()["builds"]
    before = s.transfers.stats()
    again = tpcds.q3(*frames)[0].collect()
    after = s.transfers.stats()
    assert again == first
    assert stage_compiler.stats()["builds"] == built
    # two compactions, two join sizes, one string gather behind the second
    # join, the group count, the download
    assert after["syncs"] - before["syncs"] == 7
    # the tables stay on the device: only the date filter's literal goes up
    assert after["h2d_copies"] - before["h2d_copies"] == 1
