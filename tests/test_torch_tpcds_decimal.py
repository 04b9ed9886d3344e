"""TPC-DS q3, q19 and q7 over DECIMAL(7,2) money ("q3d", "q19d", "q7d")
on the port (TorchSession(device="cpu"), every kernel's plain version)
against the JAX package's ``sql(QUERIES[...])`` on its CPU engine
(``spark.rapids.sql.enabled`` false), at sf 1, at 1 and 2 partitions.

- Both engines read the same tables: the port generator's columns, each
  money column (``tpcds.MONEY_COLUMNS``) as DECIMAL(7,2) cents
  (``tpcds.decimal_money``), handed to the JAX package as
  ``pa.decimal128(7, 2)`` arrays of the same cents.
- q3d and q19d read money only through ``sum`` and ``ORDER BY ... desc``
  (no cast, no comparison: ROADMAP queue 3's faults stay out of the
  reference's way); their rows equal the JAX rows in order, exactly, and
  numpy's, and their sums are decimal(17,2).
- q7d's three money averages meet fault 2 (``avg`` of a decimal is 10^4
  too small in the reference), so the JAX text is asked for ``sum`` and
  ``count`` of each instead, and the expected average is worked out in
  Python ``decimal`` by Spark's rule (``tpcds.spark_decimal_avg``); the
  averages are decimal(11,6)."""

import gc

import pyarrow as pa
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds_queries import QUERIES
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.io.multifile import host_arrow
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
#: each query: its tables in recipe order, its column cut, its rows at sf 1
QUERY = {"q3": (("date_dim", "store_sales", "item"), tpcds.q3_tables, 11),
         "q19": (("date_dim", "store_sales", "item", "customer",
                  "customer_address", "store"), tpcds.q19_tables, 4),
         "q7": (("store_sales", "customer_demographics", "date_dim", "item",
                 "promotion"), tpcds.q7_tables, 100)}
MONEY_AVGS = ("ss_list_price", "ss_coupon_amt", "ss_sales_price")


def q7_sums_sql() -> str:
    """q7 with each money ``avg`` asked as a ``sum`` and a ``count``."""
    text = QUERIES["q7"]
    for j, c in enumerate(MONEY_AVGS, start=2):
        old = f"avg({c}) agg{j}"
        assert old in text
        text = text.replace(old, f"sum({c}) s{j}, count({c}) n{j}")
    return text


@pytest.fixture(scope="module")
def cuts():
    tables = tpcds.generate_tables(SF)
    return {q: tpcds.decimal_money(cut(tables))
            for q, (_n, cut, _r) in QUERY.items()}


def jax_session(cut, parts: int) -> TpuSession:
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    for name, cols in cut.items():
        data = {c: host_arrow(v) if hasattr(v, "data_type") else v
                for c, v in cols.items()}
        rows = len(next(iter(cols.values())))
        s.create_or_replace_temp_view(name, s.create_dataframe(
            data, num_partitions=parts if rows >= 1000 else 1))
    return s


@pytest.fixture(scope="module")
def jax_rows(cuts):
    rows = {}
    for parts in (1, 2):
        for q in QUERY:
            s = jax_session(cuts[q], parts)
            rows[(q, parts)] = s.sql(q7_sums_sql() if q == "q7"
                                     else QUERIES[q]).collect()
    return rows


def run(cut, query: str, parts: int):
    names = QUERY[query][0]
    frames = tpcds.partitioned_frames(TorchSession(device="cpu"), cut, names,
                                      parts)
    return getattr(tpcds, query)(*frames)[0]


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("query", ["q3", "q19"])
def test_decimal_sums_match_jax_sql(cuts, jax_rows, query, parts):
    df = run(cuts[query], query, parts)
    assert df.schema.types[-1] == T.DecimalType(17, 2)
    got = df.collect()
    ref = jax_rows[(query, parts)]
    assert len(got) == QUERY[query][2]
    assert rows_equal(ref, got, check_order=True,
                      approx_float=False) is None, (ref, got)
    assert got == getattr(tpcds, f"{query}_numpy")(cuts[query])


@pytest.mark.parametrize("parts", [1, 2])
def test_q7d_averages_follow_spark(cuts, jax_rows, parts):
    df = run(cuts["q7"], "q7", parts)
    assert df.schema.types[2:] == [T.DecimalType(11, 6)] * 3
    got = df.collect()
    ref = jax_rows[("q7", parts)]
    assert len(got) == len(ref) == QUERY["q7"][2]
    for g, r in zip(got, ref):
        assert g["i_item_id"] == r["i_item_id"]
        assert abs(g["agg1"] - r["agg1"]) <= 1e-9 * abs(r["agg1"])
        for j in (2, 3, 4):
            want = tpcds.spark_decimal_avg(int(r[f"s{j}"].scaleb(2)),
                                           r[f"n{j}"], tpcds.MONEY)
            assert g[f"agg{j}"] == want
            assert g[f"agg{j}"].as_tuple().exponent == -6
    assert got == tpcds.q7_numpy(cuts["q7"])
