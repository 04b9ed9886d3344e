"""TPC-DS q8 and q5 on the port (TorchSession(device="cpu"), every
kernel's plain version) against the JAX package's sql(QUERIES[...]) on
its CPU engine (``spark.rapids.sql.enabled`` false), on the same
generated tables at sf 1, at 1 and 2 partitions (``register_tables``'
rule on both sides: a table under 1000 rows stays whole), and against
the numpy versions.

- Rows equal in order under rowcompare.rows_equal(approx_float=True)
  (names, counts and strings exact; sums within 1e-6 relative): q8 9
  rows, q5 100, so an empty result cannot pass.
- The plans: q8 writes its zip prefixes with K13 (a group key's input,
  the INTERSECT's columns, both join keys), runs the INTERSECT as a
  null-safe left semi join (K10's null-safe mode) and its 128-zip IN in
  K5; q5 writes ``'store' || s_store_id`` and the channel names with
  K13 and runs four UNION ALLs (no device work).
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
from spark_rapids_tpu_torch.exec.basic import TorchUnionExec
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec
from spark_rapids_tpu_torch.ops import string_ops as SO
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
    threads in each pytest worker makes them contend for the cores (q5 at
    sf 1 took 5.4 s at 8 threads and 0.46 s at 1 on an 8-core machine
    under load).  This module runs on one thread and restores the count
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 1
TABLES = {"q8": tuple(tpcds.Q8_COLUMNS), "q5": tuple(tpcds.Q5_COLUMNS)}
ROWS = {"q8": 9, "q5": 100}
#: syncs of a repeated query at one partition.  q8: the IN stage, K13's
#: zip5 for its survivors, the distinct's groups, the preferred
#: customers' compaction, their join, the zip counts, the HAVING, K13 of
#: the crowded zips, the semi join, the dates, three join sizes and a
#: chars total, K13's two zip2 columns, the store groups, the sort's
#: string lengths and the download.  q5 runs behind exchanges (its
#: unions' partitions are their children's): a histogram read per
#: exchange, each join's size, each group-by's groups, K13's two outputs
#: per channel, the rollup and the range exchange's sample and histogram.
SYNCS = {"q8": 22, "q5": 83}


@pytest.fixture(scope="module")
def tables():
    return tpcds.generate_tables(SF)


@pytest.fixture(scope="module")
def jax_rows():
    rows = {}
    for parts in (1, 2):
        s = TpuSession({"spark.rapids.sql.enabled": "false"})
        register_tables(s, sf=SF, num_partitions=parts,
                        tables={t for ts in TABLES.values() for t in ts})
        for q in TABLES:
            rows[(q, parts)] = s.sql(QUERIES[q]).collect()
    return rows


def frames(session, tables, query, parts=1):
    cut = getattr(tpcds, f"{query}_tables")(tables)
    return tpcds.partitioned_frames(session, cut, TABLES[query], parts)


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("query", list(TABLES))
def test_query_matches_jax_sql_and_numpy(tables, jax_rows, query, parts):
    """At one partition the query runs again: it builds nothing, and its
    syncs are counted (``SYNCS``)."""
    s = TorchSession(device="cpu")
    fs = frames(s, tables, query, parts)
    recipe = getattr(tpcds, query)
    got = recipe(*fs)[0].collect()
    ref = jax_rows[(query, parts)]
    assert len(got) == ROWS[query] == len(ref)
    assert rows_equal(ref, got, check_order=True,
                      approx_float=True) is None, (ref, got)
    numpy_rows = getattr(tpcds, f"{query}_numpy")(
        getattr(tpcds, f"{query}_tables")(tables))
    assert rows_equal(numpy_rows, got, check_order=True,
                      approx_float=True) is None
    if parts == 1:
        built = stage_compiler.stats()["builds"]
        before = s.transfers.stats()
        assert recipe(*fs)[0].collect() == got
        after = s.transfers.stats()
        assert stage_compiler.stats()["builds"] == built
        assert after["syncs"] - before["syncs"] == SYNCS[query]


def nodes(node):
    yield node
    for c in node.children:
        yield from nodes(c)


def string_forms(plan):
    """The K13 forms of every stage and projection program in a plan."""
    out = []
    for n in nodes(plan):
        for attr in ("program", "keys", "finish"):
            prog = getattr(n, attr, None)
            out += [f for f in getattr(prog, "strings", []) if f]
    return out


def test_plans_route_as_the_jax_plan_does(tables):
    s = TorchSession(device="cpu")
    q8, parts = tpcds.q8(*frames(s, tables, "q8"))
    plan = q8.executed_plan()
    forms = string_forms(plan)
    assert sorted((f.op, f.pos, f.length) for f in forms) == \
        [(SO.SUBSTRING, 1, 2)] * 2 + [(SO.SUBSTRING, 1, 5)] * 2
    semi = [n for n in nodes(plan) if isinstance(n, TorchHashJoinExec)
            and n.how == "left_semi"]
    assert len(semi) == 1 and semi[0].null_safe == [True]
    assert "<=>" in q8.explain()
    q5 = tpcds.q5(*frames(s, tables, "q5"))[0]
    plan = q5.executed_plan()
    assert len([n for n in nodes(plan) if isinstance(n, TorchUnionExec)]) \
        == 5
    concats = [f.parts for f in string_forms(plan) if f.op == SO.CONCAT]
    assert [b"store", 0] in concats and [b"store channel"] in concats
    assert plan.num_partitions == 1
