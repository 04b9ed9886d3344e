"""The port's ScaleTest (spark_rapids_tpu_torch/testing/scaletest.py) on
the CPU (TorchSession(device="cpu"), every kernel's plain version)
against the JAX package's suite (spark_rapids_tpu/testing/scaletest.py)
on its CPU engine (``spark.rapids.sql.enabled`` false), on the same
tables at 2,000 fact rows and 2 partitions (the JAX test's size).

- ``testing/datagen.py`` gives the JAX generators' values for each
  generator the suite uses, at seed 7, and the same three tables.
- Every query gives the same rows (``scaletest.rows_agree``).  Columns
  are compared exactly, as a multiset of rows (the engines order groups
  and join rows apart; a collect_set's values sorted: Spark leaves their
  order unspecified), except the double sums and averages of ``v1``
  (and of ``weight``), which the engines add in other orders and which
  cancel towards zero (``v1`` is a signed normal at 1e6 with NaN, +-inf
  and +-0.0): those are held within 1e-9 of the sum (or the mean) of
  |v1| over the same group or frame, read from the same query over
  tables with |v1| and |weight| (NaN and inf as 0), and a NaN, an inf or
  a null must match.  Window rows come out in the same order from both
  engines (each sorts the hash partitions' rows stably by the window
  keys), so their frames line up row by row.
- The report keeps the JAX fields; ``rows`` is the downloaded batch's
  row count."""

import gc
import math

import numpy as np
import pytest
import torch

from spark_rapids_tpu.config import TpuConf
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing import datagen as JD
from spark_rapids_tpu.testing import scaletest as JS
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.testing import datagen as PD
from spark_rapids_tpu_torch.testing import scaletest as PS


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


N = 2000
SEED = 7


@pytest.fixture(scope="module")
def jax_rows():
    s = TpuSession(TpuConf({"spark.rapids.sql.enabled": "false"}))
    tables = JS.build_tables(s, N, SEED)
    return {name: q(tables).collect() for name, q in JS._queries()}


@pytest.fixture(scope="module")
def port():
    s = TorchSession(device="cpu")
    return PS.build_tables(s, N, SEED), PS.abs_tables(s, N, SEED)


GENERATORS = [
    ("LongGen", dict(nullable=False, min_val=0, max_val=200)),
    ("IntegerGen", dict(min_val=0, max_val=100)),
    ("DoubleGen", dict()), ("DoubleGen", dict(no_nans=True)),
    ("LongGen", dict(min_val=-1000, max_val=1000)),
    ("StringGen", dict(max_len=12)),
    ("StringGen", dict(nullable=False, max_len=4)),
    ("DateGen", dict()),
]


def same_value(a, b) -> bool:
    if isinstance(a, float) and isinstance(b, float):
        return (math.isnan(a) and math.isnan(b)) or (
            a == b and math.copysign(1, a) == math.copysign(1, b))
    return a == b


@pytest.mark.parametrize("kind,kw", GENERATORS,
                         ids=[f"{k}-{i}" for i, (k, _) in
                              enumerate(GENERATORS)])
def test_datagen_gives_the_jax_generators_values(kind, kw):
    ref = getattr(JD, kind)(**kw).generate(
        3000, np.random.default_rng(SEED)).to_pylist()
    got = getattr(PD, kind)(**kw).generate(
        3000, np.random.default_rng(SEED)).to_pylist()
    assert len(got) == len(ref)
    assert all(same_value(a, b) for a, b in zip(got, ref))


def test_build_tables_hold_the_jax_tables():
    for name, (gens, n, seed, _split) in PS.table_specs(N, SEED).items():
        jgens = [(nm, getattr(JD, type(g).__name__)(**_kwargs(g)))
                 for nm, g in gens]
        ref = JD.gen_batch(jgens, n, seed)
        got = PD.gen_batch(gens, n, seed)
        assert got.names == [nm for nm, _g in gens]
        for c, nm in zip(got.columns, got.names):
            jc = ref.columns[ref.names.index(nm)]
            assert all(same_value(a, b) for a, b in
                       zip(c.to_pylist(), jc.to_pylist())), (name, nm)


def _kwargs(g):
    """A port generator's arguments, for its JAX twin."""
    kw = {"nullable": g.nullable}
    for attr in ("min_val", "max_val", "no_nans", "max_len"):
        if hasattr(g, attr):
            kw[attr] = getattr(g, attr)
    return kw


@pytest.mark.parametrize("name", PS.QUERY_NAMES)
def test_query_matches_the_jax_cpu_engine(name, jax_rows, port):
    tables, absolute = port
    query = dict(PS._queries())[name]
    got = query(tables).collect()
    bounds = query(absolute).collect() if name in PS.SUMS else None
    assert PS.rows_agree(name, got, jax_rows[name], bounds) is None


def test_report_keeps_the_jax_fields():
    s = TorchSession(device="cpu")
    report = PS.run_scale_test(s, scale_rows=300,
                               queries=["agg_sum", "collect_set",
                                        "string_ops"], iterations=2)
    assert [(r["query"], r["iteration"]) for r in report] == \
        [("agg_sum", 0), ("agg_sum", 1), ("collect_set", 0),
         ("collect_set", 1), ("string_ops", 0), ("string_ops", 1)]
    assert all(r["status"] == "OK" and set(r) == {
        "query", "iteration", "rows", "status", "seconds"} for r in report)
    assert PS.QUERY_NAMES == [n for n, _q in JS._queries()]
    if not torch.cuda.is_available():
        # the entry point runs on the card and is refused without one
        with pytest.raises(RuntimeError):
            PS.main(["100"])


def test_rows_agree_finds_a_changed_row():
    """The comparison the suite and chip_smoke.py's phase 9i use: a row
    off by more than the tolerance, a changed exact column, a missing
    row or a NaN for a number are each found."""
    got = [{"key2": 1, "sv": 10.0}, {"key2": None, "sv": float("nan")}]
    bounds = [{"key2": 1, "sv": 1e6}, {"key2": None, "sv": 0.0}]
    ref = list(reversed(got))
    assert PS.rows_agree("agg_sum", got, ref, bounds) is None
    near = [{"key2": 1, "sv": 10.0 + 1e-4}, ref[0]]
    assert PS.rows_agree("agg_sum", got, near, bounds) is None
    far = [{"key2": 1, "sv": 10.0 + 1e-2}, ref[0]]
    assert "agg_sum.sv" in PS.rows_agree("agg_sum", got, far, bounds)
    nan = [{"key2": 1, "sv": float("nan")}, ref[0]]
    assert PS.rows_agree("agg_sum", got, nan, bounds) is not None
    assert "exact columns" in PS.rows_agree(
        "distinct", [{"key2": 1}], [{"key2": 2}])
    assert "rows" in PS.rows_agree("distinct", [{"key2": 1}], [])
