"""ROLLUP through Expand (session.py GroupedData, exec/expand.py, the keyed
aggregate over the Expand's batches), DataFrame.distinct and K7c's plain
version (ops/batch_ops.py concat_batches) against the JAX package's
DataFrame.rollup (session.py:736, _expand_for_grouping_sets :973),
DataFrame.distinct (:771) and ops/batch_ops.py:274 concat_batches, on
JAX-CPU, on the same seeded inputs.

The rollup's keys are a string and an int, both with real nulls, so a
null the rollup makes must stay apart from a real null (the grouping id
among K9's keys); rows are compared without regard to order, doubles
within 1e-6 relative.  The concat covers strings with empty values,
nulls and batches of no row, exactly."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.columnar.batch import batch_from_pydict as jax_batch
from spark_rapids_tpu.ops import batch_ops as JB
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.exec.expand import TorchExpandExec
from spark_rapids_tpu_torch.ops import batch_ops as BO


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


SCHEMA = T.StructType([T.StructField("s", T.STRING), T.StructField("k", T.INT),
                       T.StructField("v", T.DOUBLE),
                       T.StructField("q", T.LONG)])


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def jax_schema(schema):
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in schema.fields])


def data(rng, n=300):
    words = ["", "a", "bb", "é", "long value"]
    return {"s": [None if rng.random() < 0.15 else str(rng.choice(words))
                  for _ in range(n)],
            "k": [None if rng.random() < 0.15 else int(x)
                  for x in rng.integers(0, 4, n)],
            "v": [None if rng.random() < 0.1 else float(x)
                  for x in rng.standard_normal(n).round(3)],
            "q": [int(x) for x in rng.integers(-9, 9, n)]}


def test_rollup_matches_jax(jax_session):
    from spark_rapids_tpu import functions as JF
    d = data(np.random.default_rng(17))

    def aggs(fn):
        return [fn.sum("v").alias("sv"), fn.count("*").alias("n"),
                fn.avg("q").alias("aq")]
    ref = jax_session.create_dataframe(d, jax_schema(SCHEMA)) \
        .rollup("s", "k").agg(*aggs(JF)).collect()
    df = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .rollup("s", "k").agg(*aggs(F))
    got = df.collect()
    assert rows_equal(ref, got, check_order=False,
                      approx_float=True) is None, (ref, got)
    assert df.columns == ["s", "k", "sv", "n", "aq"]
    # the grand total, and a real null apart from a rollup null
    assert sum(r["s"] is None and r["k"] is None for r in got) == 3
    assert max(r["n"] for r in got) == 300
    expand = df.executed_plan().children[0].children[0]
    assert isinstance(expand, TorchExpandExec)
    assert len(expand.projections) == 3
    # the Expand carries the keys, the grouping id and the two inputs
    assert expand.schema.names == ["s", "k", "__grouping_id", "v", "q"]


def test_distinct_matches_jax(jax_session):
    d = data(np.random.default_rng(23))
    ref = jax_session.create_dataframe(d, jax_schema(SCHEMA)) \
        .select("s", "k").distinct().collect()
    df = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .select("s", "k").drop_duplicates()
    got = df.collect()
    assert rows_equal(ref, got, check_order=False) is None, (ref, got)
    assert len(got) == len({(r["s"], r["k"]) for r in got})


@pytest.mark.parametrize("sizes", [(3, 0, 5), (0, 0), (1, 7, 0, 2),
                                   (40, 25)])
def test_concat_plain_matches_jax(sizes):
    rng = np.random.default_rng(sum(sizes))
    parts = [data(rng, n) for n in sizes]
    jschema = jax_schema(SCHEMA)
    ref = JB.concat_batches([jax_batch(p, jschema).to_device()
                             for p in parts]).to_host().to_pydict()
    s = TorchSession(device="cpu")
    batches = [s.transfers.upload_batch(batch_from_pydict(p, SCHEMA))
               for p in parts]
    got = BO.concat_batches(batches)
    assert got.row_count == sum(sizes)
    host = s.transfers.download_batch(got).to_pydict()
    want = {k: [v for p in parts for v in p[k]] for k in parts[0]}
    assert host == want
    assert {k: v[:sum(sizes)] for k, v in ref.items()} == want
    # the plain version is the wrapper's on CPU columns
    direct = BO.concat_batches_plain(batches)
    assert s.transfers.download_batch(direct).to_pydict() == want
