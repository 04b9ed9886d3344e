"""The port's parquet scan (``TorchSession.read.parquet``,
spark_rapids_tpu_torch/io/) against the JAX package's ``read.parquet`` on
its CPU engine (``spark.rapids.sql.enabled`` false), over files written
here: three row groups of 10,000 rows in one file, each with its own
dictionaries (pyarrow writes a dictionary a row group), a string column
of 72,000 distinct values in a file of its own (over the 65,536 of
``maxDictionarySize``: uploaded plain), a small dimension of strings in
two files, 10% nulls in every column.

The same rows come back with encoding on and off, late materialization
on and off, RLE on (a column of runs of 100 goes up as runs), and the
PERFILE, COALESCING and MULTITHREADED readers: column pruning, a
filter pushed down to the reader, code-space conjuncts (``=``, ``OR``,
``IS NULL``) in K5 and in kernel 1 (a global aggregate), a group-by on a
dictionary column (decoded by K16's plain version) and a join on one (against a table of two files, read as one
partition by COALESCING and as two by PERFILE)."""

import gc

import numpy as np
import pyarrow as pa
import pyarrow.parquet as pq
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar import encoding as ENC
from spark_rapids_tpu_torch.expressions.base import col, lit
from spark_rapids_tpu_torch.expressions.predicates import (EqualTo,
                                                           GreaterThan,
                                                           IsNull, LessThan,
                                                           Or)


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
    """The plain versions run many small tensor ops; this module runs on
    one intra-op thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


N = 30_000
BIG = 80_000


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """``facts/part-0.parquet`` (three row groups),
    ``big/part-0.parquet`` (72,000 distinct strings in one row group) and
    ``dims/part-{0,1}.parquet`` (the 40 words, in two files)."""
    rng = np.random.default_rng(11)
    root = tmp_path_factory.mktemp("parquet")

    def nulls(n):
        return rng.random(n) < 0.1
    words = np.array([f"v{i}{'é' * (i % 3)}" for i in range(40)],
                     dtype=object)
    facts = pa.table({
        "s": pa.array(words[rng.integers(0, 40, N)], mask=nulls(N)),
        "t": pa.array(words[rng.integers(0, 7, N)], mask=nulls(N)),
        "k": pa.array(rng.integers(0, 1000, N), mask=nulls(N)),
        "d": pa.array(rng.normal(0, 100, N).round(2), mask=nulls(N)),
        "r": pa.array(np.repeat(np.arange(N // 100), 100)),
    })
    (root / "facts").mkdir()
    pq.write_table(facts, root / "facts" / "part-0.parquet",
                   row_group_size=10_000)
    dims = pa.table({"w": pa.array(words), "x": pa.array(np.arange(40))})
    (root / "dims").mkdir()
    pq.write_table(dims.slice(0, 25), root / "dims" / "part-0.parquet")
    pq.write_table(dims.slice(25), root / "dims" / "part-1.parquet")
    big = pa.table({
        "b": pa.array([f"id{i:07d}" for i in rng.permutation(BIG)],
                      mask=nulls(BIG)),
        "k": pa.array(rng.integers(0, 1000, BIG)),
    })
    (root / "big").mkdir()
    pq.write_table(big, root / "big" / "part-0.parquet")
    return root


def jax_rows(root, sql):
    s = TpuSession({"spark.rapids.sql.enabled": "false"})
    for name in ("facts", "big", "dims"):
        s.create_or_replace_temp_view(name,
                                      s.read.parquet(str(root / name)))
    return s.sql(sql).collect()


CONFS = {
    "default": {},
    "encoding off": {"spark.rapids.sql.encoding.enabled": "false"},
    "late materialization off": {
        "spark.rapids.sql.encoding.lateMaterialization": "false"},
    "RLE on": {"spark.rapids.sql.encoding.rle.enabled": "true"},
    "PERFILE": {"spark.rapids.sql.format.parquet.reader.type": "PERFILE"},
    "MULTITHREADED": {
        "spark.rapids.sql.format.parquet.reader.type": "MULTITHREADED",
        "spark.rapids.sql.multiThreadedRead.numThreads": "2"},
    "COALESCING, 40,000-row batches": {
        "spark.rapids.sql.format.parquet.reader.type": "COALESCING",
        "spark.rapids.sql.reader.batchSizeRows": "40000"},
}

QUERIES = {
    "pruned": "select s, k from facts",
    "pushed filter": "select s, d from facts where k > 900",
    "code space": "select s, t, k from facts where s = 'v3' or t is null",
    "group by": "select s, count(k) as n, sum(d) as sd, sum(r) as sr "
                "from facts group by s",
    "join": "select f.k, d.w, d.x from facts f join dims d on f.s = d.w "
            "where f.k < 100",
    "big": "select b, k from big where b is not null and k = 7",
    "global aggregate": "select count(k) as n, sum(d) as sd from facts "
                        "where s = 'v3' or t = 'v1é'",
}


def port_query(session, root, name):
    read = session.read.parquet
    if name == "pruned":
        return read(str(root / "facts"), columns=["s", "k"])
    if name == "pushed filter":
        return read(str(root / "facts"), columns=["s", "d", "k"]) \
            .filter(GreaterThan(col("k"), lit(900, T.LONG))) \
            .select(col("s"), col("d"))
    if name == "code space":
        return read(str(root / "facts"), columns=["s", "t", "k"]) \
            .filter(Or(EqualTo(col("s"), lit("v3")), IsNull(col("t"))))
    if name == "group by":
        return read(str(root / "facts")).group_by("s").agg(
            F.count("k").alias("n"), F.sum("d").alias("sd"),
            F.sum("r").alias("sr"))
    if name == "join":
        facts = read(str(root / "facts"), columns=["s", "k"]).filter(
            LessThan(col("k"), lit(100, T.LONG)))
        dims = read(str(root / "dims"))
        return facts.join(dims, on=[("s", "w")]).select(col("k"), col("w"),
                                                        col("x"))
    if name == "global aggregate":
        # kernel 1 with its conjuncts in code space
        return read(str(root / "facts")).filter(Or(
            EqualTo(col("s"), lit("v3")), EqualTo(col("t"), lit("v1é")))) \
            .agg(F.count("k").alias("n"), F.sum("d").alias("sd"))
    from spark_rapids_tpu_torch.expressions.predicates import (And,
                                                               IsNotNull)
    return read(str(root / "big")).filter(And(
        IsNotNull(col("b")), EqualTo(col("k"), lit(7, T.LONG))))


@pytest.fixture(scope="module")
def reference(files):
    return {q: jax_rows(files, sql) for q, sql in QUERIES.items()}


@pytest.mark.parametrize("conf", list(CONFS))
@pytest.mark.parametrize("query", list(QUERIES))
def test_read_parquet_matches_jax(files, reference, query, conf):
    s = TorchSession(CONFS[conf], device="cpu")
    got = port_query(s, files, query).collect()
    ref = reference[query]
    assert len(got) == len(ref) > 0
    assert rows_equal(ref, got, check_order=False,
                      approx_float=True) is None


def test_scan_keeps_dictionaries_and_pushes_the_filter(files):
    """The string columns arrive as codes (one dictionary a row group:
    three fingerprints), the 72,000-value one plain (its reason
    counted); the filter right above the scan reaches the reader; the
    code-space filter decodes neither column it reads."""
    s = TorchSession(device="cpu")
    df = port_query(s, files, "pushed filter")
    scan = df.executed_plan().children[0]
    assert scan.scan.predicate is not None
    before = ENC.encoding_stats()
    s.read.parquet(str(files / "facts")).collect()
    s.read.parquet(str(files / "big")).collect()
    after = ENC.encoding_stats()
    assert after["encoded_columns"] - before["encoded_columns"] == 6
    assert after["rle_columns"] == before["rle_columns"]
    rle = TorchSession({"spark.rapids.sql.encoding.rle.enabled": "true"},
                       device="cpu")
    assert rle.read.parquet(str(files / "facts"), columns=["r"]).collect()
    assert ENC.encoding_stats()["rle_columns"] > after["rle_columns"]
    reasons = after["fallback_reasons"]
    assert reasons.get("maxDictionarySize", 0) > \
        before["fallback_reasons"].get("maxDictionarySize", 0)
    # the filtered columns left out of the result: nothing decodes them
    rows = port_query(s, files, "code space").select(col("k")).collect()
    done = ENC.encoding_stats()["decoded_columns"]
    assert done.get("s", 0) == after["decoded_columns"].get("s", 0)
    assert done.get("t", 0) == after["decoded_columns"].get("t", 0)
    assert rows
