"""TPC-DS q3, q7 and q19 from parquet on the port (TorchSession(device=
"cpu"), every kernel's plain version) at sf 1: the files written by the
port's writer (``testing/tpcds.py write_parquet_tables``: a directory a
table, ``part-{i}.parquet`` cut by the JAX ``register_tables`` rule, a
``_DONE`` marker) once a module, at 1 and 2 partitions (the PERFILE
reader gives a partition a file), each table read with the columns its
recipe names.

The rows, in order, under rowcompare.rows_equal(approx_float=True),
equal:

- the port's run of the recipe over the in-memory tables;
- the JAX package's sql(QUERIES[q]) on its CPU engine over the same
  files, registered with ``read.parquet`` (as ``register_tables(...,
  storage="parquet")`` registers them);
- the numpy versions;

q3 11 rows, q7 100 and q19 4, so an empty result cannot pass.  q7's five
filtered string columns run in code space and are never decoded; q3's
and q19's string payloads are (K16's plain version)."""

import gc
import os

import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds_queries import QUERIES
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch.columnar import encoding as ENC
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
    """The plain versions run many small tensor ops; this module runs on
    one intra-op thread and restores the count after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SF = 1
ROWS = {"q3": 11, "q7": 100, "q19": 4}
COLUMNS = {q: getattr(tpcds, f"{q.upper()}_COLUMNS") for q in ROWS}
Q7_FILTERED = ("cd_gender", "cd_marital_status", "cd_education_status",
               "p_channel_email", "p_channel_event")


@pytest.fixture(scope="module")
def tables():
    return tpcds.generate_tables(SF)


@pytest.fixture(scope="module")
def roots(tables, tmp_path_factory):
    """The files of the three queries' columns, at 1 and 2 partitions."""
    columns = tpcds.merge_columns(*COLUMNS.values())
    return {parts: tpcds.write_parquet_tables(
        tables, str(tmp_path_factory.mktemp(f"tpcds{parts}")), parts,
        columns) for parts in (1, 2)}


@pytest.fixture(scope="module")
def jax_rows(roots):
    rows = {}
    for parts, root in roots.items():
        s = TpuSession({"spark.rapids.sql.enabled": "false"})
        for name in tpcds.merge_columns(*COLUMNS.values()):
            s.create_or_replace_temp_view(
                name, s.read.parquet(os.path.join(root, name)))
        for q in ROWS:
            rows[(q, parts)] = s.sql(QUERIES[q]).collect()
    return rows


def test_written_like_register_tables(roots):
    for parts, root in roots.items():
        with open(os.path.join(root, "_DONE")) as f:
            assert f.read() == str(tpcds.DATAGEN_VERSION)
        files = sorted(os.listdir(os.path.join(root, "store_sales")))
        assert files == [f"part-{i}.parquet" for i in range(parts)]
        assert os.listdir(os.path.join(root, "promotion")) == \
            ["part-0.parquet"]


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("query", list(ROWS))
def test_query_from_parquet_matches_memory_jax_and_numpy(
        tables, roots, jax_rows, query, parts):
    s = TorchSession({"spark.rapids.sql.format.parquet.reader.type":
                      "PERFILE"}, device="cpu")
    recipe = getattr(tpcds, query)
    frames = tpcds.parquet_frames(s, roots[parts], COLUMNS[query])
    names = list(COLUMNS[query])
    assert frames[names.index("store_sales")]._plan.num_partitions == parts
    before = ENC.encoding_stats()["decoded_columns"]
    got = recipe(*frames)[0].collect()
    decoded = ENC.encoding_stats()["decoded_columns"]
    assert len(got) == ROWS[query]
    ref = jax_rows[(query, parts)]
    assert rows_equal(ref, got, check_order=True,
                      approx_float=True) is None, (ref, got)
    cut = getattr(tpcds, f"{query}_tables")(tables)
    memory = recipe(*tpcds.partitioned_frames(
        s, cut, list(COLUMNS[query]), parts))[0].collect()
    assert rows_equal(memory, got, check_order=True,
                      approx_float=True) is None
    numpy_rows = getattr(tpcds, f"{query}_numpy")(cut)
    assert rows_equal(numpy_rows, got, check_order=True,
                      approx_float=True) is None
    changed = {c for c in decoded if decoded[c] != before.get(c, 0)}
    if query == "q7":
        assert not changed & set(Q7_FILTERED)
    else:
        assert changed   # the string payloads decode ahead of the joins
