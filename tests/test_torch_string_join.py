"""Joins on string keys (exec/joins.py, K10 in ops/join_ops.py over
keys.cuh's row hash of the bytes and cross-side byte equality; the plain
version's string ids) against the JAX package's DataFrame.join(on=...)
(ops/join_ops.py _hash_rows over string words whose widths the two sides
agree on, on JAX-CPU), on the same seeded inputs.

One string key, and a string key beside an int one, in all four modes.
The strings hold empty strings (which are not null), prefixes of one
another (``ab``, ``ab\\0``, ``abc``), strings over 8 bytes that differ only
past the eighth, multi-byte characters and nulls.  Inner and left outer
rows are compared without regard to order (the JAX package puts a left
join's unmatched rows last, the port keeps each at its place), semi and
anti rows in order; every value exactly."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.exec import joins as PJ
from spark_rapids_tpu_torch.ops import join_ops as J


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


STEMS = ["", "a", "ab", "ab\0", "abc", "abcdefgh", "abcdefghi",
         "abcdefghX", "abcdefghijklmnopqrstuvwxyz0123456789", "é", "日本",
         None]
HOW = ("inner", "left", "semi", "anti")
KEYS = {"string": (("k", T.STRING),),
        "string and int": (("k", T.STRING), ("n", T.INT))}


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def jax_schema(schema):
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in schema.fields])


def side(rng, n, keys, value, stems):
    d = {}
    for name, dt in keys:
        if dt == T.STRING:
            d[name] = [stems[x] for x in rng.integers(0, len(stems), n)]
        else:
            d[name] = [None if rng.random() < 0.1 else int(x)
                       for x in rng.integers(0, 3, n)]
    d[value] = [int(x) for x in rng.integers(0, 1000, n)]
    return d, T.StructType([T.StructField(name, dt) for name, dt in keys] +
                           [T.StructField(value, T.LONG)])


@pytest.mark.parametrize("how", HOW)
@pytest.mark.parametrize("keys", list(KEYS))
def test_string_key_join_matches_jax(jax_session, keys, how):
    rng = np.random.default_rng(len(keys) * 7 + HOW.index(how))
    cols = KEYS[keys]
    names = [c[0] for c in cols]
    left, lschema = side(rng, 150, cols, "lv", STEMS)
    # the right side misses some stems, so anti and outer keep rows
    right, rschema = side(rng, 40, cols, "rv", STEMS[:-4] + [None])
    ref = jax_session.create_dataframe(left, jax_schema(lschema)).join(
        jax_session.create_dataframe(right, jax_schema(rschema)),
        on=names, how=how).collect()
    s = TorchSession(device="cpu")
    df = s.create_dataframe(left, schema=lschema).join(
        s.create_dataframe(right, schema=rschema), on=names, how=how)
    got = df.collect()
    existence = how in ("semi", "anti")
    assert rows_equal(ref, got, check_order=existence,
                      approx_float=False) is None, (ref, got)
    join = df.executed_plan()
    join = join if existence else join.children[0]
    assert isinstance(join, PJ.TorchHashJoinExec)
    assert [k.data_type for k in join.left_keys] == [dt for _n, dt in cols]
    assert 0 < len(got)


def test_string_pairs_against_brute_force():
    """The wrapper's pairs over int32 and int64 offsets alike: every
    (probe, build) pair whose strings hold the same bytes, none with a
    null."""
    rng = np.random.default_rng(9)
    tr = TransferGateway(torch.device("cpu"))
    b = [STEMS[x] for x in rng.integers(0, len(STEMS), 60)]
    p = [STEMS[x] for x in rng.integers(0, len(STEMS), 90)]
    bc = tr.upload_batch(batch_from_pydict({"k": b})).columns[0]
    pc = tr.upload_batch(batch_from_pydict({"k": p})).columns[0]
    pc64 = type(pc)(pc.data, pc.validity, pc.data_type, pc.all_valid,
                    pc.offsets.to(torch.int64))
    want = [(i, j) for i, x in enumerate(p) for j, y in enumerate(b)
            if x is not None and x == y]
    for probe in (pc, pc64):
        got_p, got_b = J.join_pairs(bc, probe, tr)
        assert list(zip(got_p.tolist(), got_b.tolist())) == want
    kept, _ = J.join_pairs(bc, pc, tr, mode="anti")
    assert kept.tolist() == [i for i, x in enumerate(p)
                             if x is None or x not in b]


def test_keys_outside_the_port_are_refused():
    s = TorchSession(device="cpu")
    a = s.create_dataframe({"k": ["x"], "d": [1.0]})
    b = s.create_dataframe({"k": [1], "d": [1.0]})
    with pytest.raises(NotImplementedError, match="DoubleType"):
        a.join(a, on="d").explain()
    with pytest.raises(TypeError, match="cannot meet"):
        a.join(b, on="k").explain()
