"""Joins on several key columns (exec/joins.py, K10 in ops/join_ops.py
over keys.cuh's row hash and cross-side equality) against the JAX
package's DataFrame.join(on=[...]) (ops/join_ops.py _hash_rows folding
every key column, on JAX-CPU), on the same seeded inputs.

Two keys (int and long: an int key equals a long of the same value) and
three (long, int, long), in all four modes: inner and left outer rows are
compared without regard to order (the JAX package puts a left join's
unmatched rows last, the port keeps each at its place), semi and anti in
order.  Each side has duplicate keys and nulls in one key column only: a
row with a null in any key column never matches, so inner and semi drop
it, left outer null-extends it and anti keeps it.  The wrapper's own
pairs are held against a brute-force join."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
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


#: key columns of each case: (name, type, distinct values, null fraction)
KEYS = {
    2: (("a", T.INT, 6, 0.15), ("b", T.LONG, 5, 0.0)),
    3: (("a", T.LONG, 4, 0.0), ("b", T.INT, 3, 0.2), ("c", T.LONG, 3, 0.0)),
}
HOW = ("inner", "left", "semi", "anti")


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def jax_schema(schema):
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in schema.fields])


def side(rng, n, keys, value):
    """Rows with the ``keys`` columns (duplicates: few distinct values;
    nulls in the columns that have a null fraction) and a value column."""
    d = {}
    for name, _dt, card, nulls in keys:
        d[name] = [None if rng.random() < nulls else int(x)
                   for x in rng.integers(0, card, n)]
    d[value] = [int(x) for x in rng.integers(0, 1000, n)]
    return d, T.StructType([T.StructField(name, dt) for name, dt, _c, _n
                            in keys] + [T.StructField(value, T.LONG)])


@pytest.mark.parametrize("how", HOW)
@pytest.mark.parametrize("n_keys", sorted(KEYS))
def test_multikey_join_matches_jax(jax_session, n_keys, how):
    rng = np.random.default_rng(40 + n_keys)
    keys = KEYS[n_keys]
    names = [k[0] for k in keys]
    left, lschema = side(rng, 120, keys, "lv")
    right, rschema = side(rng, 70, keys, "rv")
    ref = jax_session.create_dataframe(left, jax_schema(lschema)).join(
        jax_session.create_dataframe(right, jax_schema(rschema)),
        on=names, how=how).collect()
    s = TorchSession(device="cpu")
    df = s.create_dataframe(left, schema=lschema).join(
        s.create_dataframe(right, schema=rschema), on=names, how=how)
    got = df.collect()
    existence = how in ("semi", "anti")
    assert rows_equal(ref, got, check_order=existence) is None, (ref, got)
    join = df.executed_plan()
    join = join if existence else join.children[0]
    assert isinstance(join, PJ.TorchHashJoinExec)
    assert len(join.left_keys) == n_keys
    # the cases hold matches, misses and null keys
    tuples = [tuple(right[k][i] for k in names) for i in range(70)]
    matched = [tuple(left[k][i] for k in names) in tuples
               and None not in [left[k][i] for k in names]
               for i in range(120)]
    assert 0 < sum(matched) < 120
    assert any(None in [left[k][i] for k in names] for i in range(120))


def col(values, dt):
    return DeviceColumn(
        torch.tensor([0 if v is None else v for v in values],
                     dtype=dt.torch_dtype),
        torch.tensor([v is not None for v in values], dtype=torch.bool), dt)


@pytest.mark.parametrize("mode", [None, "outer", "semi", "anti"])
def test_multikey_pairs_match_a_brute_force_join(mode):
    """K10's plain version over two key columns of int and long, with an
    empty build side too."""
    rng = np.random.default_rng(3)
    s = TorchSession(device="cpu")
    for nb in (0, 50):
        b = [[None if rng.random() < 0.1 else int(x)
              for x in rng.integers(0, 4, nb)],
             [int(x) for x in rng.integers(0, 4, nb)]]
        p = [[int(x) for x in rng.integers(0, 4, 90)],
             [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(0, 4, 90)]]
        build = [col(b[0], T.INT), col(b[1], T.LONG)]
        probe = [col(p[0], T.LONG), col(p[1], T.INT)]
        outer = mode == "outer"
        got = J.join_pairs(build, probe, s.transfers, outer=outer,
                           mode=None if mode in (None, "outer") else mode)
        want = []
        for i in range(90):
            key = (p[0][i], p[1][i])
            hits = [j for j in range(nb) if None not in key and
                    (b[0][j], b[1][j]) == key]
            if mode == "semi":
                want += [i] if hits else []
            elif mode == "anti":
                want += [] if hits else [i]
            else:
                want += [(i, j) for j in hits] or \
                    ([(i, -1)] if outer else [])
        if mode in ("semi", "anti"):
            assert got[1] is None and got[0].tolist() == want
        else:
            assert list(zip(got[0].tolist(), got[1].tolist())) == want
