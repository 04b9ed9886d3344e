"""Right and full outer joins on the port (exec/joins.py over
ops/join_ops.py join_pairs: the outer mode with the sides swapped, and
K10f's full mode, in their plain versions) against the JAX package's
DataFrame.join(how="right"|"full") on its CPU engine
(``spark.rapids.sql.enabled`` false, the oracle tests/test_joins.py holds
its device path to), on the same data.

The cases of tests/test_joins.py that take these join types (the basic
join, several keys, the empty sides, the larger random case) and keys of
each type the port joins on: int, long, date and string, and two keys,
with null keys on both sides and build keys repeated, at 1, 2 and 3
partitions.  USING keys: a right join gives the right side's keys, a
full join their coalesce (the join exec's K7 and K7c).  Rows are
compared as sets (rowcompare.rows_equal), doubles within 1e-6
relative.  The ON form (key pairs, both sides' columns) is held against
the USING form, and K10f's plain version's pairs against the join's
definition."""

import datetime
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


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "false"})


def _left_data():
    return {
        "k": [1, 2, 2, 3, None, 5, None, 7, 8, 2],
        "lv": [10.0, 20.0, 21.0, 30.0, 40.0, None, 60.0, 70.0, 80.0, 22.0],
    }


def _right_data():
    return {
        "k": [2, 2, 3, 4, None, 6, 8, 8, None],
        "rv": [200.0, 201.0, 300.0, 400.0, None, 600.0, 800.0, 801.0, 900.0],
    }


def keyed(seed, n, card, kind):
    """``n`` rows of key ``k`` of ``kind`` (about a tenth null, values
    repeating over ``card``) and a second key ``a``."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, card, n)
    null = rng.random(n) < 0.1
    first = datetime.date(2000, 1, 1)
    make = {"int": lambda x: np.int32(x).item(),
            "long": lambda x: int(x) * 3_000_000_000,
            "date": lambda x: first + datetime.timedelta(days=int(x)),
            "string": lambda x: ["", "a", "ab", "é", "abcdefghij"][x % 5] +
            str(x // 5)}[kind]
    k = [None if z else make(x) for x, z in zip(raw, null)]
    return {"k": k, "a": [int(x) for x in rng.integers(0, 2, n)],
            "v": [float(x) for x in rng.normal(size=n)]}


KEY_TYPES = {"int": T.INT, "long": T.LONG, "date": T.DATE,
             "string": T.STRING}


def schema(data, key_type):
    return T.StructType([T.StructField(
        n, key_type if n == "k" else T.INT if n == "a" else T.DOUBLE)
        for n in data])


def jax_schema(s):
    """The JAX package's schema of the port's schema ``s``."""
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in s.fields])


def both(jax_session, left, right, on, how, parts, key_type=None):
    """The rows of ``left.join(right, on=on, how=how)`` on the JAX
    package and on the port (CPU), each side at ``parts`` partitions
    (with ``key_type``, both sides under schemas with that key type)."""
    ls = rs = None
    if key_type is not None:
        ls, rs = schema(left, key_type), schema(right, key_type)
    ref = jax_session.create_dataframe(
        left, *([jax_schema(ls)] if ls else []), num_partitions=parts).join(
        jax_session.create_dataframe(
            right, *([jax_schema(rs)] if rs else []),
            num_partitions=parts), on=on, how=how).collect()
    s = TorchSession(device="cpu")
    got = s.create_dataframe(left, num_partitions=parts, schema=ls).join(
        s.create_dataframe(right, num_partitions=parts, schema=rs), on=on,
        how=how).collect()
    return ref, got


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("how", ["right", "full", "outer", "right_outer",
                                 "full_outer"])
def test_join_basic(jax_session, how, parts):
    ref, got = both(jax_session, _left_data(), _right_data(), "k", how,
                    parts)
    assert len(got) == len(ref) > 0
    assert rows_equal(ref, got) is None, (ref, got)


@pytest.mark.parametrize("parts", [1, 2, 3])
@pytest.mark.parametrize("kind", ["int", "long", "date", "string", "two"])
@pytest.mark.parametrize("how", ["right", "full"])
def test_key_types(jax_session, how, kind, parts):
    key = "long" if kind == "two" else kind
    left = keyed(3, 300, 60, key)
    right = keyed(4, 200, 90, key)
    right = {"k": right["k"], "a": right["a"], "w": right["v"]}
    on = ["k", "a"] if kind == "two" else "k"
    ref, got = both(jax_session, left, right, on, how, parts,
                    KEY_TYPES[key])
    assert len(got) == len(ref) > 200
    assert rows_equal(ref, got) is None
    unmatched = [r for r in got if r["v"] is None]
    assert unmatched and any(r["k"] is None for r in unmatched)


@pytest.mark.parametrize("how", ["right", "full"])
def test_join_empty_sides(jax_session, how):
    empty = {"k": np.array([], dtype=np.int64),
             "rv": np.array([], dtype=np.float64)}
    ref, got = both(jax_session, _left_data(), empty, "k", how, 1)
    assert rows_equal(ref, got) is None
    lempty = {"k": np.array([], dtype=np.int64),
              "lv": np.array([], dtype=np.float64)}
    ref, got = both(jax_session, lempty, _right_data(), "k", how, 1)
    assert len(got) == len(ref) == 9
    assert rows_equal(ref, got) is None


@pytest.mark.parametrize("how", ["right", "full"])
def test_join_larger_random(jax_session, how):
    rng = np.random.default_rng(42)
    n, m = 5000, 3000
    left = {"k": rng.integers(0, 500, n), "lv": rng.normal(size=n)}
    right = {"k": rng.integers(400, 900, m), "rv": rng.normal(size=m)}
    ref, got = both(jax_session, left, right, "k", how, 3)
    assert len(got) == len(ref)
    assert rows_equal(ref, got) is None


def test_on_pairs_keep_both_sides():
    """The ON form of a full join keeps both sides' keys; coalescing them
    gives the USING form's key, row for row as sets."""
    s = TorchSession(device="cpu")
    left = keyed(5, 120, 40, "string")
    right = keyed(6, 90, 60, "string")
    using = s.create_dataframe(left).join(
        s.create_dataframe({"k": right["k"], "w": right["v"]}), on="k",
        how="full").collect()
    on = s.create_dataframe({"lk": left["k"], "v": left["v"]}).join(
        s.create_dataframe({"rk": right["k"], "w": right["v"]}),
        on=[("lk", "rk")], how="full").collect()
    assert list(on[0]) == ["lk", "v", "rk", "w"]
    assert all(r["lk"] == r["rk"] for r in on
               if r["lk"] is not None and r["rk"] is not None)
    coalesced = [{"k": r["lk"] if r["lk"] is not None else r["rk"],
                  "a": None, "v": r["v"], "w": r["w"]} for r in on]
    assert rows_equal([dict(r, a=None) for r in using], coalesced) is None
    with pytest.raises(ValueError, match="rename"):
        s.create_dataframe(left).join(s.create_dataframe(right),
                                      on=[("k", "k")], how="full")
    with pytest.raises(TypeError, match="type mismatch"):
        s.create_dataframe({"k": np.array([1], dtype=np.int32)}).join(
            s.create_dataframe({"k": np.array([1], dtype=np.int64)}),
            on="k", how="full")


def test_full_mode_pairs():
    """K10f's plain version: the outer pairs in probe order, then every
    build row no probe row matched (null keys included) once, in build
    order, and the number of pairs before them."""
    def col(values):
        return DeviceColumn(
            torch.tensor([0 if v is None else v for v in values]),
            torch.tensor([v is not None for v in values]), T.LONG)
    build = col([5, None, 2, 5, 9, None, 7])
    probe = col([5, 3, None, 2, 5])

    class Reads:
        reads = 0

        def read_counts(self, counts):
            self.reads += 1
            return [int(c) for c in counts]
    tr = Reads()
    p, b, pairs = J.join_pairs(build, probe, tr, mode="full")
    assert tr.reads == 1 and pairs == 7
    assert p.tolist() == [0, 0, 1, 2, 3, 4, 4, -1, -1, -1, -1]
    assert b.tolist() == [0, 3, -1, -1, 2, 0, 3, 1, 4, 5, 6]


def test_plans_never_broadcast_the_preserved_side():
    """Over several partitions both sides of a right or full join are
    hash-exchanged; the join builds on the side the mode names."""
    s = TorchSession(device="cpu")
    a = s.create_dataframe(_left_data(), num_partitions=2)
    b = s.create_dataframe(_right_data(), num_partitions=3)
    for how, mode in (("right", PJ.RIGHT_OUTER), ("full", PJ.FULL_OUTER)):
        plan = a.join(b, on="k", how=how).executed_plan()
        join = plan.children[0]
        assert isinstance(join, PJ.TorchHashJoinExec) and join.how == mode
        assert all(type(c).__name__ == "TorchShuffleExchangeExec"
                   for c in join.children)
        assert join.coalesce_keys == (how == "full")
