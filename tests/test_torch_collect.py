"""collect_list and collect_set (K15's plain version, ops/agg_ops.py
collect_plain, over K9's groups or one group) against the JAX package's
``segmented_collect_many`` (spark_rapids_tpu/ops/agg_ops.py:530, its
device programs ``agg.collect_phase1/2`` run on JAX-CPU), on the same
seeded inputs.

- Lists are compared exactly, in row order (both keep it).  Sets are
  compared as sorted lists of their values' bits: the port keeps each
  distinct value's first row in first-seen order, the JAX device path
  sorts by value; both keep the least row of equal values, so a group
  holding -0.0 and 0.0 keeps the same one, and every NaN is one value.
- Groups are matched by key (the port numbers them in first appearance,
  the JAX path in key order); a null key is a group.
- The values: long, int, date, boolean, double (NaN, +-0.0, +-inf) and
  decimal64, with nulls (never collected); a global collect; an empty
  input and an all-null group give ``[]``, never null, as the JAX tests
  (tests/test_collect_percentile.py:104-118) require.
- A string, decimal128 or nested element, and an array input column,
  are refused by name; sorting an array output is refused by name."""

import decimal
import gc
import struct

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import HostColumnarBatch as JBatch
from spark_rapids_tpu.columnar.column import HostColumn as JColumn
from spark_rapids_tpu.ops.agg_ops import segmented_collect_many
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import host_column
from spark_rapids_tpu_torch.columnar.column import HostColumn
from spark_rapids_tpu_torch.expressions.base import Alias, col, lit
from spark_rapids_tpu_torch.expressions.predicates import GreaterThan
from spark_rapids_tpu_torch.ops import agg_ops as G


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


DEC = T.DecimalType(7, 2)
TYPES = {"long": (T.LONG, JT.LONG), "int": (T.INT, JT.INT),
         "date": (T.DATE, JT.DATE), "bool": (T.BOOLEAN, JT.BOOLEAN),
         "double": (T.DOUBLE, JT.DOUBLE),
         "decimal": (DEC, JT.DecimalType(7, 2))}
SPECIALS = [0.0, -0.0, float("nan"), float("inf"), float("-inf"), 1.5,
            -2.25]


def values_of(kind, rng, n):
    """Python values with 15% nulls, a few distinct ones each."""
    if kind == "double":
        raw = [SPECIALS[i] for i in rng.integers(0, len(SPECIALS), n)]
    elif kind == "bool":
        raw = [bool(x) for x in rng.integers(0, 2, n)]
    elif kind == "date":
        import datetime
        raw = [datetime.date(2000, 1, 1) + datetime.timedelta(days=int(x))
               for x in rng.integers(-3, 4, n)]
    elif kind == "decimal":
        raw = [decimal.Decimal(int(x)).scaleb(-2)
               for x in rng.integers(-300, 300, n)]
    elif kind == "int":
        raw = [int(x) for x in rng.integers(-5, 5, n)]
    else:
        raw = [int(x) for x in rng.integers(-(1 << 40), 1 << 40, 5)[
            rng.integers(0, 5, n)]]
    return [None if rng.random() < 0.15 else v for v in raw]


def bits(kind, v):
    """A value as the bits it carries (a double's sign of zero and NaN
    payload too)."""
    if kind == "double":
        return struct.pack("<d", v)
    return v


def jax_collect(keys, values, kind):
    """``{key: (list, set)}`` from the JAX device path's collect."""
    jt = TYPES[kind][1]
    hb = JBatch([JColumn.from_pylist(keys, JT.INT),
                 JColumn.from_pylist(values, jt)], len(keys), ["g", "v"])
    lists, sets = segmented_collect_many(hb.to_device(), 1,
                                         [(1, False), (1, True)])
    lh, sh = lists.to_host().to_pydict(), sets.to_host().to_pydict()
    assert lh["g"] == sh["g"]
    return {g: (a, b) for g, a, b in zip(lh["g"], lh["collected"],
                                         sh["collected"])}


def port_collect(keys, values, kind, distinct):
    """``{key: list}`` from K15's plain version over K9's plain groups."""
    s = TorchSession(device="cpu")
    kc = s.transfers.upload_column(host_column(keys, T.INT))
    vc = s.transfers.upload_column(host_column(values, TYPES[kind][0]))
    rep, _res, gid = G.keyed_aggregate([kc], [], [], s.transfers,
                                       row_groups=True)
    before = s.transfers.stats()["syncs"]
    got = G.collect(vc, gid, rep.shape[0], distinct, s.transfers)
    assert s.transfers.stats()["syncs"] - before == int(len(keys) > 0)
    assert got.data_type == T.ArrayType(TYPES[kind][0], False)
    assert bool(got.validity.all())
    host = HostColumn(got.data.numpy(), None, got.data_type,
                      got.offsets.numpy())
    key_of = [keys[i] for i in rep.tolist()]
    return dict(zip(key_of, host.to_pylist()))


def sorted_bits(kind, xs):
    def order(v):
        if kind == "double":
            return (v != v, 0.0 if v != v else v, bits(kind, v))
        return (v,)
    return [bits(kind, v) for v in sorted(xs, key=order)]


@pytest.mark.parametrize("kind", list(TYPES))
@pytest.mark.parametrize("n,groups", [(400, 9), (200, 200), (1, 1)])
def test_collect_matches_segmented_collect_many(kind, n, groups):
    rng = np.random.default_rng(n * 7 + groups + len(kind))
    keys = [None if rng.random() < 0.05 else int(x)
            for x in rng.integers(0, groups, n)]
    values = values_of(kind, rng, n)
    ref = jax_collect(keys, values, kind)
    lists = port_collect(keys, values, kind, False)
    sets = port_collect(keys, values, kind, True)
    assert set(lists) == set(ref) == set(sets)
    for g, (ref_list, ref_set) in ref.items():
        assert [bits(kind, v) for v in lists[g]] == \
            [bits(kind, v) for v in ref_list]
        assert sorted_bits(kind, sets[g]) == sorted_bits(kind, ref_set)
        # the set keeps first-seen order: each value at its first row
        seen = [v for v in ref_list]
        firsts = []
        for v in seen:
            if not any(bits(kind, v) == bits(kind, u) or
                       (kind == "double" and v == u) or (v != v and u != u)
                       for u in firsts):
                firsts.append(v)
        assert [bits(kind, v) for v in sets[g]] == \
            [bits(kind, v) for v in firsts]


def test_global_and_empty_collects_give_lists():
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"g": np.array([1, 2, 1, 2, 3, 1]),
                             "v": [3.0, -0.0, float("nan"), 0.0, None, 3.0]},
                            num_partitions=2)
    got = df.agg(Alias(F.collect_list(col("g")), "l"),
                 Alias(F.collect_set(col("v")), "cs")).collect()
    assert got[0]["l"] == [1, 2, 1, 2, 3, 1]
    assert sorted_bits("double", got[0]["cs"]) == \
        sorted_bits("double", [3.0, -0.0, float("nan")])
    empty = df.filter(GreaterThan(col("g"), lit(99))).agg(
        Alias(F.collect_list(col("g")), "l"),
        Alias(F.collect_set(col("v")), "cs")).collect()
    assert empty == [{"l": [], "cs": []}]
    keyed = df.group_by("g").agg(Alias(F.collect_set(col("v")), "cs"),
                                 Alias(F.count(col("v")), "c")).collect()
    assert {r["g"]: (len(r["cs"]), r["c"]) for r in keyed} == \
        {1: (2, 3), 2: (1, 2), 3: (0, 0)}


def test_collect_runs_behind_the_raw_row_exchange():
    """At several partitions a collect is COMPLETE behind a hash exchange
    of the raw rows, as count(DISTINCT) is; lists keep row order within a
    reducer partition."""
    rng = np.random.default_rng(5)
    n = 600
    g = rng.integers(0, 13, n).astype(np.int64)
    v = rng.integers(0, 50, n).astype(np.int64)
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"g": g, "v": v}, num_partitions=3)
    plan = df.group_by("g").agg(Alias(F.collect_list(col("v")), "l"))
    assert "Exchange" in plan.explain()
    rows = {r["g"]: r["l"] for r in plan.collect()}
    one = {r["g"]: r["l"] for r in s.create_dataframe(
        {"g": g, "v": v}).group_by("g").agg(
        Alias(F.collect_list(col("v")), "l")).collect()}
    assert rows.keys() == one.keys()
    for k in rows:
        assert sorted(rows[k]) == sorted(one[k]) == sorted(v[g == k].tolist())
    assert one == {k: v[g == k].tolist() for k in one}


def test_unsupported_elements_and_array_inputs_are_refused_by_name():
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"g": [1, 2], "s": ["a", "b"],
                             "d": [decimal.Decimal("1.5"),
                                   decimal.Decimal("2.5")]})
    with pytest.raises(NotImplementedError, match="collect of StringType"):
        df.group_by("g").agg(F.collect_set(col("s"))).collect()
    with pytest.raises(NotImplementedError, match="decimal\\(38,18\\)"):
        df.group_by("g").agg(F.collect_list(col("d"))).collect()
    with pytest.raises(NotImplementedError, match="array input column"):
        s.create_dataframe({"a": [[1, 2], [3]]})
    with pytest.raises(NotImplementedError, match="Sort over the array"):
        df.group_by("g").agg(Alias(F.collect_list(col("g")), "l")) \
            .order_by("g").collect()
    with pytest.raises(NotImplementedError, match="collect_list"):
        G.collect(s.transfers.upload_column(host_column(["x"])), None, 1)
