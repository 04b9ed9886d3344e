"""The left semi and left anti joins (exec/joins.py, K10's semi and anti
modes in ops/join_ops.py) against the JAX package's
DataFrame.join(how="semi"/"anti") (exec/joins.py:433-513 with
ops/join_ops.py matched_flags and unmatched_positions, on JAX-CPU), on
the same seeded inputs.

Rows are compared in order (both keep the left rows in their order),
exactly.  The cases: duplicate and null keys on both sides, no match at
all, an empty build side, an empty probe side, and one row each.  The
JAX package plans NOT IN as a plain anti join, so a null left key is kept
by anti and dropped by semi; so does the port."""

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


LEFT = T.StructType([T.StructField("k", T.LONG),
                     T.StructField("lv", T.DOUBLE),
                     T.StructField("ls", T.STRING)])
RIGHT = T.StructType([T.StructField("k", T.LONG),
                      T.StructField("rv", T.DOUBLE)])


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def jax_schema(schema):
    """The JAX package's schema of the port's ``schema``."""
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in schema.fields])


def side(rng, n, lo, hi, null_frac):
    return {"k": [None if rng.random() < null_frac else int(k)
                  for k in rng.integers(lo, hi, n)],
            "v": rng.standard_normal(n).round(3),
            "s": [None if rng.random() < 0.2 else "é" * int(x)
                  for x in rng.integers(0, 4, n)]}


CASES = {
    # name: (left rows, right rows, left key range, right key range,
    #        null fraction)
    "some match": (300, 40, (0, 60), (0, 60), 0.1),
    "duplicate keys on both sides": (200, 300, (0, 30), (0, 30), 0.1),
    "no match at all": (50, 20, (0, 10), (100, 120), 0.0),
    "null keys": (80, 30, (0, 20), (0, 20), 0.5),
    "empty build side": (25, 0, (0, 5), (0, 5), 0.2),
    "empty probe side": (0, 25, (0, 5), (0, 5), 0.2),
    "one row each": (1, 1, (3, 4), (3, 4), 0.0),
}


@pytest.mark.parametrize("how", ["semi", "anti"])
@pytest.mark.parametrize("case", list(CASES))
def test_semi_anti_join_matches_jax(jax_session, case, how):
    nl, nr, lk, rk, nulls = CASES[case]
    rng = np.random.default_rng(len(case))
    lsrc, rsrc = side(rng, nl, *lk, nulls), side(rng, nr, *rk, nulls)
    left = {"k": lsrc["k"], "lv": lsrc["v"], "ls": lsrc["s"]}
    right = {"k": rsrc["k"], "rv": rsrc["v"]}
    ref = jax_session.create_dataframe(left, jax_schema(LEFT)).join(
        jax_session.create_dataframe(right, jax_schema(RIGHT)), on="k",
        how=how).collect()
    s = TorchSession(device="cpu")
    df = s.create_dataframe(left, schema=LEFT).join(
        s.create_dataframe(right, schema=RIGHT), on="k", how=how)
    got = df.collect()
    assert rows_equal(ref, got, check_order=True) is None, (ref, got)
    assert df.columns == ["k", "lv", "ls"]
    join = df.executed_plan()
    assert isinstance(join, PJ.TorchHashJoinExec)
    assert join.how == {"semi": PJ.LEFT_SEMI, "anti": PJ.LEFT_ANTI}[how]
    keys = set(k for k in right["k"] if k is not None)
    kept = [i for i, k in enumerate(left["k"])
            if (k in keys) == (how == "semi")]
    assert [r["lv"] for r in got] == [left["lv"][i] for i in kept]


def key_col(values, dtype=torch.int64):
    valid = torch.tensor([v is not None for v in values], dtype=torch.bool)
    data = torch.tensor([0 if v is None else v for v in values],
                        dtype=dtype)
    return DeviceColumn(data, valid, T.LONG if dtype == torch.int64
                        else T.INT, all_valid=bool(valid.all()))


def test_modes_keep_each_row_once_in_probe_order():
    s = TorchSession(device="cpu")
    build = key_col([5, 7, 5, None, 9, 5])
    probe = key_col([5, 1, None, 7, 5, 8], torch.int32)
    before = s.transfers.stats()["syncs"]
    semi, none = J.join_pairs(build, probe, s.transfers, mode="semi")
    assert none is None and semi.tolist() == [0, 3, 4]
    anti, _ = J.join_pairs(build, probe, s.transfers, mode="anti")
    assert anti.tolist() == [1, 2, 5]
    # one sync each: the kept count sizes the output
    assert s.transfers.stats()["syncs"] - before == 2
    # an empty build side: semi keeps nothing, anti everything
    assert J.join_pairs(key_col([]), probe, s.transfers,
                        mode="semi")[0].tolist() == []
    assert J.join_pairs(key_col([]), probe, s.transfers,
                        mode="anti")[0].tolist() == list(range(6))
    with pytest.raises(ValueError, match="join mode"):
        J.join_pairs(build, probe, s.transfers, outer=True, mode="semi")


@pytest.mark.parametrize("how", ["semi", "leftsemi", "left_semi", "anti",
                                 "leftanti", "left_anti"])
def test_semi_anti_build_on_the_right_whatever_the_sizes(monkeypatch, how):
    seen = []
    real = PJ.join_pairs

    def spy(build, probe, transfers, outer=False, mode=None):
        seen.append((build.row_count, probe.row_count, mode))
        return real(build, probe, transfers, outer, mode)
    monkeypatch.setattr(PJ, "join_pairs", spy)
    s = TorchSession(device="cpu")
    small = s.create_dataframe({"k": np.arange(3, dtype=np.int64)})
    big = s.create_dataframe({"k": np.arange(50, dtype=np.int64) % 7,
                              "w": np.arange(50, dtype=np.int64)})
    rows = small.join(big, on="k", how=how).collect()
    mode = "semi" if "semi" in how else "anti"
    assert seen == [(50, 3, mode)]
    assert rows == ([{"k": 0}, {"k": 1}, {"k": 2}] if mode == "semi"
                    else [])


@pytest.mark.parametrize("how", ["right", "full_outer", "cross"])
def test_other_join_types_stay_refused_by_name(how):
    s = TorchSession(device="cpu")
    a = s.create_dataframe({"k": np.arange(3, dtype=np.int64)})
    # a cross join runs (tests/test_torch_cross_join.py), but not on keys
    refused = (ValueError, "cross join takes no keys") if how == "cross" \
        else (NotImplementedError, f"{how} joins")
    with pytest.raises(refused[0], match=refused[1]):
        a.join(a, on="k", how=how).collect()
