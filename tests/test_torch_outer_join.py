"""The left outer join (exec/joins.py, K10's outer mode in
ops/join_ops.py, K7's null rows in ops/batch_ops.py) against the JAX
package's DataFrame.join(how="left_outer") (exec/joins.py with
ops/join_ops.py matched_flags, unmatched_positions and
concat_matched_unmatched, on JAX-CPU), on the same seeded inputs.

Rows are compared without regard to order (the JAX package puts the
matched pairs first and the unmatched rows after them; the port keeps
each unmatched row in its probe row's place), exactly.  The cases: no
match at all, null probe keys, duplicate build keys, an empty build
side, an empty probe side, and string columns on the null-extended
side."""

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
from spark_rapids_tpu_torch.ops import batch_ops as BO
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
                     T.StructField("lv", T.DOUBLE)])
RIGHT = T.StructType([T.StructField("k", T.LONG),
                      T.StructField("rv", T.DOUBLE),
                      T.StructField("rs", T.STRING)])


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def jax_schema(schema):
    """The JAX package's schema of the port's ``schema``."""
    from spark_rapids_tpu import types as JT
    return JT.StructType([
        JT.StructField(f.name, getattr(JT, type(f.data_type).__name__)())
        for f in schema.fields])


def side(rng, n, lo, hi, null_frac, strings=False):
    keys = [None if rng.random() < null_frac else int(k)
            for k in rng.integers(lo, hi, n)]
    out = {"k": keys, "v": rng.standard_normal(n).round(3)}
    if strings:
        out["s"] = [None if rng.random() < 0.2 else "é" * int(x)
                    for x in rng.integers(0, 4, n)]
    return out


CASES = {
    # name: (left rows, right rows, left key range, right key range,
    #        null fraction)
    "some match": (300, 40, (0, 60), (0, 60), 0.1),
    "duplicate build keys": (200, 300, (0, 30), (0, 30), 0.1),
    "no match at all": (50, 20, (0, 10), (100, 120), 0.0),
    "null probe keys": (80, 30, (0, 20), (0, 20), 0.5),
    "empty build side": (25, 0, (0, 5), (0, 5), 0.2),
    "empty probe side": (0, 25, (0, 5), (0, 5), 0.2),
}


@pytest.mark.parametrize("case", list(CASES))
def test_left_outer_join_matches_jax(jax_session, case):
    nl, nr, lk, rk, nulls = CASES[case]
    rng = np.random.default_rng(len(case))
    lsrc, rsrc = side(rng, nl, *lk, nulls), side(rng, nr, *rk, nulls, True)
    left = {"k": lsrc["k"], "lv": lsrc["v"]}
    right = {"k": rsrc["k"], "rv": rsrc["v"], "rs": rsrc["s"]}
    ref = jax_session.create_dataframe(left, jax_schema(LEFT)).join(
        jax_session.create_dataframe(right, jax_schema(RIGHT)), on="k",
        how="left_outer").collect()
    s = TorchSession(device="cpu")
    df = s.create_dataframe(left, schema=LEFT).join(
        s.create_dataframe(right, schema=RIGHT), on="k", how="left")
    got = df.collect()
    assert len(got) >= nl
    assert rows_equal(ref, got, check_order=False) is None, (ref, got)
    assert df.columns == ["k", "lv", "rv", "rs"]
    join = df.executed_plan().children[0]
    assert isinstance(join, PJ.TorchHashJoinExec)
    assert join.how == PJ.LEFT_OUTER


def key_col(values, dtype=torch.int64):
    valid = torch.tensor([v is not None for v in values], dtype=torch.bool)
    data = torch.tensor([0 if v is None else v for v in values],
                        dtype=dtype)
    return DeviceColumn(data, valid, T.LONG if dtype == torch.int64
                        else T.INT, all_valid=bool(valid.all()))


def test_outer_pairs_keep_each_unmatched_row_in_place():
    s = TorchSession(device="cpu")
    build = key_col([5, 7, 5, None, 9])
    probe = key_col([5, 1, None, 7, 5, 8], torch.int32)
    p, b = J.join_pairs(build, probe, s.transfers, outer=True)
    assert p.tolist() == [0, 0, 1, 2, 3, 4, 4, 5]
    assert b.tolist() == [0, 2, -1, -1, 1, 0, 2, -1]
    inner = J.join_pairs(build, probe, s.transfers)
    assert inner[0].tolist() == [0, 0, 3, 4, 4]
    # an empty build side null-extends every probe row
    p, b = J.join_pairs(key_col([]), probe, s.transfers, outer=True)
    assert p.tolist() == list(range(6)) and b.tolist() == [-1] * 6


def test_gather_writes_a_null_row_for_minus_one():
    from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
    s = TorchSession(device="cpu")
    hb = batch_from_pydict({"v": [1.5, None, 3.0], "s": ["ab", "", None]})
    cols = s.transfers.upload_batch(hb).columns
    idx = torch.tensor([2, -1, 0, -1, 1], dtype=torch.int64)
    out = BO.gather_columns(cols, idx, s.transfers, nullable=True)
    assert out[0].validity.tolist() == [True, False, True, False, False]
    assert out[0].data.tolist()[1] == out[0].data.tolist()[3] == 0.0
    assert out[1].offsets.tolist() == [0, 0, 0, 2, 2, 2]
    assert out[1].validity.tolist() == [False, False, True, False, True]
    assert not out[0].all_valid and not out[1].all_valid
    # from an empty side every row is null
    empty = s.transfers.upload_batch(hb.slice(0, 0)).columns
    out = BO.gather_columns(empty, torch.full((3,), -1), s.transfers,
                            nullable=True)
    assert out[0].validity.tolist() == [False] * 3
    assert out[1].offsets.tolist() == [0, 0, 0, 0]


def test_left_outer_builds_on_the_right_whatever_the_sizes(monkeypatch):
    seen = []
    real = PJ.join_pairs

    def spy(build, probe, transfers, outer=False):
        seen.append((build.row_count, probe.row_count, outer))
        return real(build, probe, transfers, outer)
    monkeypatch.setattr(PJ, "join_pairs", spy)
    s = TorchSession(device="cpu")
    small = s.create_dataframe({"k": np.arange(3, dtype=np.int64)})
    big = s.create_dataframe({"k": np.arange(50, dtype=np.int64) % 7,
                              "w": np.arange(50, dtype=np.int64)})
    rows = small.join(big, on="k", how="left_outer").collect()
    assert seen == [(50, 3, True)]
    assert len(rows) == 8 + 7 + 7   # key 0 eight times, 1 and 2 seven
