"""Running, bounded and offset window frames on the port (exec/window.py
lower_window_expr, ops/window_ops.py compute_windows with the plain
versions of K14s, K14b and K14o) against the JAX package.

- The single-batch cases of tests/test_window.py, each run through both
  packages' DataFrame API on the same data at 1 and 2 partitions, the
  JAX side on its CPU engine (``spark.rapids.sql.enabled`` false, the
  numpy oracle its own tests hold its device path to): ntile, lag and
  lead with and without a default, the default RANGE frame and the whole
  partition of sum, min, max, count and avg, every bounded frame of
  test_bounded_rows_frames, the three unbounded ROWS frames, two specs
  in one select, no partition key, string partition keys, a descending
  order, int sums, the larger random case, NaN order-key peers and the
  NaN/inf sums.  Rows are compared as sets (the engines' exchanges place
  partitions apart) under rowcompare.rows_equal: keys, counts and ranks
  exact, doubles within 1e-6 relative.
- ``compute_windows`` against the JAX ``compute_windows`` on JAX-CPU over
  one seeded batch whose largest partition spans more than three tiles
  of 1024 rows, with NaN, +-inf, -0.0 and nulls: every new kind in one
  JAX program, rows in order.
- What the JAX package refuses, the port refuses by name."""

import datetime
import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.ops import window_ops as W


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


def _data():
    return {
        "g": [1, 1, 1, 2, 2, None, 3, 3, 3, 3],
        "o": [3, 1, 2, 5, 5, 1, None, 2, 9, 4],
        "v": [1.0, 2.0, None, 4.0, 5.0, 6.0, 7.0, None, 9.0, 10.0],
    }


def _larger():
    rng = np.random.default_rng(7)
    n = 4000
    return {"g": rng.integers(0, 50, n), "o": rng.integers(0, 1000, n),
            "v": rng.normal(size=n)}


def w_go(f):
    return f.Window.partition_by("g").order_by("o")


AGGS = ("sum", "min", "max", "count", "avg")
BOUNDED = [(-1, 1), (-2, 0), (0, 2), (-3, -1), (1, 3)]


def _case_table():
    """name -> (data, build(functions module, DataFrame))."""
    cases = {
        "ntile": (_data, lambda f, df: df.select(
            f.col("g"), f.col("o"), f.ntile(3).over(w_go(f)).alias("t"))),
        "lag_lead_default": (_data, lambda f, df: df.select(
            f.col("g"), f.col("o"),
            f.lag("v", 1, -99.0).over(w_go(f)).alias("lg"),
            f.lead("v", 2, -1.0).over(w_go(f)).alias("ld"))),
        "unbounded_sum": None, "unbounded_min": None, "unbounded_max": None,
        "multiple_specs": (_data, lambda f, df: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            f.row_number().over(w_go(f)).alias("rn"),
            f.sum("v").over(f.Window.partition_by("o").order_by("g"))
            .alias("s2"))),
        "no_partition": (_data, lambda f, df: df.select(
            f.col("o"), f.col("v"),
            f.row_number().over(f.Window.order_by("o", "v")).alias("rn"),
            f.sum("v").over(f.Window.order_by("o", "v")).alias("rs"))),
        "string_partition_keys": (lambda: {
            "g": ["a", "a", "b", None, "b", "a"], "o": [3, 1, 2, 5, 4, 2],
            "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]}, lambda f, df: df.select(
                f.col("g"), f.col("o"),
                f.row_number().over(w_go(f)).alias("rn"),
                f.sum("v").over(w_go(f)).alias("rs"))),
        "desc_order": (_data, lambda f, df: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            f.row_number().over(f.Window.partition_by("g").order_by(
                f.desc("o"))).alias("rn"),
            f.max("v").over(f.Window.partition_by("g").order_by(
                f.desc("o"))).alias("mx"))),
        "int_sum_types": (lambda: {
            "g": [1, 1, 2, 2], "o": [1, 2, 1, 2],
            "i": np.array([5, 6, 7, 8], dtype=np.int32)},
            lambda f, df: df.select(
                f.col("g"), f.sum("i").over(w_go(f)).alias("s"),
                f.count("*").over(w_go(f)).alias("c"),
                f.min("i").over(w_go(f)).alias("mn"))),
        "larger_random": (_larger, lambda f, df: df.select(
            f.col("g"), f.col("o"),
            f.row_number().over(w_go(f)).alias("rn"),
            f.sum("v").over(w_go(f).rows_between(-3, 3)).alias("s"))),
        "nan_order_key_peers": (lambda: {
            "g": [1, 1, 1, 1], "o": [float("nan"), float("nan"), 1.0, 2.0],
            "v": [1.0, 2.0, 3.0, 4.0]}, lambda f, df: df.select(
                f.col("o"), f.rank().over(w_go(f)).alias("r"),
                f.sum("v").over(w_go(f)).alias("rs"))),
        "nan_inf_no_poison": (lambda: {
            "g": [0, 0, 0, 1, 1, 2, 2, 3, 3], "o": list(range(9)),
            "v": [1.0, float("nan"), 2.0, float("inf"), 3.0, float("-inf"),
                  float("inf"), 4.0, 5.0]}, lambda f, df: df.select(
                f.col("g"), f.col("o"), *[getattr(f, a)("v").over(
                    w_go(f).rows_between(f.Window.unboundedPreceding,
                                         f.Window.currentRow)).alias(a)
                    for a in ("sum", "avg", "min", "max")])),
    }
    for off in (1, 2):
        cases[f"lag_lead_{off}"] = (_data, lambda f, df, off=off: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            f.lag("v", off).over(w_go(f)).alias("lg"),
            f.lead("v", off).over(w_go(f)).alias("ld")))
    for a in AGGS:
        cases[f"running_{a}"] = (_data, lambda f, df, a=a: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            getattr(f, a)("v").over(w_go(f)).alias("a")))
        cases[f"whole_{a}"] = (_data, lambda f, df, a=a: df.select(
            f.col("g"), f.col("v"),
            getattr(f, a)("v").over(f.Window.partition_by("g"))
            .alias("a")))
        for lo, hi in BOUNDED:
            cases[f"bounded_{a}_{lo}_{hi}"] = (
                _data, lambda f, df, a=a, lo=lo, hi=hi: df.select(
                    f.col("g"), f.col("o"), f.col("v"),
                    getattr(f, a)("v").over(w_go(f).rows_between(lo, hi))
                    .alias("a")))
    for a in ("sum", "min", "max"):
        cases[f"unbounded_{a}"] = (_data, lambda f, df, a=a: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            getattr(f, a)("v").over(w_go(f).rows_between(
                f.Window.unboundedPreceding, f.Window.currentRow))
            .alias("run"),
            getattr(f, a)("v").over(w_go(f).rows_between(
                0, f.Window.unboundedFollowing)).alias("rev"),
            getattr(f, a)("v").over(w_go(f).rows_between(
                f.Window.unboundedPreceding, f.Window.unboundedFollowing))
            .alias("all")))
    return cases


CASES = _case_table()


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("case", list(CASES))
def test_window_case_matches_jax(jax_session, case, parts):
    data, build = CASES[case]
    d = data()
    ref = build(JF, jax_session.create_dataframe(d, num_partitions=parts)
                ).collect()
    got = build(F, TorchSession(device="cpu").create_dataframe(
        d, num_partitions=parts)).collect()
    assert len(got) == len(ref) > 0
    assert rows_equal(ref, got, check_order=False, approx_float=True) \
        is None, (ref, got)


def frame_batch(seed=19, n=3600):
    """Partition keys (runs of 1 to 12 rows, one of 3,300 rows), an order
    key with ties, doubles with NaN, +-inf, -0.0 and nulls, longs, ints
    and dates with nulls, in a random row order."""
    rng = np.random.default_rng(seed)
    sizes = [3300]
    while sum(sizes) < n:
        sizes.append(int(rng.integers(1, 13)))
    g = np.repeat(np.arange(len(sizes)), sizes)[:n]
    perm = rng.permutation(n)
    specials = [float("nan"), float("inf"), float("-inf"), -0.0, None]
    v = [specials[int(x)] if rng.random() < 0.12 else float(y)
         for x, y in zip(rng.integers(0, 5, n), rng.normal(size=n) * 50)]
    ints = rng.integers(-1000, 1000, n)
    valid = rng.random(n) > 0.15
    first = datetime.date(1999, 1, 1)
    cols = {
        "id": list(range(n)),
        "g": g[perm].tolist(),
        "o": rng.integers(0, n, n)[perm].tolist(),
        "v": [v[p] for p in perm],
        "l": [int(x) * 3_000_000_000 if ok else None
              for x, ok in zip(ints, valid)],
        "i": [int(x) if ok else None for x, ok in zip(ints, valid)],
        "d": [first + datetime.timedelta(days=int(x) + 1000) if ok else None
              for x, ok in zip(ints, valid)],
    }
    return cols


def test_compute_windows_matches_jax_function():
    """ops/window_ops.py compute_windows (K8, K7, the plain K14s, K14b and
    K14o) against the JAX compute_windows on JAX-CPU over one batch: the
    payload, one partition key, an order key, every new kind at once."""
    from spark_rapids_tpu.columnar.batch import batch_from_pydict
    from spark_rapids_tpu.ops.window_ops import compute_windows
    cols = frame_batch()
    n = len(cols["id"])
    # batch columns: id (payload), g (key), o (order), v, l, i, d
    V, L, I, D = 3, 4, 5, 6
    funcs = []   # (JAX func, port kind, port input ordinal)
    sums = [("sum", W.WIN_SUM_F64, V), ("count", W.WIN_COUNT, V),
            ("mean", W.WIN_MEAN, V), ("sum", W.WIN_SUM_I64, L)]

    def extremes(*inputs):
        return [(a, k, c) for a, k in (("min", W.WIN_MIN),
                                       ("max", W.WIN_MAX)) for c in inputs]
    # each frame with the kinds that matter there (one JAX program: its
    # compile time grows with the functions, a bounded min/max by the
    # frame's width)
    for (fk, lo, hi), aggs in (
            (("rows", None, 0), sums + extremes(V, L, I, D)),
            (("range", None, 0), sums[:2] + extremes(V)),
            (("rows", None, 2), sums),
            (("rows", 0, None), sums[:1] + extremes(V, L)),
            (("rows", 2, None), sums[:2]),
            (("rows", None, None), extremes(V, I)),
            (("rows", -2, 1), sums + extremes(V, L)),
            (("rows", -4, -3), sums[:1] + extremes(V)[:1]),
            (("rows", 1, 5), sums[1:2] + extremes(D)[1:])):
        for agg, kind, c in aggs:
            funcs.append((("agg", agg, c, fk, lo, hi, True),
                          W.FrameAgg(kind, fk, lo, hi), c))
    funcs.append((("agg", "count", V, "rows", -1, 1, False),
                  W.FrameAgg(W.WIN_COUNT_ALL, "rows", -1, 1), None))
    for t in (1, 3, 7, 5000):
        funcs.append((("ntile", t), W.NTileFn(t), None))
    for off, dflt, c in ((-1, None, V), (2, None, I), (-3, -7.5, V),
                         (1, -(2 ** 40), L), (-2, 17, I)):
        funcs.append((("offset", c, off, dflt), W.OffsetFn(off, dflt), c))
    jb = batch_from_pydict(cols).to_device()
    out = compute_windows(jb, 1, 1, [(2, True, True)],
                          [f for f, _k, _c in funcs]).to_host()
    ref = [c.to_pylist() for c in out.columns]
    from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
    pb = TorchSession(device="cpu").create_dataframe(cols).collect_batch()
    tr = TransferGateway(torch.device("cpu"))
    dev = tr.upload_batch(pb)
    c = dev.columns
    payload, outs = W.compute_windows(
        c[:1], c[1:2], [None if j is None else c[j] for _f, _k, j in funcs],
        [k for _f, k, _j in funcs], n, dev.device, tr, c[2:3],
        [(True, True)])
    assert payload[0].data.tolist() == ref[0]
    from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
    got = tr.download_batch(ColumnarBatch(
        outs, n, [f"f{j}" for j in range(len(outs))])).to_rows()
    for j, (f, _k, _c) in enumerate(funcs):
        mine = [r[f"f{j}"] for r in got]
        theirs = ref[1 + j]
        if f[0] == "agg" and f[1] in ("min", "max") and f[2] == D:
            theirs = [None if x is None else
                      datetime.date(1970, 1, 1) + datetime.timedelta(days=x)
                      if isinstance(x, int) else x for x in theirs]
        assert rows_equal([{"x": x} for x in theirs],
                          [{"x": x} for x in mine], check_order=True,
                          approx_float=True) is None, (f, theirs, mine)


def test_frames_outside_the_jax_program_are_refused_by_name():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(_data())
    w = F.Window.partition_by("g").order_by("o")
    with pytest.raises(NotImplementedError, match="RANGE"):
        df.select(F.sum("v").over(w.range_between(-1, 0)).alias("a")) \
            .collect()
    with pytest.raises(NotImplementedError, match="min/max"):
        df.select(F.max("v").over(w.rows_between(
            -1, F.Window.unboundedFollowing)).alias("a")).collect()
    with pytest.raises(NotImplementedError, match="min/max"):
        df.select(F.min("v").over(w.rows_between(
            F.Window.unboundedPreceding, 2)).alias("a")).collect()
    strings = s.create_dataframe({"g": [1, 1], "o": [1, 2],
                                  "s": ["a", "b"]})
    with pytest.raises(NotImplementedError, match="lag/lead default"):
        strings.select(F.lag("s", 1, "z").over(w).alias("a")).collect()
    with pytest.raises(TypeError, match="lag/lead default type"):
        df.select(F.lag("v", 1, 3).over(w).alias("a")).collect()
    with pytest.raises(NotImplementedError, match="StringType"):
        strings.select(F.max("s").over(w).alias("a")).collect()
    # a group-by refuses a string min, as the JAX device path does
    with pytest.raises(NotImplementedError,
                       match="min/max over strings not on device yet"):
        strings.group_by("g").agg(F.min("s").alias("m")).collect()


def test_window_plain_edges():
    """Zero rows, one row, empty frames (null, count 0) and ntile with
    more tiles than rows, in the plain versions."""
    dev = torch.device("cpu")
    for n in (0, 1):
        key = W_col(torch.zeros(n, dtype=torch.int64), T.LONG)
        x = W_col(torch.ones(n, dtype=torch.float64), T.DOUBLE)
        out, = W.window_running([key], [], [W.FrameAgg(W.WIN_SUM_F64)],
                                [x], n, dev)
        assert out.data.tolist() == [1.0] * n
        out, = W.window_bounded([key], [W.FrameAgg(W.WIN_COUNT, "rows", 1,
                                                   3)], [x], n, dev)
        assert out.data.tolist() == [0] * n
        assert W.window_ntile([key], [5], n, dev)[0].data.tolist() == \
            [1] * n
    key = W_col(torch.tensor([0, 0, 1]), T.LONG)
    x = W_col(torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64), T.DOUBLE)
    s, c = W.window_bounded([key], [W.FrameAgg(W.WIN_SUM_F64, "rows", 1, 2),
                                    W.FrameAgg(W.WIN_COUNT, "rows", 1, 2)],
                            [x, x], 3, dev)
    assert s.validity.tolist() == [True, False, False]
    assert s.data.tolist()[0] == 2.0 and c.data.tolist() == [1, 0, 0]


def W_col(data, dtype):
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    return DeviceColumn(data, torch.ones(data.shape[0], dtype=torch.bool),
                        dtype, True)
