"""row_number, rank and dense_rank over PARTITION BY ... ORDER BY on the
port (exec/window.py TorchWindowExec, ops/window_ops.py compute_windows
with order keys and window_rank's plain version, K14's ranking pass)
against the JAX package's windows (exec/window.py over ops/window_ops.py
compute_windows, on JAX-CPU), on the same seeded inputs, at one
partition.

Both sort stably by the partition keys, then the order keys, so rows are
compared in order, every value exactly (ranks are int32 on both sides).
The cases: ascending and descending order keys, nulls first and last,
ties, NaN, -0.0 and 0.0 as order keys (peers: -0.0 = 0.0, NaN = NaN, NaN
after +inf), string order keys (prefixes, an empty string, bytes above
0x7f), a computed partition key and a computed order key (K6), no
partition key, two order keys.  ``compute_windows`` itself is also held
against the JAX function on a seeded batch with many ties."""

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
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
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


RANKS = ("row_number", "rank", "dense_rank")


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def data(seed=5, n=60):
    """Few distinct values, so ties and whole peer groups are common."""
    rng = np.random.default_rng(seed)
    specials = [float("nan"), -0.0, 0.0, float("inf"), -1.5, 2.25, None]
    strings = ["", "a", "ab", "abc", "b", "ÿ", "abcdefghij", None]
    return {
        "g": [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(0, 4, n)],
        "i": [None if rng.random() < 0.15 else int(x)
              for x in rng.integers(-3, 4, n)],
        "d": [specials[x] for x in rng.integers(0, len(specials), n)],
        "s": [strings[x] for x in rng.integers(0, len(strings), n)],
        "id": list(range(n)),
    }


def both(jax_session, d, partition, order):
    """Rows of every column and the three ranking functions over
    ``Window.partition_by(*partition(f)).order_by(*order(f))``, on the
    JAX package and on the port (CPU)."""
    def build(f, df):
        w = f.Window.partition_by(*partition(f)).order_by(*order(f))
        cols = [f.col(c) for c in d]
        return df.select(*cols, *[getattr(f, r)().over(w).alias(r)
                                  for r in RANKS])
    ref = build(JF, jax_session.create_dataframe(d, num_partitions=1))
    got = build(F, TorchSession(device="cpu").create_dataframe(d))
    return ref.collect(), got


CASES = {
    "int asc nulls first": (lambda f: ["g"], lambda f: [f.asc("i")]),
    "int desc nulls last": (lambda f: ["g"], lambda f: [f.desc("i")]),
    "int asc nulls last": (lambda f: ["g"],
                           lambda f: [f.asc("i", nulls_first=False)]),
    "int desc nulls first": (lambda f: ["g"],
                             lambda f: [f.desc("i", nulls_first=True)]),
    "double specials asc": (lambda f: ["g"], lambda f: [f.asc("d")]),
    "double specials desc": (lambda f: ["g"], lambda f: [f.desc("d")]),
    "string asc": (lambda f: ["g"], lambda f: [f.asc("s")]),
    "string desc, partition by string": (lambda f: ["s"],
                                         lambda f: [f.desc("s")]),
    "two order keys": (lambda f: ["g"],
                       lambda f: [f.asc("s"), f.desc("i")]),
    "no partition key": (lambda f: [], lambda f: [f.asc("i")]),
    "computed keys": (
        lambda f: [_arith(f).Remainder(f.col("i"), f.lit(2))],
        lambda f: [f.asc(_arith(f).Multiply(f.col("d"), f.lit(-1.0)))]),
}


def _arith(f):
    if f is F:
        from spark_rapids_tpu_torch.expressions import arithmetic
    else:
        from spark_rapids_tpu.expressions import arithmetic
    return arithmetic


@pytest.mark.parametrize("case", list(CASES))
def test_ranking_matches_jax(jax_session, case):
    partition, order = CASES[case]
    ref, df = both(jax_session, data(), partition, order)
    got = df.collect()
    assert len(got) == len(ref) == 60
    assert rows_equal(ref, got, check_order=True, approx_float=False) \
        is None, (ref, got)
    assert all(isinstance(r[k], int) for r in got for k in RANKS)
    windows = [n for n in _nodes(df.executed_plan())
               if isinstance(n, TorchWindowExec)]
    assert len(windows) == 1 and windows[0].orders


def _nodes(node):
    yield node
    for c in node.children:
        yield from _nodes(c)


def test_compute_windows_matches_jax_function():
    """ops/window_ops.py compute_windows (K8, K7, the ranking pass's plain
    version) against the JAX function over one seeded batch: payload, two
    partition keys, a descending double order key with nulls last."""
    from spark_rapids_tpu.columnar.batch import batch_from_pydict
    from spark_rapids_tpu.ops.window_ops import compute_windows
    d = data(seed=11, n=300)
    cols = {"id": d["id"], "g": d["g"], "s": d["s"], "d": d["d"]}
    jb = batch_from_pydict(cols).to_device()
    out = compute_windows(jb, 1, 2, [(3, False, False)],
                          [(r,) for r in RANKS]).to_host()
    ref = [c.to_pylist() for c in out.columns]
    pb = TorchSession(device="cpu").create_dataframe(cols) \
        .collect_batch()
    from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
    tr = TransferGateway(torch.device("cpu"))
    dev = tr.upload_batch(pb)
    payload, outs = W.compute_windows(
        dev.columns[:1], dev.columns[1:3], [None] * 3,
        [W.WIN_ROW_NUMBER, W.WIN_RANK, W.WIN_DENSE_RANK], dev.row_count,
        dev.device, tr, dev.columns[3:4], [(False, False)])
    assert payload[0].data.tolist() == ref[0]
    for j, o in enumerate(outs):
        assert o.data.dtype == torch.int32 and bool(o.validity.all())
        assert o.data.tolist() == ref[1 + j], RANKS[j]


def test_rank_plain_edges():
    """0 and 1 rows; one partition of peers; every row its own peer."""
    for n in (0, 1):
        key = DeviceColumn(torch.zeros(n, dtype=torch.int64),
                           torch.ones(n, dtype=torch.bool), T.LONG, True)
        outs = W.window_rank([key], [key], list(W.RANKING), n,
                             torch.device("cpu"))
        assert [o.data.tolist() for o in outs] == [[1] * n] * 3
    n = 7
    same = DeviceColumn(torch.zeros(n, dtype=torch.int64),
                        torch.ones(n, dtype=torch.bool), T.LONG, True)
    apart = DeviceColumn(torch.arange(n), torch.ones(n, dtype=torch.bool),
                         T.LONG, True)
    rn, rk, dr = W.window_rank([], [same], list(W.RANKING), n,
                               torch.device("cpu"))
    assert rn.data.tolist() == list(range(1, n + 1))
    assert rk.data.tolist() == dr.data.tolist() == [1] * n
    rn, rk, dr = W.window_rank([same], [apart], list(W.RANKING), n,
                               torch.device("cpu"))
    assert rn.data.tolist() == rk.data.tolist() == dr.data.tolist() == \
        list(range(1, n + 1))


def test_windows_outside_the_port_are_refused_by_name():
    s = TorchSession(device="cpu")
    df = s.create_dataframe({"g": [1, 2], "v": [1.0, 2.0]})
    with pytest.raises(NotImplementedError, match="ORDER BY"):
        df.select(F.rank().over(F.Window.partition_by("g"))).explain()
    # running frames run (tests/test_torch_window_frames.py); a bounded
    # RANGE frame is refused, as the JAX package refuses it
    with pytest.raises(NotImplementedError, match="RANGE"):
        df.select(F.sum("v").over(F.Window.partition_by("g").order_by(
            "v").range_between(-1, 0))).explain()
    with pytest.raises(NotImplementedError, match="frame"):
        df.select(F.rank().over(F.Window.partition_by("g").order_by("v")
                                .rows_between(-1, 1))).explain()
