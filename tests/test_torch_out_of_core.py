"""The port's out-of-core paths on the CPU against the JAX package (data
made from seeds by numpy; the port's sessions on ``device="cpu"`` run
every kernel's plain version):

- K14c's plain version (``ops/window_ops.py running_fixup_plain``)
  against the JAX ``exec/window.py _make_running_fixup`` on JAX-CPU, over
  the same sorted stream cut into chunks (``testing/fixup_cases.py``: the
  first form, a chunk continuing the carry whole, a group boundary at a
  chunk's row 0, a group and a peer run across a boundary; int, string
  and long partition keys with nulls, a double order key with NaN,
  +-inf, -0.0 and nulls; every kind): the fixed columns and the next
  carry's rows, rank, dense rank and aggregates, doubles within 1e-12
  relative.
- The running windows of tests/test_window.py:240-326 (RUNNING_CONF,
  merge batches of 700 rows) and the bounded ones of ``:351-440``
  (BOUNDED_CONF, the OOM-injection case as two injected RetryOOMs inside
  the path's retry frames), at 1 and 2 partitions, against the JAX CPU
  engine under rowcompare.rows_equal; the engagement counters asserted.
- The external sort (forceOutOfCore, a 64 KiB pool so the input makes
  several runs; ascending and descending keys, nulls first and last,
  NaN, strings of 0 to 2 bytes in the first half and up to 29 in the
  second) against the JAX sort, in order.
- The out-of-core FINAL merge at 2 partitions under
  FORCE_REPARTITION_BELOW_DEPTH, and under an injected SplitAndRetryOOM
  (its attempt re-partitions), against the JAX DataFrame.
- q51 at sf 1 under a 128 KiB pool, where all three windows (and the
  final sort) run out of core and, at 2 partitions, the FINAL group-bys
  re-partition, against the JAX package's ``sql(Q51_SQL)`` on its CPU
  engine and the port's in-memory run."""

import datetime
import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu.testing.tpcds import register_tables
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.exec import aggregate as A
from spark_rapids_tpu_torch.exec import sort as SX
from spark_rapids_tpu_torch.exec import window as WX
from spark_rapids_tpu_torch.memory import device_manager as DM
from spark_rapids_tpu_torch.memory import retry as R
from spark_rapids_tpu_torch.ops import window_ops as W
from spark_rapids_tpu_torch.testing import fixup_cases as FC
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
    """The plain versions run many small tensor ops; one intra-op thread
    a worker keeps them from contending for the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_runtime():
    """Each test shapes the memory runtime with its own session's pool,
    and leaves none behind for the next module."""
    DM.shutdown()
    yield
    DM.shutdown()
    ctx = R.task_context()
    ctx.inject_retry_oom = ctx.inject_split_oom = 0


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "false"})


@pytest.fixture
def merge_rows_700():
    prev = SX._MERGE_OUT_ROWS
    SX._MERGE_OUT_ROWS = 700
    yield
    SX._MERGE_OUT_ROWS = prev


# -- K14c's plain version against the JAX _make_running_fixup --

_JAX_FUNCS = {W.FIX_ROW_NUMBER: ("row_number",), W.FIX_RANK: ("rank",),
              W.FIX_DENSE_RANK: ("dense_rank",),
              W.FIX_SUM: ("agg", "sum", -1, "rows", None, 0, False),
              W.FIX_COUNT: ("agg", "count", -1, "rows", None, 0, False),
              W.FIX_MIN: ("agg", "min", -1, "rows", None, 0, False),
              W.FIX_MAX: ("agg", "max", -1, "rows", None, 0, False)}
_JAX_TYPES = {T.INT: JT.INT, T.LONG: JT.LONG, T.DOUBLE: JT.DOUBLE,
              T.STRING: JT.STRING}
SIZES = (0, 1, 100, 500, 100)


def _jax_chunks(pk, ok, kinds, outs, transfers):
    """The JAX program over the same chunks in turn (the empty first
    chunk skipped: the JAX program is never given one): per chunk the
    fixed (data, validity) numpy planes and the carry."""
    import jax.numpy as jnp
    from spark_rapids_tpu.columnar.batch import batch_from_pydict
    from spark_rapids_tpu.exec.window import _make_running_fixup
    keys = transfers.download_batch(ColumnarBatch(
        list(pk) + list(ok), pk[0].row_count,
        [f"k{j}" for j in range(len(pk) + len(ok))]))
    key_lists = [c.to_pylist() for c in keys.columns]
    key_types = [_JAX_TYPES[c.data_type] for c in keys.columns]
    win = [(c.data.numpy(), c.validity.numpy()) for c in outs]
    win_types = [JT.INT if k in W.FIX_RANKING else
                 _JAX_TYPES[c.data_type]
                 for k, c in zip(kinds, outs)]
    schema = JT.StructType([JT.StructField(f"k{j}", t, True)
                            for j, t in enumerate(key_types)])
    carry, out, start = None, [], 0
    for n in SIZES:
        if n == 0:
            continue
        kb = batch_from_pydict({f"k{j}": key_lists[j][start:start + n]
                                for j in range(len(key_lists))},
                               schema).to_device()
        bucket = kb.bucket
        fn = _make_running_fixup([c.data_type for c in kb.columns], len(pk),
                                 [_JAX_FUNCS[k] for k in kinds], win_types,
                                 bucket, first=carry is None)
        arrs = [(jnp.asarray(np.pad(d[start:start + n], (0, bucket - n))),
                 jnp.asarray(np.pad(v[start:start + n], (0, bucket - n))))
                for d, v in win]
        fixed, carry = fn([(c.data, c.validity, c.lengths)
                           for c in kb.columns], arrs, n, carry)
        out.append(([(np.asarray(d)[:n], np.asarray(v)[:n])
                     for d, v in fixed], carry))
        start += n
    return out


def _same_values(got_d, got_v, ref_d, ref_v, what):
    assert np.array_equal(got_v, ref_v), what
    g, r = got_d[ref_v], ref_d[ref_v]
    if r.dtype.kind == "f":
        assert np.array_equal(np.isnan(g), np.isnan(r)), what
        ok = ~np.isnan(r)
        assert np.allclose(g[ok], r[ok], rtol=1e-12, atol=0), what
    else:
        assert np.array_equal(g, r), what


@pytest.mark.parametrize("which", ["A", "B"])
def test_running_fixup_plain_matches_jax(which):
    cpu = TransferGateway(torch.device("cpu"))
    rng = np.random.default_rng(41)
    pk, ok, outs_a, outs_b = FC.stream(rng, "cpu", cpu, SIZES)
    # the string key last: the JAX program compares the carried key words
    # as one flat list over every key column, zero-extending the shorter
    # side at its end, so a string key of another chunk width followed by
    # another key shifts the words it compares (ROADMAP queue 3); with
    # the string last its zero-extension is right
    pk = [pk[0], pk[2], pk[1]]
    kinds, outs = (FC.KINDS_A, outs_a) if which == "A" else \
        (FC.KINDS_B, outs_b)
    got = [g for g, n in zip(FC.run_stream(
        W.running_fixup_plain, pk, ok, kinds, outs, cpu, SIZES), SIZES)
        if n]
    ref = _jax_chunks(pk, ok, kinds, outs, cpu)
    assert len(got) == len(ref) == 4
    for c, ((fixed, carry), (jfixed, jcarry)) in enumerate(zip(got, ref)):
        for j, (col, (d, v)) in enumerate(zip(fixed, jfixed)):
            _same_values(col.data.numpy(), col.validity.numpy(), d, v,
                         f"chunk {c} column {j}")
        assert int(carry.state[0]) == int(jcarry["rows"])
        if W.FIX_RANK in kinds:
            assert int(carry.state[1]) == int(jcarry["rank"])
        if W.FIX_DENSE_RANK in kinds:
            assert int(carry.state[2]) == int(jcarry["dense"])
        aggs = [v for v in carry.values if v is not None]
        jaggs = jcarry["aggs"]
        assert len(jaggs) == 2 * len(aggs)
        for j, (d, v) in enumerate(aggs):
            _same_values(d.numpy(), v.numpy(),
                         np.asarray(jaggs[2 * j]).reshape(1),
                         np.asarray(jaggs[2 * j + 1]).reshape(1),
                         f"chunk {c} carry {j}")
    # the chunk that continues the carry whole (L == n) and the last
    # chunk's group across the boundary
    assert int(got[1][1].state[0]) == 101
    assert int(got[3][1].state[0]) > 100


def test_running_fixup_plain_key_order():
    """The port compares each key column by itself (strings byte for
    byte), so the order of the partition keys changes nothing, also
    where the JAX program's flat word list would misalign (a string key
    between others, chunks of other string widths)."""
    cpu = TransferGateway(torch.device("cpu"))
    rng = np.random.default_rng(41)
    pk, ok, outs_a, _b = FC.stream(rng, "cpu", cpu, SIZES)
    one = FC.run_stream(W.running_fixup_plain, pk, ok, FC.KINDS_A, outs_a,
                        cpu, SIZES)
    two = FC.run_stream(W.running_fixup_plain, [pk[0], pk[2], pk[1]], ok,
                        FC.KINDS_A, outs_a, cpu, SIZES)
    for (f1, c1), (f2, c2) in zip(one, two):
        for a, b in zip(f1, f2):
            assert torch.equal(a.validity, b.validity)
            zero = torch.zeros((), dtype=a.data.dtype)
            assert torch.equal(
                torch.where(a.validity, a.data, zero).view(torch.uint8),
                torch.where(b.validity, b.data, zero).view(torch.uint8))
        assert (c1 is None) == (c2 is None)
        if c1 is not None:
            assert torch.equal(c1.state, c2.state)
    # the last chunk continues the group the chunk before it ends with
    assert int(one[-1][1].state[0]) > SIZES[-1]


# -- the running and bounded windows of tests/test_window.py --

RUNNING_CONF = {"spark.rapids.sql.test.window.forceRunning": "true",
                "spark.rapids.sql.test.sort.forceOutOfCore": "true"}
BOUNDED_CONF = {"spark.rapids.sql.test.window.forceBoundedBatched": "true",
                "spark.rapids.sql.test.sort.forceOutOfCore": "true"}


def _big_data(n=6000, ngroups=7, seed=2):
    rng = np.random.default_rng(seed)
    g = rng.integers(0, ngroups, n)
    o = rng.integers(0, 50, n)
    v = rng.normal(size=n)
    v = np.where(rng.random(n) < 0.04, np.nan, v)
    vmask = rng.random(n) < 0.08
    return {"g": g, "o": o,
            "v": [None if m else float(x) for x, m in zip(v, vmask)]}


def w_go(f):
    return f.Window.partition_by("g").order_by("o")


def running(f):
    return w_go(f).rows_between(f.Window.unboundedPreceding,
                                f.Window.currentRow)


def _single_group(n, seed, order):
    rng = np.random.default_rng(seed)
    return {"g": np.ones(n, dtype=np.int64), "o": order(n),
            "v": rng.integers(0, 10 if seed == 9 else 100, n)
            .astype(np.int64)}


def _running_cases():
    unique = _big_data(3000)
    unique["o"] = np.arange(3000)
    return {
        "ranks": (_big_data(3000), lambda f, df: df.select(
            f.col("g"), f.col("o"),
            f.row_number().over(w_go(f)).alias("rn"),
            f.rank().over(w_go(f)).alias("r"),
            f.dense_rank().over(w_go(f)).alias("dr"))),
        "aggs": (unique, lambda f, df: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            f.sum("v").over(running(f)).alias("rs"),
            f.count("v").over(running(f)).alias("rc"),
            f.min("v").over(running(f)).alias("rmin"),
            f.max("v").over(running(f)).alias("rmax"))),
        "single_group": (_single_group(3000, 9, lambda n: np.arange(n) % 97),
                         lambda f, df: df.select(
                             f.col("o"),
                             f.row_number().over(w_go(f)).alias("rn"),
                             f.rank().over(w_go(f)).alias("r"),
                             f.sum("v").over(running(f)).alias("rs"))),
        "not_eligible": (_big_data(1500), lambda f, df: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            f.lag("v", 1).over(w_go(f)).alias("lg"))),
    }


def _bounded_cases():
    aggs = _big_data(3000)
    aggs["o"] = np.arange(3000)
    n = 2500
    return {
        "aggs": (aggs, lambda f, df: df.select(
            f.col("g"), f.col("o"), f.col("v"),
            f.sum("v").over(w_go(f).rows_between(-3, 2)).alias("bs"),
            f.count("v").over(w_go(f).rows_between(-3, 2)).alias("bc"),
            f.min("v").over(w_go(f).rows_between(-5, 0)).alias("bmin"),
            f.max("v").over(w_go(f).rows_between(0, 4)).alias("bmax"))),
        "single_group": (_single_group(3000, 5, np.arange),
                         lambda f, df: df.select(
                             f.col("o"),
                             f.sum("v").over(w_go(f).rows_between(-7, 7))
                             .alias("bs"),
                             f.avg("v").over(w_go(f).rows_between(-2, 2))
                             .alias("ba"))),
        "lag_lead": ({"g": (np.arange(n) // 500).astype(np.int64),
                      "o": np.arange(n),
                      "v": np.arange(n, dtype=np.int64) * 3},
                     lambda f, df: df.select(
                         f.col("g"), f.col("o"),
                         f.lag("v", 2).over(w_go(f)).alias("lg"),
                         f.lead("v", 3).over(w_go(f)).alias("ld"))),
        "oom_injection": ({"g": (np.arange(2000) % 5).astype(np.int64),
                           "o": np.arange(2000),
                           "v": np.random.default_rng(11).integers(
                               0, 50, 2000).astype(np.int64)},
                          lambda f, df: df.select(
                              f.col("g"), f.col("o"),
                              f.sum("v").over(w_go(f).rows_between(-4, 1))
                              .alias("bs"))),
    }


RUNNING = _running_cases()
BOUNDED = _bounded_cases()


def _check_window(jax_session, case, parts, conf, counter):
    d, build = case
    ref = build(JF, jax_session.create_dataframe(d, num_partitions=parts)
                ).collect()
    before = getattr(WX, counter)
    got = build(F, TorchSession(conf, device="cpu").create_dataframe(
        d, num_partitions=parts)).collect()
    assert len(got) == len(ref) > 0
    assert rows_equal(ref, got, check_order=False, approx_float=True) \
        is None
    return getattr(WX, counter) - before


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("case", list(RUNNING))
def test_running_windows_match_jax(jax_session, merge_rows_700, case,
                                   parts):
    launches = SX.EXTERNAL_SORT_EVENTS
    ran = _check_window(jax_session, RUNNING[case], parts, RUNNING_CONF,
                        "RUNNING_WINDOW_EVENTS")
    if case == "not_eligible":
        assert ran == 0   # lag is no running shape: the whole partition
    else:
        # a pass a partition that holds rows (one group: one partition)
        assert 1 <= ran <= parts
        assert SX.EXTERNAL_SORT_EVENTS - launches >= ran


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("case", list(BOUNDED))
def test_bounded_windows_match_jax(jax_session, merge_rows_700, case,
                                   parts):
    retries = R.RETRY_COUNT
    if case == "oom_injection":
        R.force_retry_oom(2, framed_only=True)
    ran = _check_window(jax_session, BOUNDED[case], parts, BOUNDED_CONF,
                        "BOUNDED_WINDOW_EVENTS")
    assert 1 <= ran <= parts
    if case == "oom_injection":
        assert R.RETRY_COUNT - retries == 2


# -- the external sort --

def _sort_data(n=3000, seed=4):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=n)
    v = np.where(rng.random(n) < 0.05, np.nan, v)
    v = np.where(rng.random(n) < 0.03, -0.0, v)
    return {
        "s": [None if rng.random() < 0.05 else
              "w" * int(rng.integers(0, 3 if i < n // 2 else 30))
              for i in range(n)],
        "v": [None if rng.random() < 0.08 else float(x) for x in v],
        "k": [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(0, 5, n)],
        "id": np.arange(n, dtype=np.int64),
    }


def test_external_sort_matches_jax(jax_session, merge_rows_700):
    d = _sort_data()

    def q(f, df):
        return df.order_by(f.desc("s", nulls_first=True),
                           f.asc("v", nulls_first=False), f.desc("k"),
                           f.asc("id"))
    ref = q(JF, jax_session.create_dataframe(d)).collect()
    before = SX.EXTERNAL_SORT_EVENTS
    s = TorchSession({"spark.rapids.sql.test.sort.forceOutOfCore": "true",
                      "spark.rapids.tpu.memory.pool.size": "64k"},
                     device="cpu")
    got = q(F, s.create_dataframe(d)).collect()
    assert SX.EXTERNAL_SORT_EVENTS - before == 1
    assert DM.memory_stats()["device_to_host"] > 0
    assert rows_equal(ref, got, check_order=True) is None


# -- the out-of-core FINAL merge --

def _agg_data(n=4000, seed=8):
    rng = np.random.default_rng(seed)
    return {"k": rng.integers(0, 300, n).astype(np.int64),
            "s": [None if rng.random() < 0.1 else f"s{x}"
                  for x in rng.integers(0, 7, n)],
            "v": rng.normal(size=n)}


def _agg(f, df):
    return df.group_by("k", "s").agg(f.sum("v").alias("sv"),
                                     f.count("v").alias("c"),
                                     f.avg("k").alias("ak"))


def test_forced_repartition_matches_jax(jax_session):
    d = _agg_data()
    ref = _agg(JF, jax_session.create_dataframe(d, num_partitions=2)
               ).collect()
    before = A.REPARTITION_EVENTS
    A.FORCE_REPARTITION_BELOW_DEPTH = 2
    try:
        got = _agg(F, TorchSession(device="cpu").create_dataframe(
            d, num_partitions=2)).collect()
    finally:
        A.FORCE_REPARTITION_BELOW_DEPTH = 0
    # two FINAL partitions re-partitioned at depth 0, then each of their
    # buckets at depth 1 (the exchange fixed the hash's lowest bit, so a
    # partition fills 8 of the 16 buckets at depth 0)
    assert A.REPARTITION_EVENTS - before == 2 * (1 + A.MERGE_BUCKETS // 2)
    assert rows_equal(ref, got, check_order=False) is None


def test_split_retry_repartitions_matches_jax(jax_session):
    """A SplitAndRetryOOM in the merge's attempt (merge state cannot
    shrink by running again) re-partitions each FINAL partition."""
    from spark_rapids_tpu_torch.memory.spillable import spillable_pieces
    from spark_rapids_tpu_torch.plan.base import ExecContext
    d = _agg_data()
    ref = _agg(JF, jax_session.create_dataframe(d, num_partitions=2)
               ).collect()
    s = TorchSession(device="cpu")
    plan = _agg(F, s.create_dataframe(d, num_partitions=2)).executed_plan()
    final = plan
    while not (isinstance(final, A.TorchKeyedAggregateExec) and
               final.mode == A.FINAL):
        final = final.children[0]
    ctx = ExecContext(s.device, s.transfers)
    got_batches = []
    before = A.REPARTITION_EVENTS
    for part in final.child.execute(ctx):
        spills = spillable_pieces(part, s.transfers)
        R.force_split_and_retry_oom(1)
        got_batches += list(A.merge_partials_out_of_core(final, spills,
                                                         s.transfers))
    assert A.REPARTITION_EVENTS - before == 2
    got = [r for b in got_batches
           for r in s.transfers.download_batch(b).to_rows()]
    keys = [(r["k"], r["s"]) for r in got]
    assert len(keys) == len(set(keys)), "bucket key sets are disjoint"
    assert rows_equal(ref, got, check_order=False) is None


# -- q51 under a small pool --

NAMES = ("web_sales", "store_sales", "date_dim")


@pytest.fixture(scope="module")
def q51_tables():
    return tpcds.q51_tables(tpcds.generate_tables(1))


@pytest.mark.parametrize("parts", [1, 2])
def test_q51_out_of_core_matches_jax_sql(q51_tables, parts):
    js = TpuSession({"spark.rapids.sql.enabled": "false"})
    register_tables(js, sf=1, num_partitions=parts, tables=set(NAMES))
    ref = js.sql(tpcds.Q51_SQL).collect()
    for r in ref:
        if isinstance(r["d_date"], datetime.datetime):
            r["d_date"] = r["d_date"].date()
    memory = tpcds.q51(*tpcds.partitioned_frames(
        TorchSession(device="cpu"), q51_tables, NAMES, parts))[0].collect()
    DM.shutdown()
    s = TorchSession({"spark.rapids.tpu.memory.pool.size": "128k"},
                     device="cpu")
    ev = (WX.RUNNING_WINDOW_EVENTS, SX.EXTERNAL_SORT_EVENTS,
          A.REPARTITION_EVENTS)
    got = tpcds.q51(*tpcds.partitioned_frames(s, q51_tables, NAMES, parts)
                    )[0].collect()
    ran = (WX.RUNNING_WINDOW_EVENTS - ev[0], SX.EXTERNAL_SORT_EVENTS - ev[1],
           A.REPARTITION_EVENTS - ev[2])
    assert ran[0] >= 3 and ran[1] >= ran[0]
    assert (ran[2] > 0) == (parts > 1)
    assert DM.memory_stats()["device_to_host"] > 0
    assert got == memory and len(got) == 100
    assert rows_equal(ref, got, check_order=True, approx_float=True) is None
