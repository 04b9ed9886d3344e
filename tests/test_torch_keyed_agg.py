"""The keyed aggregation's modules (ops/agg_ops.py keyed_aggregate, K9, and
exec/aggregate.py TorchKeyedAggregateExec) against the JAX package's
group-by (exec/aggregate.py over ops/agg_ops.py keyed_agg_trace, on
JAX-CPU), on the same seeded inputs.

Keys are int, long, string and double with nulls (a null key is a group
of its own; -0.0 groups with 0.0 and every NaN with every NaN).  Rows are compared with rowcompare.rows_equal without regard to
order: keys and counts exact, long sums exact, double sums with
approx_float=True (1e-6 relative: the two engines add in other orders).
The port numbers groups in order of first appearance; a forced hash
collision must still give separate groups."""

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


SCHEMA = T.StructType([T.StructField("a", T.INT), T.StructField("b", T.LONG),
                       T.StructField("s", T.STRING),
                       T.StructField("v", T.DOUBLE),
                       T.StructField("w", T.LONG)])


@pytest.fixture(scope="module")
def jax_session():
    return TpuSession({"spark.rapids.sql.enabled": "true"})


def data(n, seed, card=4):
    rng = np.random.default_rng(seed)
    words = ["", "x", "xy", "brand1", "brand10", "日本", "é"]
    return {
        "a": [None if rng.random() < 0.1 else int(x)
              for x in rng.integers(0, card, n)],
        "b": rng.integers(0, card, n).astype(np.int64) * 1_000_003,
        "s": [None if rng.random() < 0.1 else str(rng.choice(words[:card]))
              for _ in range(n)],
        "v": [None if rng.random() < 0.1 else float(x)
              for x in (rng.standard_normal(n) * 100).round(2)],
        "w": rng.integers(-(1 << 62), 1 << 62, n).astype(np.int64),
    }


def aggs(f):
    return [f.sum("v").alias("sv"), f.sum("w").alias("sw"),
            f.count("v").alias("cv"), f.count().alias("c"),
            f.count("s").alias("cs")]


def run_both(jax_session, d, keys):
    ref = jax_session.create_dataframe(d).group_by(*keys).agg(
        *aggs(JF)).collect()
    got = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .group_by(*keys).agg(*aggs(F)).collect()
    return ref, got


@pytest.mark.parametrize("n", [1, 9, 300])
@pytest.mark.parametrize("keys", [["a"], ["s"], ["a", "b", "s"],
                                  ["s", "b"]])
def test_group_by_matches_jax(jax_session, n, keys):
    d = data(n, seed=n + len(keys))
    ref, got = run_both(jax_session, d, keys)
    assert rows_equal(ref, got, check_order=False, approx_float=True) \
        is None, (ref, got)


def test_groups_come_in_order_of_first_appearance():
    d = {"s": ["b", None, "a", "b", None, "c", "a"],
         "v": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0, 7.0]}
    got = TorchSession(device="cpu").create_dataframe(d).group_by("s") \
        .agg(F.sum("v").alias("sv")).collect()
    assert got == [{"s": "b", "sv": 5.0}, {"s": None, "sv": 7.0},
                   {"s": "a", "sv": 10.0}, {"s": "c", "sv": 6.0}]


def test_forced_hash_collisions_keep_groups_apart(jax_session,
                                                  monkeypatch):
    """Every row hashes alike, so every key probes the same chain: strings
    and ints with equal hashes must still be compared byte by byte."""
    d = data(200, seed=21, card=7)
    ref, _ = run_both(jax_session, d, ["s", "a"])
    seen = []

    def colliding(keys):
        seen.append(len(keys))
        return torch.zeros(keys[0].row_count, dtype=torch.int64)
    monkeypatch.setattr(G, "key_hash_plain", colliding)
    got = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .group_by("s", "a").agg(*aggs(F)).collect()
    assert seen == [2]
    assert len(got) > 20
    assert rows_equal(ref, got, check_order=False, approx_float=True) \
        is None


def test_plain_hash_matches_the_kernels_definition():
    """key_hash_plain is fmix64 chained over the columns, a string folded
    by FNV-1a first (csrc/keyed_agg.cu row_hash), here written out in
    Python integers for one row."""
    s = TorchSession(device="cpu")
    dev = s.transfers.upload_batch(s.create_dataframe(
        {"a": [7], "s": ["hé"]}, schema=T.StructType(
            [T.StructField("a", T.INT),
             T.StructField("s", T.STRING)]))._plan.partitions[0][0])
    m64 = (1 << 64) - 1

    def fmix(h):
        h ^= h >> 33
        h = h * 0xff51afd7ed558ccd & m64
        h ^= h >> 33
        h = h * 0xc4ceb9fe1a85ec53 & m64
        return h ^ (h >> 33)
    f = 0xcbf29ce484222325
    for byte in "hé".encode():
        f = (f ^ byte) * 0x100000001b3 & m64
    want = fmix(fmix(0x9e3779b97f4a7c15 ^ 7) ^ f)
    got = int(G.key_hash_plain(dev.columns)[0]) & m64
    assert got == want


def test_one_sync_per_group_by_and_keys_refused_by_name():
    s = TorchSession(device="cpu")
    df = s.create_dataframe(data(50, seed=1), schema=SCHEMA)
    before = s.transfers.stats()["syncs"]
    df.group_by("a", "s").agg(F.sum("v")).collect()
    # the group count, then the download
    assert s.transfers.stats()["syncs"] - before == 2
    flags = s.create_dataframe({"f": np.array([True, False, True])})
    with pytest.raises(NotImplementedError, match="BooleanType"):
        flags.group_by("f").agg(F.count()).collect()
    # over several partitions: PARTIAL, a hash exchange, FINAL
    parts = s.create_dataframe(data(50, seed=1), schema=SCHEMA,
                               num_partitions=2)
    one = df.group_by("a").agg(F.sum("v").alias("sv")).collect()
    got = parts.group_by("a").agg(F.sum("v").alias("sv")).collect()
    key = (lambda r: (r["a"] is None, r["a"] or 0))
    assert len(got) == len(one)
    for g, o in zip(sorted(got, key=key), sorted(one, key=key)):
        assert g["a"] == o["a"] and (g["sv"] == o["sv"] or abs(
            g["sv"] - o["sv"]) <= 1e-12 * abs(o["sv"]))



def avg_aggs(f):
    return [f.avg("v").alias("av"), f.avg("a").alias("aa"),
            f.avg("w").alias("aw"), f.sum("v").alias("sv")]


@pytest.mark.parametrize("n", [1, 9, 300])
@pytest.mark.parametrize("keys", [["s"], ["b", "s"]])
def test_avg_over_int_and_double_matches_jax(jax_session, n, keys):
    """avg of a double, of a nullable int and of a long: K9 folds a double
    sum (an int converted row by row) and a count, and K6 divides."""
    d = data(n, seed=100 + n + len(keys))
    ref = jax_session.create_dataframe(d).group_by(*keys).agg(
        *avg_aggs(JF)).collect()
    df = TorchSession(device="cpu").create_dataframe(d, schema=SCHEMA) \
        .group_by(*keys).agg(*avg_aggs(F))
    assert "TorchKeyedAggregate" in df.explain()
    assert rows_equal(ref, df.collect(), check_order=False,
                      approx_float=True) is None


def test_avg_of_a_group_whose_values_are_all_null_is_null(jax_session):
    d = {"s": ["x", "y", "x", "z", "y"],
         "v": [None, 1.5, None, None, 2.5],
         "a": [None, 3, None, 4, 6]}
    schema = T.StructType([T.StructField("s", T.STRING),
                           T.StructField("v", T.DOUBLE),
                           T.StructField("a", T.INT)])
    got = TorchSession(device="cpu").create_dataframe(d, schema=schema) \
        .group_by("s").agg(F.avg("v").alias("av"),
                           F.avg("a").alias("aa")).collect()
    assert got == [{"s": "x", "av": None, "aa": None},
                   {"s": "y", "av": 2.0, "aa": 4.5},
                   {"s": "z", "av": None, "aa": 4.0}]
    ref = jax_session.create_dataframe(d).group_by("s").agg(
        JF.avg("v").alias("av"), JF.avg("a").alias("aa")).collect()
    assert rows_equal(ref, got, check_order=False) is None


def test_double_sum_of_an_int_input_converts_each_row():
    """K9's double sum takes an int or long input (an average's sum)."""
    s = TorchSession(device="cpu")
    cols = s.transfers.upload_batch(s.create_dataframe(
        {"k": [1, 1, 2], "a": [2 ** 31 - 1, 1, None]}, schema=T.StructType(
            [T.StructField("k", T.LONG),
             T.StructField("a", T.INT)]))._plan.partitions[0][0]).columns
    rep, [(sums, valid), (cnt, _)] = G.keyed_aggregate(
        [cols[0]], [cols[1], cols[1]], [G.KEYED_SUM_F64, G.KEYED_COUNT],
        s.transfers)
    assert sums.dtype == torch.float64
    assert sums.tolist()[0] == 2.0 ** 31 and valid.tolist() == [True, False]
    assert cnt.tolist() == [2, 0]


def double_key_data(n, seed):
    """A double key with -0.0 and 0.0, NaNs of several payloads and nulls,
    and q12's five keys: four strings and a double."""
    rng = np.random.default_rng(seed)
    nan2 = np.frombuffer(np.array([0x7ff8000000000001], np.int64)
                         .tobytes(), np.float64)[0]
    nan3 = np.frombuffer(np.array([-0x0008000000000000], np.int64)
                         .tobytes(), np.float64)[0]
    pool = [0.0, -0.0, np.nan, nan2, nan3, 1.5, -2.25, np.inf]
    vals = [None if rng.random() < 0.1 else pool[int(x)]
            for x in rng.integers(0, len(pool), n)]
    words = ["", "x", "xy", "class1", "Books"]
    return {
        "p": vals,
        "s": [None if rng.random() < 0.1 else str(rng.choice(words))
              for _ in range(n)],
        "t": [str(rng.choice(words[:3])) for _ in range(n)],
        "u": [str(rng.choice(words[3:])) for _ in range(n)],
        "x": [str(rng.choice(words[1:3])) for _ in range(n)],
        "v": (rng.standard_normal(n) * 100).round(2),
    }


DOUBLE_SCHEMA = T.StructType([
    T.StructField("p", T.DOUBLE), T.StructField("s", T.STRING),
    T.StructField("t", T.STRING), T.StructField("u", T.STRING),
    T.StructField("x", T.STRING), T.StructField("v", T.DOUBLE)])


@pytest.mark.parametrize("n", [1, 40, 300])
@pytest.mark.parametrize("keys", [["p"], ["s", "t", "u", "x", "p"]])
def test_double_and_five_keys_match_jax(jax_session, n, keys):
    """-0.0 and 0.0 are one group, every NaN (whatever its payload) one
    more, a null one more; the group's key is its first row's value."""
    d = double_key_data(n, seed=n + len(keys))
    ref = jax_session.create_dataframe(d).group_by(*keys).agg(
        JF.sum("v").alias("sv"), JF.count().alias("c")).collect()
    got = TorchSession(device="cpu").create_dataframe(
        d, schema=DOUBLE_SCHEMA).group_by(*keys).agg(
        F.sum("v").alias("sv"), F.count().alias("c")).collect()
    assert rows_equal(ref, got, check_order=False, approx_float=True) \
        is None, (ref, got)
    if keys == ["p"] and n == 300:
        # 0.0 and -0.0, NaN, null, 1.5, -2.25, inf
        assert len(got) == 6


def test_double_key_hash_normalises_zero_and_nan():
    s = TorchSession(device="cpu")
    nan2 = np.frombuffer(np.array([0x7ff0000000000001], np.int64)
                         .tobytes(), np.float64)[0]
    col = s.transfers.upload_batch(s.create_dataframe(
        {"p": np.array([0.0, -0.0, np.nan, nan2])})._plan.partitions[0][0]
    ).columns[0]
    h = G.key_hash_plain([col]).tolist()
    assert h[0] == h[1] and h[2] == h[3] and h[0] != h[2]
