"""The keyed aggregation's modules (ops/agg_ops.py keyed_aggregate, K9, and
exec/aggregate.py TorchKeyedAggregateExec) against the JAX package's
group-by (exec/aggregate.py over ops/agg_ops.py keyed_agg_trace, on
JAX-CPU), on the same seeded inputs.

Keys are int, long and string with nulls (a null key is a group of its
own).  Rows are compared with rowcompare.rows_equal without regard to
order: keys and counts exact, long sums exact, double sums with
approx_float=True (1e-6 relative: the two engines add in other orders).
The port numbers groups in order of first appearance; a forced hash
collision must still give separate groups."""

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
    with pytest.raises(NotImplementedError, match="DoubleType"):
        df.group_by("v").agg(F.count()).collect()
    parts = s.create_dataframe(data(50, seed=1), schema=SCHEMA,
                               num_partitions=2)
    with pytest.raises(NotImplementedError, match="several partitions"):
        parts.group_by("a").agg(F.sum("v")).collect()

