"""UNION ALL, INTERSECT and null-safe joins on the port (TorchSession(
device="cpu"), every kernel's plain version) against the JAX package's
DataFrame calls on its CPU engine (``spark.rapids.sql.enabled`` false),
over the same seeded columns with nulls.

- ``union`` (JAX ``session.py:539``, ``exec/basic.py:614``): the rows of
  both in order, the partitions the sum of the children's; ``intersect``
  (``:495``: distinct, then a null-safe left semi join on every column):
  a null row of both sides is kept once.
- ``join(..., null_safe=True)`` in every K10 mode (inner, left, right,
  full, semi, anti; JAX ``ops/join_ops.py:191-234``) on an int key, a
  string key and both, at 1 and 2 partitions: a null key meets a null
  key.  Rows are compared without order (K10 is a hash join).
- A group-by on a substring key (K13 writes it, K9 groups it) and a join
  on substring keys (K13 writes both sides' keys; at 3 partitions K11h
  hashes them) against the JAX DataFrame."""

import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import functions as JF
from spark_rapids_tpu import types as JT
from spark_rapids_tpu.session import TpuSession
from spark_rapids_tpu.testing.rowcompare import rows_equal
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import functions as F
from spark_rapids_tpu_torch.exec.basic import TorchUnionExec
from spark_rapids_tpu_torch.exec.joins import TorchHashJoinExec


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
    threads in each pytest worker makes them contend for the cores (q5 at
    sf 1 took 5.4 s at 8 threads and 0.46 s at 1 on an 8-core machine
    under load).  This module runs on one thread and restores the count
    after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SCHEMA = JT.StructType([JT.StructField("k", JT.LONG),
                        JT.StructField("s", JT.STRING),
                        JT.StructField("v", JT.INT)])


def side(seed: int, n: int, card: int):
    rng = np.random.default_rng(seed)
    return {"k": [None if rng.random() < 0.15 else int(x)
                  for x in rng.integers(0, card, n)],
            "s": [None if rng.random() < 0.15 else f"z{x:03d}"
                  for x in rng.integers(0, card, n)],
            "v": [int(x) for x in rng.integers(0, 5, n)]}


LEFT, RIGHT = side(1, 120, 12), side(2, 90, 12)


@pytest.fixture(scope="module")
def jax():
    return TpuSession({"spark.rapids.sql.enabled": "false"})


def port_frames(parts=1):
    s = TorchSession(device="cpu")
    return (s.create_dataframe(LEFT, num_partitions=parts),
            s.create_dataframe(RIGHT, num_partitions=parts))


def jax_frames(jax):
    return (jax.create_dataframe(LEFT, SCHEMA),
            jax.create_dataframe(RIGHT, SCHEMA))


def nodes(node):
    yield node
    for c in node.children:
        yield from nodes(c)


@pytest.mark.parametrize("parts", [1, 2])
def test_union_matches_jax(jax, parts):
    a, b = port_frames(parts)
    ja, jb = jax_frames(jax)
    got = a.union(b)
    assert got.executed_plan().num_partitions == 2 * parts
    assert any(isinstance(n, TorchUnionExec)
               for n in nodes(got.executed_plan()))
    ref = ja.union(jb).collect()
    assert rows_equal(ref, got.collect(), check_order=True) is None
    three = a.union(b).union(a)
    assert len(three.collect()) == 2 * 120 + 90
    assert rows_equal(ja.union(jb).group_by("k").agg(
        JF.count("*").alias("n")).collect(),
        a.union(b).group_by("k").agg(F.count().alias("n")).collect()) \
        is None


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("cols", [["k"], ["s"], ["k", "s"]])
def test_intersect_keeps_null_rows_once(jax, parts, cols):
    a, b = port_frames(parts)
    ja, jb = jax_frames(jax)
    got = a.select(*cols).intersect(b.select(*cols)).collect()
    ref = ja.select(*cols).intersect(jb.select(*cols)).collect()
    assert rows_equal(ref, got) is None
    assert any(all(r[c] is None for c in cols) for r in got)


MODES = {"inner": "inner", "left": "left", "right": "right",
         "full": "full", "semi": "left_semi", "anti": "left_anti"}


@pytest.mark.parametrize("parts", [1, 2])
@pytest.mark.parametrize("keys", [["k"], ["s"], ["k", "s"]])
@pytest.mark.parametrize("how", list(MODES))
def test_null_safe_join_matches_jax(jax, how, keys, parts):
    a, b = port_frames(parts)
    ja, jb = jax_frames(jax)
    other = [c for c in ("k", "s") if c not in keys]
    b = b.select(*keys, *[F.col(c).alias(c + "_r") for c in other],
                 F.col("v").alias("w"))
    jb = jb.select(*keys, *[JF.col(c).alias(c + "_r") for c in other],
                   JF.col("v").alias("w"))
    got = a.join(b, on=keys, how=how, null_safe=True)
    joins = [n for n in nodes(got.executed_plan())
             if isinstance(n, TorchHashJoinExec)]
    assert joins and all(joins[0].null_safe)
    ref = ja.join(jb, on=keys, how=MODES[how], null_safe=True).collect()
    rows = got.collect()
    assert rows_equal(ref, rows) is None
    plain = a.join(b, on=keys, how=how).collect()
    if how not in ("anti",):
        # a null key meets a null key only null-safely
        assert any(r[keys[0]] is None for r in rows)
        assert len(rows) != len(plain) or how in ("left", "right", "full")


@pytest.mark.parametrize("parts", [1, 3])
def test_substring_group_key_and_join_keys_match_jax(jax, parts):
    s = TorchSession(device="cpu")
    a = s.create_dataframe(LEFT, num_partitions=parts)
    b = s.create_dataframe(RIGHT, num_partitions=parts)
    ja, jb = jax_frames(jax)
    got = a.group_by(F.substring("s", 1, 3).alias("p")).agg(
        F.sum("v").alias("t"), F.count().alias("n")).collect()
    ref = ja.group_by(JF.substring("s", 1, 3).alias("p")).agg(
        JF.sum("v").alias("t"), JF.count("*").alias("n")).collect()
    assert rows_equal(ref, got) is None and len(got) > 1
    keyed = a.with_column("p", F.substring("s", 2, 2)) \
        .join(b.select(F.substring("s", 2, 2).alias("q"),
                       F.col("v").alias("w")), on=[("p", "q")])
    jref = ja.with_column("p", JF.substring("s", 2, 2)).join(
        jb.select(JF.substring("s", 2, 2).alias("p"),
                  JF.col("v").alias("w")), on="p")
    rows = [{"k": r["k"], "s": r["s"], "v": r["v"], "p": r["p"],
             "w": r["w"]} for r in keyed.collect()]
    ref_rows = [{"k": r["k"], "s": r["s"], "v": r["v"], "p": r["p"],
                 "w": r["w"]} for r in jref.collect()]
    assert rows_equal(ref_rows, rows) is None and rows
