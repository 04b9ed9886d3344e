"""The port's partition ids (spark_rapids_tpu_torch/plan/partitioning.py
over ops/partition_ops.py: K11h's and K11r's plain versions on the CPU)
against the JAX package's HashPartitioning and RangePartitioning
partition_ids_cpu and its murmur3 (Murmur3Hash.eval_cpu, the numpy
murmur3_col), on the same seeded numpy planes:

- murmur3 of int, date, long, double (-0.0, NaN, infinities), float,
  bool and string columns (empty, 1 to 7 bytes, 40 bytes, bytes of 0x80
  and above), with nulls, alone and chained: bit for bit;
- hash ids at n = 1, 2, 3, 7 and 200, and int keys hashed as longs
  against the JAX package's cast: equal;
- range ids against the same bounds batch, ascending and descending,
  nulls first and last, over int, long, double and string keys: equal
  (the JAX host twin, which masks the data under a null as the port
  does)."""

import datetime
import gc

import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import batch_from_pydict as j_batch
from spark_rapids_tpu.exec.sort import SortSpec as JSortSpec
from spark_rapids_tpu.expressions import base as JB
from spark_rapids_tpu.expressions import hashing as JH
from spark_rapids_tpu.expressions.cast import Cast as JCast
from spark_rapids_tpu.plan import partitioning as JP
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.exec.sort import SortSpec
from spark_rapids_tpu_torch.expressions.base import BoundReference
from spark_rapids_tpu_torch.ops import partition_ops as PO
from spark_rapids_tpu_torch.plan import partitioning as PP


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


N = 400
WORDS = ["", "a", "ab", "abc", "abcd", "abcde", "abcdefg", "é", "日本",
         "x" * 40, "ÿ\u0080z", "brand#1"]
#: (name, JAX type, port type)
COLUMNS = [("i", JT.INT, T.INT), ("d", JT.DATE, T.DATE),
           ("l", JT.LONG, T.LONG), ("x", JT.DOUBLE, T.DOUBLE),
           ("b", JT.BOOLEAN, T.BOOLEAN), ("s", JT.STRING, T.STRING)]


def planes(seed: int, n: int = N):
    """One dict of Python values (None is a null) per column."""
    rng = np.random.default_rng(seed)

    def nulls(values):
        return [None if rng.random() < 0.15 else v for v in values]

    ints = rng.integers(-2 ** 31, 2 ** 31, n)
    ints[:4] = [-2 ** 31, 2 ** 31 - 1, 0, -1]
    longs = rng.integers(-2 ** 63, 2 ** 63 - 1, n, endpoint=True)
    longs[:3] = [-2 ** 63, 2 ** 63 - 1, 0]
    doubles = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5,
                                   -2.25, 1e300, 5e-324]), n)
    doubles[::7] = rng.standard_normal(len(doubles[::7]))
    epoch = datetime.date(1970, 1, 1)
    return {
        "i": nulls([int(v) for v in ints]),
        "d": nulls([epoch + datetime.timedelta(days=int(v))
                    for v in rng.integers(-30000, 30000, n)]),
        "l": nulls([int(v) for v in longs]),
        "x": nulls([float(v) for v in doubles]),
        "b": nulls([bool(v) for v in rng.random(n) < 0.5]),
        "s": nulls([str(rng.choice(WORDS)) for _ in range(n)]),
    }


def both(values):
    """The JAX host batch and the port's CPU batch of the same values."""
    jb = j_batch(values, JT.StructType([JT.StructField(n, jt, True)
                                        for n, jt, _pt in COLUMNS]))
    pb = TransferGateway(torch.device("cpu")).upload_batch(batch_from_pydict(
        values, T.StructType([T.StructField(n, pt, True)
                              for n, _jt, pt in COLUMNS])))
    return jb, pb


def jax_hash(jb, ordinals, casts=()):
    from spark_rapids_tpu.expressions.evaluator import (host_batch_tcols,
                                                        tcol_to_host_column)
    refs = [JB.BoundReference(o, COLUMNS[o][1]) for o in ordinals]
    refs = [JCast(r, JT.LONG) if o in casts else r
            for r, o in zip(refs, ordinals)]
    ctx = JB.EvalContext(host_batch_tcols(jb), "cpu", jb.row_count)
    h = JH.Murmur3Hash(*refs).eval_cpu(ctx)
    return np.asarray(tcol_to_host_column(h, jb.row_count).arrow,
                      dtype=np.int32)


KEY_SETS = [(0,), (1,), (2,), (3,), (4,), (5,), (0, 5), (3, 2, 5),
            (5, 4, 1, 0)]


@pytest.mark.parametrize("ordinals", KEY_SETS)
def test_murmur3_of_every_type_is_bit_exact(ordinals):
    jb, pb = both(planes(sum(ordinals) + 1))
    got = PO.murmur3_rows([pb.columns[o] for o in ordinals]).numpy()
    np.testing.assert_array_equal(got, jax_hash(jb, ordinals))


def test_murmur3_of_float_is_bit_exact():
    """Floats have no column type in the port yet: the hash of a float32
    plane (K11h's float kind) against the JAX package's FloatType."""
    rng = np.random.default_rng(5)
    x = rng.choice(np.array([0.0, -0.0, np.nan, np.inf, -np.inf, 1.5,
                             -3.25, 3.4e38], dtype=np.float32), N)
    valid = rng.random(N) > 0.2
    jb = j_batch({"f": [float(v) if ok else None for v, ok in zip(x, valid)]},
                 JT.StructType([JT.StructField("f", JT.FLOAT, True)]))
    ref = jax_hash_float(jb)
    got = PO.murmur3_rows([PO.HashColumn(torch.from_numpy(x),
                                         torch.from_numpy(valid), None)])
    np.testing.assert_array_equal(got.numpy(), ref)


def jax_hash_float(jb):
    from spark_rapids_tpu.expressions.evaluator import (host_batch_tcols,
                                                        tcol_to_host_column)
    ctx = JB.EvalContext(host_batch_tcols(jb), "cpu", jb.row_count)
    h = JH.Murmur3Hash(JB.BoundReference(0, JT.FLOAT)).eval_cpu(ctx)
    return np.asarray(tcol_to_host_column(h, jb.row_count).arrow,
                      dtype=np.int32)


@pytest.mark.parametrize("n", [1, 2, 3, 7, 200])
@pytest.mark.parametrize("ordinals", [(0,), (5,), (3, 2, 5), (1, 4)])
def test_hash_ids_match_jax(n, ordinals):
    jb, pb = both(planes(n * 7 + len(ordinals)))
    ref = JP.HashPartitioning(
        [JB.BoundReference(o, COLUMNS[o][1]) for o in ordinals],
        n).partition_ids_cpu(jb)
    part = PP.HashPartitioning(
        [BoundReference(o, COLUMNS[o][2]) for o in ordinals], n)
    pids, counts = part.partition_ids(pb, [pb.columns[5]])
    np.testing.assert_array_equal(pids.numpy(), ref)
    np.testing.assert_array_equal(counts[:n].numpy(),
                                  np.bincount(ref, minlength=n))
    lens = np.array([0 if v is None else len(v.encode())
                     for v in planes(n * 7 + len(ordinals))["s"]])
    np.testing.assert_array_equal(
        counts[n:].numpy(), np.bincount(ref, weights=lens, minlength=n))


def test_int_keys_hashed_as_longs_match_jax_casts():
    """A join's int key against a long partner hashes as a long, as the
    JAX analyzer casts it."""
    jb, pb = both(planes(11))
    ref = JP.HashPartitioning([JCast(JB.BoundReference(0, JT.INT), JT.LONG),
                               JB.BoundReference(2, JT.LONG)],
                              7).partition_ids_cpu(jb)
    part = PP.HashPartitioning([BoundReference(0, T.INT),
                                BoundReference(2, T.LONG)], 7, [True, True])
    np.testing.assert_array_equal(part.partition_ids(pb)[0].numpy(), ref)


def bounds_of(values, ordinals, specs, count, seed):
    """``count`` rows of the values, sorted by the JAX package's host sort,
    as the JAX and port bound batches of the key columns."""
    rng = np.random.default_rng(seed)
    pick = rng.choice(N, count, replace=False)
    jb, _pb = both({k: [v[i] for i in pick] for k, v in values.items()})
    from spark_rapids_tpu.exec.basic import CpuInMemoryScanExec
    from spark_rapids_tpu.exec.sort import CpuSortExec
    keys = JT.StructType([JT.StructField(f"k{j}", COLUMNS[o][1], True)
                          for j, o in enumerate(ordinals)])
    kb = type(jb)([jb.columns[o] for o in ordinals], jb.row_count,
                  keys.names)
    sspecs = [JSortSpec(JB.BoundReference(j, COLUMNS[o][1]), s.ascending,
                        s.nulls_first) for j, (o, s) in
              enumerate(zip(ordinals, specs))]
    sorted_b = next(iter(CpuSortExec(sspecs, CpuInMemoryScanExec(
        [[kb]], keys)).execute_partition(0)))
    host = sorted_b.to_pydict()
    pvals = {k: host[k] for k in keys.names}
    pcols = TransferGateway(torch.device("cpu")).upload_batch(
        batch_from_pydict(pvals, T.StructType([
            T.StructField(f"k{j}", COLUMNS[o][2], True)
            for j, o in enumerate(ordinals)]))).columns
    return sorted_b, pcols


@pytest.mark.parametrize("ordinals", [(0,), (2,), (3,), (5,), (3, 5),
                                      (5, 0)])
@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False),
                                             (True, False), (False, True)])
@pytest.mark.parametrize("n", [4, 30])
def test_range_ids_match_jax(ordinals, asc, nulls_first, n):
    values = planes(len(ordinals) * 3 + n)
    jb, pb = both(values)
    jspecs = [JSortSpec(JB.BoundReference(o, COLUMNS[o][1]), asc,
                        nulls_first) for o in ordinals]
    jbounds, pbounds = bounds_of(values, ordinals, jspecs, n - 1, n)
    ref = JP.RangePartitioning(jspecs, n, jbounds).partition_ids_cpu(jb)
    specs = [SortSpec(BoundReference(o, COLUMNS[o][2]), asc, nulls_first)
             for o in ordinals]
    part = PP.RangePartitioning(specs, n)
    pids, counts = part.partition_ids(pb, pbounds)
    np.testing.assert_array_equal(pids.numpy(), ref)
    np.testing.assert_array_equal(counts.numpy(),
                                  np.bincount(ref, minlength=n))
