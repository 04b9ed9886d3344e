"""The port's shuffle exchange (spark_rapids_tpu_torch/exec/exchange.py
over K7s's plain version, ops/partition_ops.py split_columns) against the
JAX package, on the same seeded numpy planes:

- the split of a mixed batch (int, long, double, string, with nulls) by
  the JAX package's hash ids equals, partition by partition and row by
  row, JAX ``compact_batch(b, pids == p)`` run on JAX-CPU, the map side
  of its exchange (exec/exchange.py:623-627);
- an exchange of several map partitions hands reduce partition p its rows
  in map order, equal to the JAX CpuShuffleExchangeExec's partition p,
  for hash and range partitionings, with one counted sync for the
  histogram (and one for the range sample);
- the range bounds are the JAX package's ``_sample_bounds`` over the same
  sample."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from spark_rapids_tpu import types as JT
from spark_rapids_tpu.columnar.batch import batch_from_pydict as j_batch
from spark_rapids_tpu.exec.basic import CpuInMemoryScanExec
from spark_rapids_tpu.exec.exchange import CpuShuffleExchangeExec
from spark_rapids_tpu.exec.sort import SortSpec as JSortSpec
from spark_rapids_tpu.expressions import base as JB
from spark_rapids_tpu.ops.batch_ops import compact_batch
from spark_rapids_tpu.plan import partitioning as JP
from spark_rapids_tpu_torch import TorchSession
from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import batch_from_pydict
from spark_rapids_tpu_torch.exec import exchange as X
from spark_rapids_tpu_torch.exec.sort import SortSpec
from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
from spark_rapids_tpu_torch.expressions.base import BoundReference
from spark_rapids_tpu_torch.ops import partition_ops as PO
from spark_rapids_tpu_torch.plan import partitioning as PP
from spark_rapids_tpu_torch.plan.base import ExecContext


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


COLUMNS = [("k", JT.INT, T.INT), ("l", JT.LONG, T.LONG),
           ("x", JT.DOUBLE, T.DOUBLE), ("s", JT.STRING, T.STRING)]
WORDS = ["", "a", "abcd", "é日本", "x" * 40, "brand#3"]


def values(seed: int, n: int):
    rng = np.random.default_rng(seed)

    def nulls(vs):
        return [None if rng.random() < 0.1 else v for v in vs]

    return {"k": nulls([int(v) for v in rng.integers(0, 50, n)]),
            "l": [int(v) for v in rng.integers(-10 ** 12, 10 ** 12, n)],
            "x": nulls([float(v) for v in rng.standard_normal(n)]),
            "s": nulls([str(rng.choice(WORDS)) for _ in range(n)])}


def jax_schema():
    return JT.StructType([JT.StructField(n, jt, True)
                          for n, jt, _pt in COLUMNS])


def port_schema():
    return T.StructType([T.StructField(n, pt, True)
                         for n, _jt, pt in COLUMNS])


def rows_of(host):
    d = host.to_pydict()
    return list(zip(*[d[n] for n, _jt, _pt in COLUMNS]))


def same_rows(a, b):
    assert len(a) == len(b)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert (x == y) or (x != x and y != y), (ra, rb)


@pytest.mark.parametrize("n", [1, 4, 7])
def test_split_equals_jax_compaction_per_partition(n):
    vals = values(n, 300)
    jb = j_batch(vals, jax_schema())
    pids = JP.HashPartitioning([JB.BoundReference(3, JT.STRING),
                                JB.BoundReference(0, JT.INT)],
                               n).partition_ids_cpu(jb)
    s = TorchSession(device="cpu")
    pb = s.transfers.upload_batch(batch_from_pydict(vals, port_schema()))
    pt = torch.from_numpy(pids.astype(np.int32))
    counts = PO.histogram_plain(pt, n, [pb.columns[3]]).tolist()
    parts = PO.split_columns(pb.columns, pt, counts[:n], [counts[n:]],
                             s.transfers)
    db = jb.to_device()
    for p in range(n):
        keep = np.zeros(db.bucket, dtype=bool)
        keep[:jb.row_count] = pids == p
        ref = rows_of(compact_batch(db, jnp.asarray(keep)).to_host())
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        got = rows_of(s.transfers.download_batch(ColumnarBatch(
            parts[p], counts[p], pb.names)))
        same_rows(got, ref)
        for c in parts[p]:
            if c.is_string:
                assert int(c.offsets[0]) == 0


def exchange_both(partitioning_pair, n_maps: int, seed: int):
    """The same rows in ``n_maps`` map partitions through the JAX CPU
    exchange and the port's: (JAX rows per partition, port rows per
    partition, port syncs)."""
    vals = values(seed, 500)
    per = -(-500 // n_maps)
    jparts, pparts = [], []
    for m in range(n_maps):
        cut = {k: v[m * per:(m + 1) * per] for k, v in vals.items()}
        jparts.append([j_batch(cut, jax_schema())])
        pparts.append([batch_from_pydict(cut, port_schema())])
    jpart, ppart = partitioning_pair
    jx = CpuShuffleExchangeExec(jpart, CpuInMemoryScanExec(jparts,
                                                           jax_schema()))
    jrows = []
    for p in range(jpart.num_partitions):
        got = []
        for b in jx.execute_partition(p):
            got += rows_of(b)
        jrows.append(got)
    s = TorchSession(device="cpu")
    from spark_rapids_tpu_torch.exec.basic import TorchInMemoryScanExec
    from spark_rapids_tpu_torch.plan import base as L
    scan = TorchInMemoryScanExec(L.Scan(pparts, port_schema()))
    ctx = ExecContext(s.device, s.transfers)
    scan.execute(ctx)      # the upload, outside the counted syncs
    before = s.transfers.stats()["syncs"]
    ex = X.TorchShuffleExchangeExec(ppart, scan)
    out = ex.execute(ctx)
    syncs = s.transfers.stats()["syncs"] - before
    prows = [rows_of(s.transfers.download_batch(part[0])) for part in out]
    assert all(len(part) == 1 for part in out)
    return jrows, prows, syncs, ex


@pytest.mark.parametrize("n", [2, 3, 5])
def test_hash_exchange_matches_jax_in_map_order(n):
    pair = (JP.HashPartitioning([JB.BoundReference(0, JT.INT)], n),
            PP.HashPartitioning([BoundReference(0, T.INT)], n))
    jrows, prows, syncs, _ex = exchange_both(pair, 3, n)
    assert syncs == 1
    for j, p in zip(jrows, prows):
        same_rows(p, j)


@pytest.mark.parametrize("asc,nulls_first", [(True, True), (False, False)])
def test_range_exchange_matches_jax(asc, nulls_first):
    n = 4
    pair = (JP.RangePartitioning([JSortSpec(JB.BoundReference(3, JT.STRING),
                                            asc, nulls_first),
                                  JSortSpec(JB.BoundReference(2, JT.DOUBLE),
                                            asc, nulls_first)], n),
            PP.RangePartitioning([SortSpec(BoundReference(3, T.STRING), asc,
                                           nulls_first),
                                  SortSpec(BoundReference(2, T.DOUBLE), asc,
                                           nulls_first)], n))
    jrows, prows, syncs, ex = exchange_both(pair, 3, 17)
    # the sample's download, then the histogram
    assert syncs == 2
    for j, p in zip(jrows, prows):
        same_rows(p, j)
    # the bounds the exchange picks: n - 1 rows that cut the rows as the
    # exchange did
    s = TorchSession(device="cpu")
    ctx = ExecContext(s.device, s.transfers)
    batches = [b for part in ex.child.execute(ctx) for b in part]
    whole = concat_batches(batches)
    keys = pair[1].key_columns(whole)
    bounds = X.compute_bounds(pair[1], keys,
                              [b.row_count for b in batches], s.transfers)
    assert bounds[0].row_count == n - 1
    pids, counts = pair[1].partition_ids(whole, bounds, (), keys)
    assert counts.tolist() == [len(p) for p in prows]


def test_empty_exchange_launches_nothing():
    """An exchange of no rows hands every reduce partition an empty batch
    and counts no launch of K11h, K11r or K7s."""
    s = TorchSession(device="cpu")
    from spark_rapids_tpu_torch.exec.basic import TorchInMemoryScanExec
    from spark_rapids_tpu_torch.plan import base as L
    empty = {k: [] for k, _jt, _pt in COLUMNS}
    ctx = ExecContext(s.device, s.transfers)
    PO.HASH_LAUNCHES = PO.RANGE_LAUNCHES = PO.SPLIT_LAUNCHES = 0
    for part in (PP.HashPartitioning([BoundReference(3, T.STRING)], 4),
                 PP.RangePartitioning([SortSpec(BoundReference(0, T.INT),
                                                True, True)], 4)):
        scan = TorchInMemoryScanExec(L.Scan(
            [[batch_from_pydict(empty, port_schema())]], port_schema()))
        out = X.TorchShuffleExchangeExec(part, scan).execute(ctx)
        assert [[b.row_count for b in p] for p in out] == [[0]] * 4
        assert all(len(c.offsets) == 1 for p in out for c in p[0].columns
                   if c.is_string)
    assert (PO.HASH_LAUNCHES, PO.RANGE_LAUNCHES, PO.SPLIT_LAUNCHES) == \
        (0, 0, 0)


def test_sample_positions_and_bound_rows():
    """``_compute_bounds_tpu``'s evenly spaced live rows and
    ``_sample_bounds``' picks."""
    pos = X.sample_positions([3, 2048, 0, 1024], k=1024)
    assert pos[:3].tolist() == [0, 1, 2]
    assert pos[3:6].tolist() == [3, 5, 7]
    assert len(pos) == 3 + 1024 + 1024
    assert pos[-1] == 3 + 2048 + 1023
    assert X.bound_rows(10, 4) == [2, 5, 7]
    assert X.bound_rows(0, 4) == []
    assert X.bound_rows(2, 4) == [0, 1, 1]
