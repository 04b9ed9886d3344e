"""Shuffle exchange in one process (the analog of ``spark_rapids_tpu/exec/
exchange.py``: ``TpuShuffleExchangeExec._materialize``'s DEFAULT path
``:512-633``, its range bounds ``_compute_bounds_tpu`` ``:708-760`` and
``_sample_bounds`` ``:30-57``).

Every reduce partition gets one batch, all on the device:

- ``SinglePartitioning``: the child's batches in order, joined by K7c
  (``ops/batch_ops.py concat_batches``), as ``store[0]`` holds them.
- hash or range: K7c joins every map batch, in map-partition order, into
  one; K11h or K11r (``plan/partitioning.py``) gives each row its pid and
  the histogram (rows, and chars of each string column, per partition);
  one ``TransferGateway.read_counts`` brings the histogram to the host (the
  exchange's one counted sync); K7s (``ops/partition_ops.py
  split_columns``) scatters every column stably into one segment per
  partition, and reduce partition p is segment p, as views.  Rows of p
  come in map order, as the JAX map side's ``compact_batch(b, pids ==
  p)`` per partition lines them up in ``store[p]``; the split copies the
  input once where the JAX store holds about n copies of it (``:564-568``).

Range bounds, before the ids: the sort keys (K6 where they compute) of
``RANGE_BOUNDS_SAMPLE_ROWS`` evenly spaced rows of each map batch (all of
a smaller one, ``:727-736``) are gathered with K7 and downloaded once
(one more sync); the host sorts them with the port's CPU sort (K8's plain
version) and picks n - 1 of them as ``_sample_bounds`` does
(``(j + 1) * rows // n``), which go back up as the bound columns.

The JAX package's host-staged modes (MULTITHREADED, CACHED), its
collective path and its HBM-budget fallback to the host are not in the
port yet."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.plan.base import ExecContext, Partitions, \
    UnaryExec
from spark_rapids_tpu_torch.plan.partitioning import (Partitioning,
                                                      RangePartitioning,
                                                      SinglePartitioning)

#: sample rows taken from each map batch for the range bounds (``:61``)
RANGE_BOUNDS_SAMPLE_ROWS = 1024


def sample_positions(row_counts: List[int],
                     k: int = RANGE_BOUNDS_SAMPLE_ROWS) -> np.ndarray:
    """Rows of the joined map batches that the bounds sample takes:
    ``(j * rows) // k`` for j < k of each batch of more than ``k`` rows,
    every row of a smaller one (``_compute_bounds_tpu``)."""
    out, start = [], 0
    for rc in row_counts:
        if rc <= k:
            out.append(np.arange(rc, dtype=np.int64) + start)
        else:
            out.append((np.arange(k, dtype=np.int64) * rc) // k + start)
        start += rc
    return np.concatenate(out) if out else np.zeros(0, dtype=np.int64)


def bound_rows(sample_rows: int, n: int) -> List[int]:
    """The sorted sample rows picked as the n - 1 bounds
    (``_sample_bounds`` ``:54-55``); none from an empty sample."""
    if not sample_rows:
        return []
    return [min(sample_rows - 1, (j + 1) * sample_rows // n)
            for j in range(n - 1)]


def compute_bounds(part: RangePartitioning, keys: List[DeviceColumn],
                   row_counts: List[int], transfers) -> List[DeviceColumn]:
    """The bound columns of ``part`` on the keys' device: the sample
    gathered (K7), downloaded once, sorted on the host, picked and
    uploaded."""
    from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
    from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
    from spark_rapids_tpu_torch.ops.sort_ops import (SortOrder,
                                                     sort_permutation)
    device = keys[0].device
    pos = sample_positions(row_counts)
    idx = transfers.to_device(pos)
    names = [f"_k{j}" for j in range(len(keys))]
    sample = ColumnarBatch(gather_columns(keys, idx, transfers, unique=True),
                           len(pos), names)
    host = transfers.download_batch(sample)
    cpu = TransferGateway(torch.device("cpu"))
    local = cpu.upload_batch(host)
    orders = [SortOrder(j, a, nf) for j, (a, nf) in enumerate(part.orders)]
    picked = torch.tensor(bound_rows(local.row_count, part.num_partitions),
                          dtype=torch.int64)
    if local.row_count:
        perm = sort_permutation(local.columns, orders, cpu)
        picked = perm[picked]
    cols = gather_columns(local.columns, picked, cpu, unique=True)
    if device.type == "cpu":
        return [DeviceColumn(c.data, c.validity, c.data_type, False,
                             c.offsets) for c in cols]
    return transfers.upload_batch(cpu.download_batch(
        ColumnarBatch(cols, picked.shape[0], names))).columns


class TorchShuffleExchangeExec(UnaryExec):
    def __init__(self, partitioning: Partitioning, child):
        super().__init__(child)
        self.partitioning = partitioning

    @property
    def num_partitions(self):
        return self.partitioning.num_partitions

    def node_string(self):
        return f"TorchExchange[{self.partitioning.desc()}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.ops.batch_ops import (concat_batches,
                                                          empty_batch)
        from spark_rapids_tpu_torch.ops.partition_ops import split_columns
        batches = [b for part in self.child.execute(ctx) for b in part]
        if not batches:
            batches = [empty_batch(self.child.schema, ctx.device)]
        whole = concat_batches(batches)
        part = self.partitioning
        n = part.num_partitions
        if isinstance(part, SinglePartitioning) or n == 1:
            return [[whole]]
        strings = [c for c in whole.columns if c.is_string]
        if isinstance(part, RangePartitioning):
            keys = part.key_columns(whole, ctx.transfers)
            bounds = compute_bounds(part, keys,
                                    [b.row_count for b in batches],
                                    ctx.transfers)
            pids, counts = part.partition_ids(whole, bounds, strings, keys)
        else:
            pids, counts = part.partition_ids(whole, strings,
                                              ctx.transfers)
        host = ctx.transfers.read_counts(counts)
        rows = host[:n]
        chars = [host[(1 + s) * n:(2 + s) * n] for s in range(len(strings))]
        segments = split_columns(whole.columns, pids, rows, chars,
                                 ctx.transfers)
        return [[ColumnarBatch(cols, r, whole.names)]
                for cols, r in zip(segments, rows)]
