"""Output partitionings of a shuffle exchange (the analog of
``spark_rapids_tpu/plan/partitioning.py``): each gives a batch's rows their
partition ids and the histogram of them, on the device.

- ``SinglePartitioning`` (``:45``): every row to partition 0 (no kernel).
- ``HashPartitioning`` (``:61``): pid = pmod(murmur3(keys, 42), n), Spark's
  placement bit for bit (K11h, ``ops/partition_ops.py hash_partition``).
  ``as_long`` marks keys hashed as longs: a join hashes an int key
  against a long partner as a long, as the JAX analyzer casts both sides
  of a join to the wider type before it plans the exchange
  (``sql/analyzer.py:388-401``), so equal keys meet in one partition.
- ``RangePartitioning`` (``:124``): a row's pid is the number of the n - 1
  sorted bound rows it is strictly above, in the sort order of ``specs``
  (K11r, ``range_partition``); the exchange picks the bounds from a
  sample (``exec/exchange.py compute_bounds``) and passes them in.

Keys that are expressions are computed by K6 (``exec/fused.py
project_batch``) before the ids; column keys are the batch's columns.
``RoundRobinPartitioning`` is not on the port's path yet."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn
from spark_rapids_tpu_torch.expressions.base import Expression


class Partitioning:
    num_partitions: int = 1

    def desc(self) -> str:
        return type(self).__name__


class SinglePartitioning(Partitioning):
    num_partitions = 1

    def desc(self):
        return "SinglePartition"


class _KeyedPartitioning(Partitioning):
    """A partitioning over key expressions bound to the child's schema."""

    def __init__(self, key_exprs: Sequence[Expression], n: int):
        if n < 1:
            raise ValueError("a partitioning needs at least one partition")
        self.key_exprs = list(key_exprs)
        self.num_partitions = n
        self._program = None

    def key_columns(self, batch: ColumnarBatch,
                    transfers=None) -> List[DeviceColumn]:
        """The key columns of ``batch``: K6 computes those that are not
        columns (K13 a string one, which needs ``transfers``)."""
        from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                       StageProgram,
                                                       project_batch)
        if self._program is None:
            self._program = StageProgram([("project", self.key_exprs)],
                                         batch.schema, 0)
        names = [f"_k{j}" for j in range(len(self.key_exprs))]
        return project_batch(self._program, batch, LiteralArgs([]),
                             names, transfers).columns


class HashPartitioning(_KeyedPartitioning):
    def __init__(self, key_exprs: Sequence[Expression], n: int,
                 as_long: Optional[Sequence[bool]] = None):
        super().__init__(key_exprs, n)
        self.as_long = list(as_long) if as_long is not None \
            else [False] * len(self.key_exprs)

    def partition_ids(self, batch: ColumnarBatch,
                      strings: Sequence[DeviceColumn] = (), transfers=None
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
        """K11h: ``(pids, counts)`` (``ops/partition_ops.py``)."""
        from spark_rapids_tpu_torch.ops.partition_ops import hash_partition
        return hash_partition(self.key_columns(batch, transfers),
                              self.num_partitions, strings, self.as_long)

    def desc(self):
        ks = ", ".join(e.sql() + (" AS BIGINT" if wide else "")
                       for e, wide in zip(self.key_exprs, self.as_long))
        return f"HashPartitioning({ks}, {self.num_partitions})"


class RangePartitioning(_KeyedPartitioning):
    """``specs``: ``exec/sort.py SortSpec`` keys."""

    def __init__(self, specs, n: int):
        super().__init__([s.expr for s in specs], n)
        self.specs = list(specs)

    @property
    def orders(self) -> List[Tuple[bool, bool]]:
        return [(s.ascending, s.effective_nulls_first) for s in self.specs]

    def partition_ids(self, batch: ColumnarBatch,
                      bounds: Sequence[DeviceColumn],
                      strings: Sequence[DeviceColumn] = (),
                      keys: Optional[Sequence[DeviceColumn]] = None,
                      transfers=None) -> Tuple[torch.Tensor, torch.Tensor]:
        """K11r: ``(pids, counts)`` against ``bounds``, the sorted bound
        rows' key columns on the device (``keys``: the key columns, when
        the caller has computed them)."""
        from spark_rapids_tpu_torch.ops.partition_ops import range_partition
        if keys is None:
            keys = self.key_columns(batch, transfers)
        return range_partition(keys, bounds, self.orders,
                               self.num_partitions, strings)

    def desc(self):
        ks = ", ".join(s.sql() for s in self.specs)
        return f"RangePartitioning({ks}, {self.num_partitions})"
