"""Scan, filter, project, column selection and limit execs (the analog of
``spark_rapids_tpu/exec/basic.py``).

``TorchInMemoryScanExec`` uploads the table at the first action and keeps
the device copy (``TpuInMemoryScanExec``, ``:120``), so later actions read
it from device memory.  ``TorchFilterExec`` and ``TorchProjectExec`` are
plan nodes for stage fusion: the planner folds each chain of them into a
fused aggregate (K1), a compacting stage (K5, exec/fused.py), or, for bare
column references, a ``TorchSelectExec``, which picks and renames columns
with no launch.  ``TorchLimitExec`` (``TpuLocalLimitExec``, ``:434``)
keeps the first rows of its one partition as views."""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Expression, output_name
from spark_rapids_tpu_torch.ops.batch_ops import take_front
from spark_rapids_tpu_torch.plan.base import (ExecContext, LeafExec,
                                              Partitions, Scan, UnaryExec)


class TorchInMemoryScanExec(LeafExec):
    def __init__(self, source: Scan):
        super().__init__()
        self.source = source

    @property
    def schema(self):
        return self.source.schema

    @property
    def num_partitions(self):
        return self.source.num_partitions

    def node_string(self):
        return f"TorchInMemoryScan[{self.num_partitions}p]"

    def execute(self, ctx: ExecContext) -> Partitions:
        key = str(ctx.device)
        cached = self.source.device_cache.get(key)
        if cached is None:
            cached = [[ctx.transfers.upload_batch(b) for b in part]
                      for part in self.source.partitions]
            self.source.device_cache[key] = cached
        return cached


class _FusedOnly:
    def execute(self, ctx):
        raise NotImplementedError(
            f"{type(self).__name__} runs only inside a fused aggregate or "
            "a fused stage")


class TorchFilterExec(_FusedOnly, UnaryExec):
    def __init__(self, condition: Expression, child):
        super().__init__(child)
        self.condition = condition

    def node_string(self):
        return f"TorchFilter[{self.condition.sql()}]"


class TorchProjectExec(_FusedOnly, UnaryExec):
    def __init__(self, exprs: Sequence[Expression], child):
        super().__init__(child)
        self.exprs = list(exprs)

    @property
    def schema(self):
        return T.StructType([T.StructField(output_name(e), e.data_type,
                                           e.nullable) for e in self.exprs])

    def node_string(self):
        return f"TorchProject[{', '.join(e.sql() for e in self.exprs)}]"


class TorchSelectExec(UnaryExec):
    """Columns of the child picked by ordinal and renamed: no launch."""

    def __init__(self, ordinals: Sequence[int], schema: T.StructType, child):
        super().__init__(child)
        self.ordinals = list(ordinals)
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    def node_string(self):
        return f"TorchSelect[{', '.join(self._schema.names)}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        names = self._schema.names
        return [[b.select(self.ordinals, names) for b in part]
                for part in self.child.execute(ctx)]


class TorchLimitExec(UnaryExec):
    """LIMIT over one partition of one batch: its first rows (views)."""

    def __init__(self, n: int, child):
        super().__init__(child)
        if child.num_partitions != 1:
            raise NotImplementedError(
                "a limit over several partitions is not in the port yet")
        self.n = n

    def node_string(self):
        return f"TorchLimit[{self.n}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        out = []
        for part in self.child.execute(ctx):
            if len(part) > 1:
                raise NotImplementedError(
                    "a limit over several batches is not in the port yet")
            out.append([take_front(b, self.n) for b in part])
        return out
