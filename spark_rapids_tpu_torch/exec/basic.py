"""Scan, filter and project execs (the analog of
``spark_rapids_tpu/exec/basic.py``).

``TorchInMemoryScanExec`` uploads the table at the first action and keeps
the device copy (``TpuInMemoryScanExec``, ``:120``), so later actions read
it from device memory.  ``TorchFilterExec`` and ``TorchProjectExec`` are
plan nodes for stage fusion: on this slice they run only inside a fused
aggregate (exec/fused.py), and the planner refuses a plan where one is
left standing."""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Expression, output_name
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
            f"{type(self).__name__} runs only inside a fused aggregate on "
            "this slice of the port")


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
