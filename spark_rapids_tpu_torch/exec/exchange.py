"""Single-partition exchange (the analog of ``spark_rapids_tpu/exec/
exchange.py`` under ``SinglePartitioning``): in one process it hands every
child partition's batches, already on the device, to one reducer.  Hash
and range exchanges come with the next slice."""

from __future__ import annotations

from spark_rapids_tpu_torch.plan.base import ExecContext, Partitions, \
    UnaryExec


class TorchShuffleExchangeExec(UnaryExec):
    @property
    def num_partitions(self):
        return 1

    def node_string(self):
        return "TorchExchange[SinglePartition]"

    def execute(self, ctx: ExecContext) -> Partitions:
        return [[b for part in self.child.execute(ctx) for b in part]]
