"""The planner (the analog of ``spark_rapids_tpu/plan/overrides.py``): turns
the logical plan a DataFrame builds into port execs, fuses each aggregate's
chain into one kernel (``plan/stages.py``), and refuses whatever this
slice of the port cannot run, naming it."""

from __future__ import annotations

from spark_rapids_tpu_torch.exec.aggregate import TorchHashAggregateExec
from spark_rapids_tpu_torch.exec.basic import (TorchFilterExec,
                                               TorchInMemoryScanExec,
                                               TorchProjectExec)
from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
from spark_rapids_tpu_torch.expressions.aggregates import Count, Sum
from spark_rapids_tpu_torch.plan import base as L
from spark_rapids_tpu_torch.plan.stages import fuse_device_stages

_SUPPORTED_AGGREGATES = (Sum, Count)


class TorchOverrides:
    def apply(self, logical: L.LogicalPlan) -> L.Exec:
        plan = fuse_device_stages(self._convert(logical))
        self._check(plan)
        return plan

    def _convert(self, node: L.LogicalPlan) -> L.Exec:
        if isinstance(node, L.Scan):
            return TorchInMemoryScanExec(node)
        child = self._convert(node.children[0])
        if isinstance(node, L.Filter):
            return TorchFilterExec(node.condition, child)
        if isinstance(node, L.Project):
            return TorchProjectExec(node.exprs, child)
        if isinstance(node, L.Aggregate):
            if node.layout.num_keys:
                raise NotImplementedError(
                    "grouped aggregation is not in this slice of the port")
            for a in node.layout.aggs:
                if not isinstance(a.func, _SUPPORTED_AGGREGATES):
                    raise NotImplementedError(
                        f"aggregate {type(a.func).__name__} is not in this "
                        "slice of the port")
            return TorchHashAggregateExec(node.layout, node.mode, child)
        if isinstance(node, L.Exchange):
            return TorchShuffleExchangeExec(child)
        raise NotImplementedError(
            f"{type(node).__name__} is not in this slice of the port")

    @staticmethod
    def _check(plan: L.Exec) -> None:
        def visit(node):
            if isinstance(node, (TorchFilterExec, TorchProjectExec)):
                raise NotImplementedError(
                    f"{node.node_string()} does not feed an aggregate; "
                    "unfused filters and projections are not in this "
                    "slice of the port")
            for c in node.children:
                visit(c)
        visit(plan)
