"""The planner (the analog of ``spark_rapids_tpu/plan/overrides.py``): turns
the logical plan a DataFrame builds into port execs, fuses each
filter/project chain into a kernel (``plan/stages.py``), and refuses
whatever the port cannot run yet, naming it."""

from __future__ import annotations

from spark_rapids_tpu_torch.exec.aggregate import (TorchHashAggregateExec,
                                                   TorchKeyedAggregateExec)
from spark_rapids_tpu_torch.exec.basic import (TorchCteCacheExec,
                                               TorchFilterExec,
                                               TorchInMemoryScanExec,
                                               TorchLimitExec,
                                               TorchProjectExec,
                                               TorchUnionExec)
from spark_rapids_tpu_torch.exec.exchange import TorchShuffleExchangeExec
from spark_rapids_tpu_torch.exec.expand import TorchExpandExec
from spark_rapids_tpu_torch.exec.joins import (
    CROSS, TorchBroadcastNestedLoopJoinExec, TorchHashJoinExec)
from spark_rapids_tpu_torch.exec.sort import TorchSortExec
from spark_rapids_tpu_torch.exec.window import TorchWindowExec
from spark_rapids_tpu_torch.expressions.aggregates import (Average, Count,
                                                           CountDistinct,
                                                           Sum,
                                                           _CentralMoment)
from spark_rapids_tpu_torch.plan import base as L
from spark_rapids_tpu_torch.plan.stages import fuse_device_stages

_SUPPORTED_AGGREGATES = (Sum, Count, Average, CountDistinct, _CentralMoment)


class TorchOverrides:
    def apply(self, logical: L.LogicalPlan) -> L.Exec:
        self._ctes = {}
        return fuse_device_stages(self._convert(logical))

    def _convert(self, node: L.LogicalPlan) -> L.Exec:
        if isinstance(node, L.CteCache):
            # both readers of a CTE get the one exec
            if id(node) not in self._ctes:
                self._ctes[id(node)] = (node, TorchCteCacheExec(
                    self._convert(node.children[0])))
            return self._ctes[id(node)][1]
        if isinstance(node, L.Scan):
            return TorchInMemoryScanExec(node)
        if isinstance(node, L.Join) and node.how == CROSS:
            return TorchBroadcastNestedLoopJoinExec(
                self._convert(node.children[0]),
                self._convert(node.children[1]))
        if isinstance(node, L.Join):
            return TorchHashJoinExec(node.left_keys, node.right_keys,
                                     self._convert(node.children[0]),
                                     self._convert(node.children[1]),
                                     node.how, node.coalesce_keys,
                                     node.null_safe)
        if isinstance(node, L.Union):
            return TorchUnionExec([self._convert(c) for c in node.children],
                                  node.schema)
        child = self._convert(node.children[0])
        if isinstance(node, L.Filter):
            return TorchFilterExec(node.condition, child)
        if isinstance(node, L.Project):
            return TorchProjectExec(node.exprs, child)
        if isinstance(node, L.Aggregate):
            for a in node.layout.aggs:
                if not isinstance(a.func, _SUPPORTED_AGGREGATES):
                    raise NotImplementedError(
                        f"aggregate {type(a.func).__name__} is not in the "
                        "port yet")
                if isinstance(a.func, _CentralMoment) and \
                        not node.layout.num_keys:
                    raise NotImplementedError(
                        f"{a.func.sql()} without grouping keys is not in "
                        "the port yet (in a group-by it is)")
            if node.layout.num_keys:
                return TorchKeyedAggregateExec(node.layout, child,
                                               node.mode)
            return TorchHashAggregateExec(node.layout, node.mode, child)
        if isinstance(node, L.Exchange):
            return TorchShuffleExchangeExec(node.partitioning, child)
        if isinstance(node, L.Sort):
            return TorchSortExec(node.specs, child)
        if isinstance(node, L.Limit):
            return TorchLimitExec(node.n, child)
        if isinstance(node, L.Window):
            return TorchWindowExec(node.window_cols, child)
        if isinstance(node, L.Expand):
            return TorchExpandExec(node.projections, node.schema, child)
        raise NotImplementedError(
            f"{type(node).__name__} is not in the port yet")
