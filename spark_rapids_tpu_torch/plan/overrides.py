"""The planner (the analog of ``spark_rapids_tpu/plan/overrides.py``): turns
the logical plan a DataFrame builds into port execs, pushes a filter down
to the file scan under it, fuses each filter/project chain into a kernel
(``plan/stages.py``), puts the decode of encoded columns where an
operator needs values (``plan/encoding.py``), hands the out-of-core test
keys to the sort and window execs as instance fields, and refuses
whatever the port cannot run yet, naming it."""

from __future__ import annotations

from spark_rapids_tpu_torch import config as C
from spark_rapids_tpu_torch import types as T
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
                                                           First, Min, Sum,
                                                           _CentralMoment)
from spark_rapids_tpu_torch.plan import base as L
from spark_rapids_tpu_torch.plan.stages import fuse_device_stages

#: (``Max`` is a ``Min``, ``Last`` a ``First``)
_SUPPORTED_AGGREGATES = (Sum, Count, Average, CountDistinct, _CentralMoment,
                         Min, First)


def check_min_max_first_last(f) -> None:
    """Refuses by name a min or max of strings (the JAX device path's
    ``exec/aggregate.py:663`` tag) and a min, max, first or last of a type
    K9, K1 and K3 do not take (the JAX device path takes no boolean,
    float, decimal or binary one either)."""
    from spark_rapids_tpu_torch.ops.agg_ops import (FIRST_LAST_TYPES,
                                                    MIN_MAX_TYPES)
    dt = f.children[0].data_type
    if isinstance(f, Min):
        if dt == T.STRING:
            raise NotImplementedError(
                f"{f.sql()}: min/max over strings not on device yet (as on "
                "the JAX device path)")
        if dt not in MIN_MAX_TYPES:
            raise NotImplementedError(
                f"{f.sql()}: min/max over {dt} is not in the port yet (int, "
                "date, long and double are)")
    elif isinstance(f, First) and dt not in FIRST_LAST_TYPES:
        raise NotImplementedError(
            f"{f.sql()}: first/last over {dt} is not in the port yet (int, "
            "date, long, double and string are)")


class TorchOverrides:
    def __init__(self, conf=None):
        from spark_rapids_tpu_torch.columnar.encoding import EncodingSettings
        from spark_rapids_tpu_torch.config import TorchConf
        self.conf = conf if conf is not None else TorchConf()
        self.encoding = EncodingSettings.of(self.conf)

    def apply(self, logical: L.LogicalPlan) -> L.Exec:
        from spark_rapids_tpu_torch.plan.encoding import \
            insert_materialize_boundaries
        self._ctes = {}
        return insert_materialize_boundaries(
            fuse_device_stages(self._convert(logical)), self.encoding)

    def _file_scan(self, node: L.FileScan, predicate=None) -> L.Exec:
        """The device scan; a filter right above it is pushed down to the
        reader (``push_scan_predicates``, JAX ``plan/overrides.py:345``),
        and stays above it, so the rows are exact either way."""
        import copy
        from spark_rapids_tpu_torch.io.parquet import TorchParquetScanExec
        scan = node.scan
        if predicate is not None and getattr(scan, "predicate", 1) is None:
            scan = copy.copy(scan)
            scan.predicate = predicate
        return TorchParquetScanExec(scan, self.encoding)

    def _convert(self, node: L.LogicalPlan) -> L.Exec:
        if isinstance(node, L.CteCache):
            # both readers of a CTE get the one exec
            if id(node) not in self._ctes:
                self._ctes[id(node)] = (node, TorchCteCacheExec(
                    self._convert(node.children[0])))
            return self._ctes[id(node)][1]
        if isinstance(node, L.Scan):
            return TorchInMemoryScanExec(node)
        if isinstance(node, L.FileScan):
            return self._file_scan(node)
        if isinstance(node, L.Filter) and \
                isinstance(node.children[0], L.FileScan):
            return TorchFilterExec(node.condition, self._file_scan(
                node.children[0], node.condition))
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
                check_min_max_first_last(a.func)
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
            return TorchSortExec(node.specs, child,
                                 self.conf.get_bool(C.FORCE_OOC_SORT))
        if isinstance(node, L.Limit):
            return TorchLimitExec(node.n, child)
        if isinstance(node, L.Window):
            return TorchWindowExec(
                node.window_cols, child,
                force_running=self.conf.get_bool(C.FORCE_RUNNING_WINDOW),
                force_bounded=self.conf.get_bool(C.FORCE_BOUNDED_WINDOW),
                force_out_of_core_sort=self.conf.get_bool(C.FORCE_OOC_SORT),
                max_span=self.conf.get_int(C.BOUNDED_WINDOW_MAX_SPAN))
        if isinstance(node, L.Expand):
            return TorchExpandExec(node.projections, node.schema, child)
        raise NotImplementedError(
            f"{type(node).__name__} is not in the port yet")
