"""ORDER BY (the analog of ``spark_rapids_tpu/exec/sort.py``: ``SortSpec``
and ``TpuSortExec`` ``:221``).

``TorchSortExec`` sorts each partition's batch with K8 and gathers it
with K7.  A key that computes (the JAX package's hidden ``_ord`` columns
of ``TakeOrderedAndProject``; q36 orders by a ``CASE WHEN``) is computed
by K6 beside the keys that are columns; K8 sorts the key columns and K7
gathers the child's columns alone, so the computed keys never join the
output.  Over several partitions the planner puts a range exchange
(K11r) below it (``CpuSortExec(global_sort=True)`` over
``RangePartitioning``), so the sorted partitions come out in range
order; several batches of one partition are joined first (K7c).

Out of core (``TpuSortExec.execute_partition`` ``:244-278`` and
``_external_sort`` ``:280-334``): the partition's batches are registered
with the memory runtime as spillable pieces; where their bytes pass
``free_device_headroom(4)`` (``spark.rapids.sql.test.sort.
forceOutOfCore`` forces it; a ``SplitAndRetryOOM`` from the fast path
leads there too) the sort is external.  Groups of pieces up to that
budget are sorted on the card (K7c, K6 for computed keys, K8, K7) into
runs that keep their key columns, and each run is downloaded and staged
as a host spillable (the host tier may push it to disk).  The runs merge
on the host by their packed key bytes, ``merge_key_bytes`` over K8's
order words (``ops/sort_ops.py order_words_plain``: the null rank, NaN
after +inf, -0.0 as 0.0, strings widened to the widest run's words,
``probe_string_widths``), with numpy's stable argsort, so ties keep the
run order, and the merged rows go back to the card in batches of
``_MERGE_OUT_ROWS``.  The merge on the host is the JAX package's own
design (``:225-233``), not a fallback.  ``EXTERNAL_SORT_EVENTS`` counts
the external passes."""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   HostColumnarBatch)
from spark_rapids_tpu_torch.expressions.base import Expression
from spark_rapids_tpu_torch.ops import sort_ops
from spark_rapids_tpu_torch.ops.sort_ops import SORT_KEY_TYPES, SortOrder
from spark_rapids_tpu_torch.plan.base import (ExecContext, Partitions,
                                              UnaryExec, owned_partitions)

#: rows of each device batch the external sort's merge streams back
_MERGE_OUT_ROWS = 1 << 20
#: the run budget when the pool has no headroom left (JAX ``:288``)
_DEFAULT_RUN_BYTES = 64 << 20
#: passes of the external sort (tests and chip_smoke.py read it)
EXTERNAL_SORT_EVENTS = 0
_SIGN = np.uint64(1 << 63)


def _host_key_column(c):
    """A host key column as a CPU ``DeviceColumn`` (no copy), with a
    validity plane, so every run gives a key the same words."""
    from spark_rapids_tpu_torch.columnar.column import DeviceColumn
    valid = np.ones(len(c), dtype=np.bool_) if c.validity is None \
        else c.validity
    return DeviceColumn(torch.from_numpy(np.ascontiguousarray(c.data)),
                        torch.from_numpy(np.ascontiguousarray(valid)),
                        c.data_type, False,
                        None if c.offsets is None else
                        torch.from_numpy(np.ascontiguousarray(c.offsets)))


def probe_string_widths(key_batches: Sequence[HostColumnarBatch],
                        orders: Sequence[SortOrder]) -> dict:
    """The longest value of each string key over every run, by key
    index (every run of one merge packs a string key into as many words)."""
    widths: dict = {}
    for hb in key_batches:
        for i, o in enumerate(orders):
            c = hb.columns[o.ordinal]
            if c.offsets is None:
                continue
            lens = np.diff(c.offsets.astype(np.int64))
            widths[i] = max(widths.get(i, 1), int(lens.max()) if len(lens)
                            else 0, 1)
    return widths


def merge_key_bytes(hb: HostColumnarBatch, orders: Sequence[SortOrder],
                    string_widths: Optional[dict] = None) -> np.ndarray:
    """Each row's packed key bytes, whose bytewise order is the SQL order
    of ``orders`` over ``hb``'s columns: K8's order words
    (``order_words_plain``; signed order) with the sign bit flipped,
    big-endian.  Every run of one merge passes the same
    ``string_widths``."""
    n = hb.row_count
    planes = []
    for i, o in enumerate(orders):
        c = _host_key_column(hb.columns[o.ordinal])
        n_words = sort_ops.string_word_count(
            (string_widths or {}).get(i, 1)) if c.is_string else 1
        for w in sort_ops.order_words_plain(c, o, n_words):
            u = w.to(torch.int64).numpy().view(np.uint64) ^ _SIGN
            planes.append(u.astype(">u8").view(np.uint8).reshape(n, 8))
    packed = np.ascontiguousarray(np.concatenate(planes, axis=1)) \
        if planes else np.zeros((n, 1), dtype=np.uint8)
    return packed.view(f"|S{packed.shape[1]}").ravel()


@dataclasses.dataclass
class SortSpec:
    """A sort key at the expression level (Spark's SortOrder)."""
    expr: Expression
    ascending: bool = True
    nulls_first: Optional[bool] = None  # default: asc first, desc last

    @property
    def effective_nulls_first(self) -> bool:
        return self.ascending if self.nulls_first is None \
            else self.nulls_first

    def sql(self) -> str:
        return (f"{self.expr.sql()} {'ASC' if self.ascending else 'DESC'} "
                f"NULLS {'FIRST' if self.effective_nulls_first else 'LAST'}")


class TorchSortExec(UnaryExec):
    """``force_out_of_core``: the external sort whatever the pool holds
    (``spark.rapids.sql.test.sort.forceOutOfCore``)."""

    def __init__(self, specs: Sequence[SortSpec], child,
                 force_out_of_core: bool = False):
        from spark_rapids_tpu_torch.exec.fused import StageProgram
        super().__init__(child)
        self.specs = list(specs)
        self.force_out_of_core = force_out_of_core
        for s in self.specs:
            if s.expr.data_type not in SORT_KEY_TYPES:
                raise NotImplementedError(
                    f"a sort key of {s.expr.data_type} is not in the port "
                    "yet (int, date, long, double and string keys are)")
        # the key columns: K6 computes those that are not columns
        self.keys = StageProgram([("project", [s.expr for s in self.specs])],
                                 child.schema, 0)
        self.orders = [SortOrder(j, s.ascending, s.effective_nulls_first)
                       for j, s in enumerate(self.specs)]

    def node_string(self):
        return f"TorchSort[{', '.join(s.sql() for s in self.specs)}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        return [list(self.sort_partition(part, ctx.transfers))
                if part else []
                for part in owned_partitions(self.child.execute(ctx))]

    def sort_partition(self, batches: List[ColumnarBatch], transfers
                       ) -> Iterator[ColumnarBatch]:
        """One partition's batches in SQL order: one sorted batch under a
        retry frame where they fit ``free_device_headroom(4)``, else the
        external sort's batches.  The batches are registered as
        spillables first, as the JAX package does, so the budget is read
        with them counted; the list handed in is emptied, the catalog
        holding them from then on."""
        from spark_rapids_tpu_torch.memory.device_manager import \
            free_device_headroom
        from spark_rapids_tpu_torch.memory.retry import (SplitAndRetryOOM,
                                                         maybe_inject_oom,
                                                         with_retry_no_split)
        from spark_rapids_tpu_torch.memory.spillable import spillable_pieces
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        live = [b for b in batches if b.row_count]
        if not live:
            yield self.sort_batch(concat_batches(batches), transfers)
            return
        batches.clear()
        spills = spillable_pieces(live, transfers)
        budget = free_device_headroom(4)
        est = sum(sb.sized_nbytes for sb in spills)
        if not self.force_out_of_core and (budget is None or est <= budget):
            def attempt():
                maybe_inject_oom()
                bs = [sb.get_batch() for sb in spills]
                return self.sort_batch(
                    concat_batches(bs) if len(bs) > 1 else bs[0], transfers)
            try:
                out = with_retry_no_split(None, attempt)
                for sb in spills:
                    sb.close()
                yield out
                return
            except SplitAndRetryOOM:
                pass   # the input must be sorted in pieces
        yield from self._external_sort(spills, budget, transfers)

    def sort_batch(self, batch, transfers, keep_keys: bool = False):
        """The batch in SQL order: K6 for the computed keys, K8, then K7
        through the permutation; with ``keep_keys`` the key columns are
        gathered too and appended (an external sort's run)."""
        from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                       project_batch)
        from spark_rapids_tpu_torch.ops.batch_ops import gather_batch
        if batch.row_count == 0:
            return batch
        keys = project_batch(self.keys, batch, LiteralArgs([]),
                             [f"_ord{j}" for j in range(len(self.specs))],
                             transfers)
        perm = sort_ops.sort_permutation(keys.columns, self.orders,
                                         transfers)
        if keep_keys:
            batch = ColumnarBatch(batch.columns + keys.columns,
                                  batch.row_count, batch.names + keys.names)
        return gather_batch(batch, perm, transfers, unique=True)

    def _external_sort(self, spills, budget, transfers
                       ) -> Iterator[ColumnarBatch]:
        """Sorted runs on the card, staged as host spillables, merged on
        the host by packed key bytes, streamed back to the card."""
        import pyarrow as pa
        from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
        from spark_rapids_tpu_torch.memory.retry import (maybe_inject_oom,
                                                         with_retry_no_split)
        from spark_rapids_tpu_torch.memory.spillable import \
            SpillableColumnarBatch
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        global EXTERNAL_SORT_EVENTS
        EXTERNAL_SORT_EVENTS += 1
        run_budget = budget if budget else _DEFAULT_RUN_BYTES
        runs: List[SpillableColumnarBatch] = []
        group: List[SpillableColumnarBatch] = []
        group_bytes = 0
        n_payload = 0

        def flush_group():
            nonlocal group, group_bytes, n_payload

            def attempt():
                maybe_inject_oom()
                bs = [sb.get_batch() for sb in group]
                big = concat_batches(bs) if len(bs) > 1 else bs[0]
                return self.sort_batch(big, transfers, keep_keys=True)
            run = with_retry_no_split(None, attempt)
            n_payload = len(run.columns) - len(self.specs)
            hb = transfers.download_batch(run)
            for sb in group:
                sb.close()
            runs.append(SpillableColumnarBatch.from_host(
                hb, device=run.device))
            group, group_bytes = [], 0

        for sb in spills:
            if group and group_bytes + sb.sized_nbytes > run_budget:
                flush_group()
            group.append(sb)
            group_bytes += sb.sized_nbytes
        flush_group()
        # merge the runs by their packed key bytes
        host_runs = [r.get_host_batch() for r in runs]
        orders = [SortOrder(n_payload + j, o.ascending, o.nulls_first)
                  for j, o in enumerate(self.orders)]
        widths = probe_string_widths(host_runs, orders)
        keys = np.concatenate([merge_key_bytes(hb, orders, widths)
                               for hb in host_runs])
        order = np.argsort(keys, kind="stable")   # ties keep run order
        names = host_runs[0].names[:n_payload]
        tab = pa.concat_tables([hb.to_arrow().select(list(range(n_payload)))
                                for hb in host_runs])
        for r in runs:
            r.close()
        del host_runs, keys
        for off in range(0, tab.num_rows, _MERGE_OUT_ROWS):
            piece = batch_from_arrow(tab.take(pa.array(
                order[off:off + _MERGE_OUT_ROWS])))
            piece.names = names
            yield transfers.upload_batch(piece)

