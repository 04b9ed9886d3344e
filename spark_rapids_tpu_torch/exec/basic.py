"""Scan, filter, project, column selection and limit execs (the analog of
``spark_rapids_tpu/exec/basic.py``).

``TorchInMemoryScanExec`` uploads the table at the first action and keeps
the device copy (``TpuInMemoryScanExec``, ``:120``), so later actions read
it from device memory.  ``TorchFilterExec`` and ``TorchProjectExec`` are
plan nodes for stage fusion: the planner folds each chain of them into a
fused aggregate (K1), a compacting stage (K5, exec/fused.py) when the
chain filters, a ``TorchSelectExec``, which picks and renames columns
with no launch, when it only picks columns, and else a
``TorchFusedProjectExec``, which computes its outputs with K6
(``TpuProjectExec`` over ``eval_exprs_tpu``).  ``TorchLimitExec``
(``TpuLocalLimitExec``, ``:434``) keeps the first rows of one partition
as views, and over several partitions streams them in order until it
has its rows (``TpuGlobalLimitExec``, ``:566``), joined into one batch
(K7c).  ``TorchCteCacheExec`` (``TpuCteCacheExec``,
``:496``) runs a plan that two branches use once per action.
``TorchUnionExec`` (``TpuUnionExec``, ``:641``) hands on its children's
partitions, with no device work.  ``TorchMaterializeEncodedExec``
(``:793``) decodes encoded columns (K16) where ``plan/encoding.py`` puts
it."""

from __future__ import annotations

from typing import Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.expressions.base import Expression, output_name
from spark_rapids_tpu_torch.ops.batch_ops import take_front
from spark_rapids_tpu_torch.plan.base import (Exec, ExecContext, LeafExec,
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


class TorchMaterializeEncodedExec(UnaryExec):
    """Decodes every encoded column of its input with K16
    (``TpuMaterializeEncodedExec``, JAX ``exec/basic.py:793``): the
    boundary ``plan/encoding.py`` puts in front of an exec that needs
    values."""

    def node_string(self):
        return "TorchMaterializeEncoded"

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.columnar.encoding import \
            materialize_batch
        return [[materialize_batch(b, ctx.transfers) for b in part]
                for part in self.child.execute(ctx)]


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


class TorchFusedProjectExec(UnaryExec):
    """A projection chain with no filter: K6 writes the outputs that
    compute something, for every row; bare columns pass through."""

    def __init__(self, ops, child, promoted=()):
        from spark_rapids_tpu_torch.exec.fused import StageProgram
        super().__init__(child)
        self.ops = list(ops)
        self.promoted = list(promoted)
        self.program = StageProgram(self.ops, child.schema,
                                    len(self.promoted))
        self._schema = T.StructType([
            T.StructField(output_name(e), e.data_type, e.nullable)
            for e in self.ops[-1][1]])

    @property
    def schema(self):
        return self._schema

    def node_string(self):
        from spark_rapids_tpu_torch.exec.fused import chain_string
        return "TorchFusedProject" + chain_string(self.ops, self.promoted)

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.exec.fused import (LiteralArgs,
                                                       project_batch)
        lits = LiteralArgs.upload(self.promoted, ctx.transfers)
        names = self._schema.names
        return [[project_batch(self.program, b, lits, names, ctx.transfers)
                 for b in part]
                for part in self.child.execute(ctx)]


class TorchCteCacheExec(UnaryExec):
    """A plan two branches read (a ``WITH`` name used twice): its child
    runs once per action, and the next action runs it again, as
    ``TpuCteCacheExec`` keeps one result per execution epoch.  An action
    is one ``ExecContext``."""

    def __init__(self, child):
        super().__init__(child)
        self._ctx = None
        self._result: Partitions = []
        #: how many times the child ran
        self.runs = 0

    def node_string(self):
        return "TorchCteCache"

    def execute(self, ctx: ExecContext) -> Partitions:
        if self._ctx is not ctx:
            self._result = self.child.execute(ctx)
            self._ctx = ctx
            self.runs += 1
        return self._result


class TorchUnionExec(Exec):
    """UNION ALL (``CpuUnionExec``/``TpuUnionExec``, ``:614``, ``:641``):
    the children's partitions in order, their batches as they are; no
    launch.  ``num_partitions`` is the sum of the children's."""

    def __init__(self, children, schema: T.StructType):
        super().__init__(children)
        self._schema = schema

    @property
    def schema(self):
        return self._schema

    @property
    def num_partitions(self):
        return sum(c.num_partitions for c in self.children)

    def node_string(self):
        return f"TorchUnion[{len(self.children)}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        names = self._schema.names
        return [[ColumnarBatch(b.columns, b.row_count, names) for b in part]
                for c in self.children for part in c.execute(ctx)]


class TorchLimitExec(UnaryExec):
    """LIMIT: the first ``n`` rows of the child's partitions, in
    partition order, as one partition; of one batch, views of it."""

    def __init__(self, n: int, child):
        super().__init__(child)
        self.n = n

    @property
    def num_partitions(self):
        return 1

    def node_string(self):
        return f"TorchLimit[{self.n}]"

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.ops.batch_ops import concat_batches
        parts = self.child.execute(ctx)
        if len(parts) == 1 and len(parts[0]) <= 1:
            return [[take_front(b, self.n) for b in parts[0]]]
        pieces, left = [], self.n
        for b in (b for part in parts for b in part):
            if left <= 0:
                break
            pieces.append(take_front(b, left))
            left -= pieces[-1].row_count
        return [[concat_batches(pieces)] if pieces else []]
