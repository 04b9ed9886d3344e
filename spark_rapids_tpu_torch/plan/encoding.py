"""Where encoded columns are decoded (the analog of
``spark_rapids_tpu/plan/encoding.py insert_materialize_boundaries``).

A parquet scan with ``spark.rapids.sql.encoding.enabled`` uploads string
columns as dictionary codes (``columnar/encoding.py``).  Three execs read
codes: the compacting stage (K5: code-space conjuncts, codes gathered as
int planes and kept encoded), the fused aggregate (K1: code-space
conjuncts) and the column selection (views).  In front of every other
exec whose input may carry codes, this pass puts a
``TorchMaterializeEncodedExec``, which decodes them with K16: joins
(K10), group-bys (K9), sorts (K8), exchanges (K11h hashes the values, so
partition ids equal the plain path's), windows, computed outputs (K6,
K13), unions, limits and CTEs.  The result of a query may keep its
codes: the download reassembles them against the host dictionary.

With ``lateMaterialization`` false a materialize node also sits right
above every encoding scan, so the bus still carries codes but every
operator sees values.  With ``encoding.enabled`` false the scan uploads
plain columns and the pass inserts nothing."""

from __future__ import annotations

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.plan.base import Exec


def may_encode(node: Exec) -> bool:
    """``node``'s output batches may hold encoded columns."""
    from spark_rapids_tpu_torch.exec.basic import TorchSelectExec
    from spark_rapids_tpu_torch.exec.fused import TorchFusedStageExec
    from spark_rapids_tpu_torch.io.multifile import TorchFileScanExec
    if isinstance(node, TorchFileScanExec):
        # only string columns keep their dictionaries; RLE takes any
        # fixed-width one
        return node.encoding.enabled and (
            node.encoding.rle_enabled or
            any(isinstance(t, T.StringType) for t in node.schema.types))
    if isinstance(node, (TorchFusedStageExec, TorchSelectExec)):
        return may_encode(node.child)
    return False


def reads_codes(node: Exec) -> bool:
    """``node`` takes encoded columns from its child."""
    from spark_rapids_tpu_torch.exec.basic import (
        TorchMaterializeEncodedExec, TorchSelectExec)
    from spark_rapids_tpu_torch.exec.fused import (TorchFusedAggExec,
                                                   TorchFusedStageExec)
    if isinstance(node, TorchFusedAggExec):
        # K15d reads the chain's output as values
        return not node.distinct
    return isinstance(node, (TorchFusedStageExec, TorchSelectExec,
                             TorchMaterializeEncodedExec))


def insert_materialize_boundaries(plan: Exec, encoding) -> Exec:
    """``plan`` with a ``TorchMaterializeEncodedExec`` in front of each
    exec that needs values from a child that may carry codes (and, with
    late materialization off, above each encoding scan)."""
    from spark_rapids_tpu_torch.exec.basic import TorchMaterializeEncodedExec
    from spark_rapids_tpu_torch.io.multifile import TorchFileScanExec
    if not encoding.enabled:
        return plan
    done = {}

    def fix(node: Exec) -> Exec:
        # a node two branches share (a CTE) is fixed once
        if id(node) in done:
            return done[id(node)][1]
        kids = []
        for c in node.children:
            c = fix(c)
            early = not encoding.late_materialization and \
                isinstance(c, TorchFileScanExec)
            if may_encode(c) and (early or not reads_codes(node)):
                c = TorchMaterializeEncodedExec(c)
            kids.append(c)
        node.children = kids
        done[id(node)] = (node, node)
        return node

    out = fix(plan)
    if not encoding.late_materialization and \
            isinstance(out, TorchFileScanExec):
        out = TorchMaterializeEncodedExec(out)
    return out
