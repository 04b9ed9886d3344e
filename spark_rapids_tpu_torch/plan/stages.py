"""Stage fusion and literal promotion (the analog of
``spark_rapids_tpu/plan/stages.py``).

``fuse_device_stages`` (``:138``) folds the filter/project chain under a
partial or complete global aggregate into one ``TorchFusedAggExec`` (one
kernel-1 launch per batch), and every other chain into a compacting stage (K5)
when it filters, a column selection with no launch when it only picks and
renames columns, and else a computing projection (K6).
``promote_stage_literals`` (``:84``) turns eligible literals of the chain into
slots read at run time, so the kernel cache key depends on the plan's shape and
not on literal values: ``w > 0`` and ``w > 5`` share one kernel. As in the JAX
package only a literal directly under ``>``, ``=``, ``+`` or ``*`` whose
sibling has the same type and reads a column is promoted."""

from __future__ import annotations

from typing import List, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Expression, Literal


class PromotedLiteral(Literal):
    """A literal hoisted out of a fused kernel: ``sql()`` renders a slot
    placeholder; ``eval`` reads the slot's runtime value when one is
    bound, else its own value."""

    def __init__(self, value, dtype, slot: int):
        super().__init__(value, dtype)
        self.slot = slot

    def sql(self):
        return f"$lit{self.slot}:{self._dtype}"

    def eval(self, ctx):
        vals = ctx.literal_args
        return ctx.full(self.value if vals is None else vals[self.slot],
                        self._dtype)


def _promotable_parents():
    from spark_rapids_tpu_torch.expressions import arithmetic as A
    from spark_rapids_tpu_torch.expressions import predicates as P
    return (P.GreaterThan, P.EqualTo, A.Add, A.Multiply)


_PROMOTABLE_TYPES = (T.IntegerType, T.LongType, T.DoubleType)


def promote_stage_literals(ops) -> Tuple[list, List[PromotedLiteral]]:
    """Rewrites a chain's ops, swapping eligible literals for slots.
    Returns (new ops, promoted literals in slot order)."""
    parents = _promotable_parents()
    promoted: List[PromotedLiteral] = []

    def has_input(e: Expression) -> bool:
        if isinstance(e, Literal):
            return False
        if not e.children:
            return True
        return any(has_input(c) for c in e.children)

    def eligible(lit: Expression, sibling: Expression) -> bool:
        if type(lit) not in (Literal, PromotedLiteral) or lit.value is None:
            return False
        if not isinstance(lit.data_type, _PROMOTABLE_TYPES):
            return False
        return has_input(sibling) and sibling.data_type == lit.data_type

    def walk(e: Expression) -> Expression:
        kids = [walk(c) for c in e.children]
        if isinstance(e, parents) and len(kids) == 2:
            for i in (0, 1):
                if eligible(kids[i], kids[1 - i]):
                    pl = PromotedLiteral(kids[i].value, kids[i].data_type,
                                         len(promoted))
                    promoted.append(pl)
                    kids[i] = pl
        return e.with_children(kids) if kids else e

    new_ops = []
    for kind, payload in ops:
        if kind == "filter":
            new_ops.append(("filter", walk(payload)))
        else:
            new_ops.append(("project", [walk(p) for p in payload]))
    return new_ops, promoted


def fuse_device_stages(plan):
    """Folds every chain of filters and projections into one exec: under a
    partial or complete global aggregate, a ``TorchFusedAggExec`` (K1);
    elsewhere, a ``TorchFusedStageExec`` (K5) when the chain filters, a
    ``TorchSelectExec`` when it only picks and renames columns, else a
    ``TorchFusedProjectExec`` (K6)."""
    from spark_rapids_tpu_torch.exec.aggregate import (FINAL,
                                                       TorchHashAggregateExec)
    from spark_rapids_tpu_torch.exec.basic import (TorchFilterExec,
                                                   TorchFusedProjectExec,
                                                   TorchProjectExec,
                                                   TorchSelectExec)
    from spark_rapids_tpu_torch.exec.fused import (TorchFusedAggExec,
                                                   TorchFusedStageExec,
                                                   bare_ordinal)

    def chain_of(node):
        ops = []
        cur = node
        while True:
            if isinstance(cur, TorchFilterExec):
                ops.append(("filter", cur.condition))
            elif isinstance(cur, TorchProjectExec):
                ops.append(("project", cur.exprs))
            else:
                return list(reversed(ops)), cur
            cur = cur.child

    def selection(top, ops, base):
        """The child ordinals when the chain only picks columns."""
        ordinals = list(range(len(base.schema)))
        for kind, payload in ops:
            if kind == "filter":
                return None
            picked = [bare_ordinal(e) for e in payload]
            if None in picked:
                return None
            ordinals = [ordinals[i] for i in picked]
        return TorchSelectExec(ordinals, top.schema, base)

    done = {}

    def fuse(node):
        # a node two branches share (a CTE) is fused once
        if id(node) not in done:
            done[id(node)] = (node, fuse_node(node))
        return done[id(node)][1]

    def fuse_node(node):
        if isinstance(node, TorchHashAggregateExec) and \
                node.mode != FINAL and not node.layout.num_keys:
            ops, base = chain_of(node.child)
            ops, lits = promote_stage_literals(ops)
            return TorchFusedAggExec(ops, node.layout, node.mode, fuse(base),
                                     promoted=lits)
        if isinstance(node, (TorchFilterExec, TorchProjectExec)):
            ops, base = chain_of(node)
            base = fuse(base)
            picked = selection(node, ops, base)
            if picked is not None:
                return picked
            ops, lits = promote_stage_literals(ops)
            if any(kind == "filter" for kind, _p in ops):
                return TorchFusedStageExec(ops, base, promoted=lits)
            return TorchFusedProjectExec(ops, base, promoted=lits)
        node.children = [fuse(c) for c in node.children]
        return node

    return fuse(plan)
