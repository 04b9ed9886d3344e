"""Fused filter -> project -> aggregate update: kernel 1 (the analog of
``spark_rapids_tpu/exec/fused.py``: ``TpuFusedAggExec._fused_update``
``:337`` with ``_trace_chain`` ``:82``; kind ``fused.agg_update``).

``fused_agg_update`` is the kernel's wrapper.  On a CUDA batch it launches
the Triton kernel that ``kernels/fused_agg.py`` emits for the chain
(``PROGRAMS_PER_SM`` program instances per SM walk tiles of ``BLOCK_ROWS``
rows with a grid stride, each writing one partial row; no atomics); on a
CPU batch it runs ``fused_agg_update_plain``.  Kernel 2 (ops/agg_ops.py)
then folds the partial rows into the partition's one buffer row, in a
fixed order.

The chain is flattened to its predicates and update inputs over the input
columns, so the kernel takes only the columns they read: a fixed-width
column's plane, a string column's chars and offsets (q13's filter reads
three strings, compared with literals' bytes inside the kernel), and the
validity plane of a column that may hold nulls.

A min or max buffer folds as kernel 2's min or max; a first or last
buffer is a row number in kernel 1 and kernel 2 (the least or greatest
row a program selected, folded by min or max within the batch), and
``FusedAggProgram.buffer_row`` gathers the batch's value there (K7), as
``global_agg_trace`` picks the row (JAX ``ops/agg_ops.py:199-208``).  A
partition's batches, then the partitions, merge under the JAX merge
kinds (kernel 2's ``FIRST`` takes the first buffer row even where its
value is null: ROADMAP queue 3).

Bound: the kernel reads every plane it takes once (on the slice-1 path 8
+ 8 + 4 bytes of data per row, and no validity: the bench's columns hold
no null; on q13 ten fixed-width columns and a few bytes of each string),
and writes 9 bytes per buffer per program; its arithmetic (under 100
integer operations per row for the hash, a byte compare per literal byte)
is far below the card's rate, so it is bound by device memory bytes.  The
grid stride keeps each program's accumulators in registers and reduces
them once, instead of once per tile.

The compacting stage, K5 (``TpuFusedStageExec``, kind ``fused.stage``),
is the second part of this module, and the computing projection, K6
(``eval_exprs_tpu``, kind ``expr.project``), the third.  K1 and K5 also
take batches whose string columns are dictionary codes
(``columnar/encoding.py``): ``for_batch`` gives the chain's variant over
the codes (``code_space_variant``), each conjunct over one such column a
lookup in a table of the dictionary's values, the other reads decoded
by K16 first."""

from __future__ import annotations

import copy
import functools
import hashlib
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, empty_data
from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     EvalContext,
                                                     output_name)
from spark_rapids_tpu_torch.expressions.evaluator import batch_cols
from spark_rapids_tpu_torch.kernels import fused_agg as K
from spark_rapids_tpu_torch.ops import agg_ops
from spark_rapids_tpu_torch.plan.base import ExecContext, Partitions, \
    UnaryExec

#: rows per tile, warps per program instance, program instances per SM
#: (picked by tools/sweep_fused.py: the bench chain on an H100 at 32M rows,
#: within 1% of the fastest setting both with and without validity reads)
BLOCK_ROWS = 1024
NUM_WARPS = 16
PROGRAMS_PER_SM = 2

#: launches of kernel 1 (incremented only where the kernel is launched)
LAUNCHES = 0
#: those launches of K1 whose chain runs K12 (a decimal operation,
#: comparison, cast or selection: ``kernels/fused_agg.py runs_k12``); K5's
#: and K6's are ``DECIMAL_STAGE_LAUNCHES`` and ``DECIMAL_PROJECT_LAUNCHES``
DECIMAL_LAUNCHES = 0


def chain_string(ops, promoted) -> str:
    """A fused chain as ``explain`` shows it, with its promoted literals."""
    parts = [f"F[{payload.sql()}]" if kind == "filter" else
             f"P[{', '.join(e.sql() for e in payload)}]"
             for kind, payload in ops]
    lits = ", ".join(f"$lit{p.slot}={p.value!r}" for p in promoted)
    return "(" + " -> ".join(parts) + ")" + (f" lits[{lits}]" if lits
                                             else "")


def _ops_signature(ops) -> Tuple:
    sig = []
    for kind, payload in ops:
        if kind == "filter":
            sig.append(("F", payload.sql(), str(payload.data_type)))
        else:
            sig.append(("P", tuple((e.sql(), str(e.data_type))
                                   for e in payload)))
    return tuple(sig)


class FusedAggProgram:
    """One chain over one input schema: the key of its kernels, and what
    kernel 2 needs to fold their partial rows.  The chain is flattened
    (``flatten_chain``) to its predicates and its update inputs over the
    input columns, so the kernel reads only the columns they use.  The
    chain has one kernel for each set of input columns that may hold
    nulls."""

    def __init__(self, ops, layout, input_types: Sequence[T.DataType],
                 n_literals: int):
        self.ops = list(ops)
        self.input_types = list(input_types)
        self.update_exprs = layout.update_input_exprs()
        self.update_specs = layout.update_specs()
        self.n_literals = n_literals
        self.n_tables = 0
        if layout.num_keys:
            raise NotImplementedError(
                "grouped aggregation is not in this slice of the port")
        schema = T.StructType([T.StructField(f"_c{i}", t, True)
                               for i, t in enumerate(self.input_types)])
        self.conditions, outputs = flatten_chain(self.ops, schema)
        self.update_inputs = [over_outputs(e, outputs)
                              for e in self.update_exprs]
        self.key = (_ops_signature(self.ops),
                    tuple(str(t) for t in self.input_types),
                    tuple((e.sql(), str(e.data_type))
                          for e in self.update_exprs),
                    tuple((o, k, cv, str(dt))
                          for o, k, cv, dt in self.update_specs),
                    n_literals)
        #: kernel 2 kinds that fold partial rows, a word each: sums and
        #: counts add (a decimal128 sum's two words as one 128-bit sum),
        #: min and max fold as themselves, first and last rows by min and
        #: max
        self.fold_kinds = []
        for _o, kind, _cv, dt in self.update_specs:
            self.fold_kinds.append(_fold_kind(kind, dt))
            if K.buffer_words(dt) == 2:
                self.fold_kinds.append(agg_ops.DEC128_LO)
        self.buffer_types = [dt for _o, _k, _cv, dt in self.update_specs]
        #: the input column whose value each first/last buffer gathers
        self.picks = [None] * len(self.update_specs)
        for j, (o, kind, _cv, _dt) in enumerate(self.update_specs):
            if kind in agg_ops.ROW_KINDS:
                self.picks[j] = bare_ordinal(self.update_inputs[o])
                if self.picks[j] is None:
                    raise NotImplementedError(
                        f"{kind} of a computed value "
                        f"({self.update_exprs[o].sql()}) in a global "
                        "aggregate is not in the port yet (of a column is)")
        self._encoded = {}
        self._setup()

    def buffer_row(self, words: torch.Tensor, ok: torch.Tensor,
                   batch: ColumnarBatch, names: Sequence[str],
                   transfers) -> ColumnarBatch:
        """The batch's buffer row from kernel 2's fold of kernel 1's
        table: a first/last buffer's word is a row of ``batch``, whose
        value K7 gathers (a null where no row was picked)."""
        return agg_ops.unpack_row(
            words, ok, self.buffer_types, names,
            [None if b is None else batch.columns[b] for b in self.picks],
            transfers)

    def _setup(self) -> None:
        self.used = K.referenced_columns(self.conditions +
                                         self.update_inputs)
        self.runs_k12 = K.runs_k12(self.conditions + self.update_inputs)
        # the kernel for columns that all may hold nulls; emitting it
        # checks that every expression has a kernel form
        self.compiled = self.kernel_for((True,) * len(self.input_types))

    def for_batch(self, batch: ColumnarBatch, lits: "LiteralArgs",
                  transfers):
        """``(program, batch, lits)`` for a batch that may hold encoded
        columns: the chain with its code-space conjuncts over the
        dictionary columns' codes, their tables in ``lits``, and the
        columns an update input reads decoded (K16)."""
        from spark_rapids_tpu_torch.columnar import encoding as ENC
        plan = ENC.plan_code_space(self.conditions, self.update_inputs,
                                   batch)
        if plan is None:
            return self, batch, lits
        batch, tables = ENC.encoded_inputs(plan, batch, lits.values,
                                           transfers)
        return code_space_variant(self, plan), batch, \
            lits.with_tables(tables)

    def kernel_for(self, nullable: Tuple[bool, ...]) -> "FusedKernel":
        """The kernel that reads the validity planes of the columns marked
        True in ``nullable`` and takes the others as all valid."""
        return get_or_build(
            "fused.agg_update", self.key + (nullable,),
            lambda: FusedKernel(K.kernel_source(
                self.input_types, nullable, self.conditions,
                self.update_inputs, self.update_specs, self.n_literals,
                self.n_tables)))


def _fold_kind(kind: str, dtype: T.DataType) -> int:
    """Kernel 2's kind that folds kernel 1's partial rows of a buffer."""
    if kind in agg_ops.ROW_KINDS:
        return agg_ops.MIN_I64 if kind.startswith("first") \
            else agg_ops.MAX_I64
    if kind in ("min", "max") or (kind == "sum" and
                                  isinstance(dtype, T.DecimalType)):
        return agg_ops.reduce_kind(kind, dtype)
    return agg_ops.SUM_F64 if kind == "sum" and dtype.is_floating \
        else agg_ops.SUM_I64


def code_space_variant(program, plan):
    """``program`` (a ``FusedAggProgram`` or a ``StageProgram``) over a
    batch that ``plan`` (``columnar/encoding.py plan_code_space``) reads:
    each kept dictionary column an INT column of codes, the conditions
    with their lookups; built once a plan signature."""
    variant = program._encoded.get(plan.signature)
    if variant is None:
        variant = copy.copy(program)
        variant.input_types = [T.INT if i in plan.kept else t
                               for i, t in enumerate(program.input_types)]
        variant.conditions = plan.conditions
        variant.n_tables = len(plan.slots)
        variant.key = program.key + ("codes",) + plan.signature
        variant._setup()
        program._encoded[plan.signature] = variant
    return variant


class FusedKernel:
    """A kernel-cache entry: the emitted source, and the module of Triton
    kernels imported from it at its first launch (Triton compiles each
    kernel at its first launch)."""

    def __init__(self, source: str, prefix: str = "fused_agg_"):
        self.source = source
        self.prefix = prefix
        self._lock = threading.Lock()
        self._module = None

    def kernel(self, name: str = K.KERNEL_NAME):
        with self._lock:
            if self._module is None:
                from spark_rapids_tpu_torch.kernels.build import \
                    load_triton_module
                module = self.prefix + hashlib.sha1(
                    self.source.encode()).hexdigest()[:16]
                self._module = load_triton_module(module, self.source)
            return getattr(self._module, name)


class LiteralArgs:
    """Promoted literal values: ``values`` for the plain version, ``words``
    (an int64 tensor on the batch's device) for the kernel; ``tables``,
    the device lookup tables of a batch's code-space conjuncts
    (``columnar/encoding.py DictContains``), for both."""

    def __init__(self, values: Sequence,
                 words: Optional[torch.Tensor] = None,
                 tables: Sequence[torch.Tensor] = ()):
        self.values = list(values)
        self.words = words
        self.tables = list(tables)

    def with_tables(self, tables: Sequence[torch.Tensor]) -> "LiteralArgs":
        return LiteralArgs(self.values, self.words, tables)

    @staticmethod
    def upload(promoted, transfers) -> "LiteralArgs":
        words = None
        if promoted:
            words = transfers.to_device(np.array(
                [K.literal_word(p.value, p.data_type) for p in promoted],
                dtype=np.int64))
        return LiteralArgs([p.value for p in promoted], words)


@functools.lru_cache(maxsize=None)
def _sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def grid_size(n_rows: int, device: torch.device) -> int:
    """Program instances for ``n_rows`` rows: one per tile, at most
    ``PROGRAMS_PER_SM`` per SM."""
    n_tiles = -(-n_rows // BLOCK_ROWS)
    return min(n_tiles, _sm_count(device.index) * PROGRAMS_PER_SM)


def _check_batch(program: FusedAggProgram, batch: ColumnarBatch) -> None:
    types = [c.data_type for c in batch.columns]
    if types != program.input_types:
        raise TypeError(f"batch of {types} for a kernel over "
                        f"{program.input_types}")


def fused_agg_update(program: FusedAggProgram, batch: ColumnarBatch,
                     lits: LiteralArgs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel 1's wrapper: ``(words, valid)`` tables of shape
    ``[n_programs, n_words]``, one partial row per program instance (a
    word a buffer, two for a decimal128 sum)."""
    _check_batch(program, batch)
    n_buffers = len(program.fold_kinds)
    device = batch.device
    if device.type == "cpu":
        return fused_agg_update_plain(program, batch, lits)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = batch.row_count
    if n == 0:
        # a grid of 0 is an error: no launch, one empty partial row
        return (torch.zeros((1, n_buffers), dtype=torch.int64, device=device),
                torch.tensor([[k == "count"
                               for _o, k, _c, dt in program.update_specs
                               for _w in range(K.buffer_words(dt))]],
                             device=device))
    if program.n_literals and (lits.words is None or
                               lits.words.device != device):
        raise ValueError("the literal table must lie on the batch's device")
    n_programs = grid_size(n, device)
    out = torch.empty((n_programs, n_buffers), dtype=torch.int64,
                      device=device)
    out_valid = torch.empty((n_programs, n_buffers), dtype=torch.bool,
                            device=device)
    args = _column_args(program, batch, lits)
    args += [out, out_valid.view(torch.uint8), n]
    kernel = program.kernel_for(
        tuple(not c.all_valid for c in batch.columns)).kernel()
    with torch.cuda.device(device):
        kernel[(n_programs,)](*args, BLOCK=BLOCK_ROWS, num_warps=NUM_WARPS)
    global LAUNCHES, DECIMAL_LAUNCHES
    LAUNCHES += 1
    DECIMAL_LAUNCHES += program.runs_k12
    return out, out_valid


def fused_agg_update_plain(program: FusedAggProgram, batch: ColumnarBatch,
                           lits: LiteralArgs
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version of kernel 1: the whole batch as one
    program, so the tables have one row; the chain flattened, as the
    kernel reads it."""
    _check_batch(program, batch)
    dev = batch.device
    ctx = EvalContext(batch_cols(batch), batch.row_count, dev,
                      lits.values, lits.tables)
    sel = torch.ones(batch.row_count, dtype=torch.bool, device=dev)
    for cond in program.conditions:
        p = cond.eval(ctx)
        sel = sel & p.valid & p.data
    words, oks = [], []
    for ordinal, kind, count_valid_only, dtype in program.update_specs:
        c = program.update_inputs[ordinal].eval(ctx)
        present = sel if kind == "count" and not count_valid_only \
            else sel & c.valid
        if kind == "count":
            words.append(present.sum())
            oks.append(torch.ones((), dtype=torch.bool, device=dev))
            continue
        if kind in agg_ops.ROW_KINDS:
            r = agg_ops.row_pick_plain(
                batch.row_count, present if kind.endswith("_valid") else sel,
                agg_ops.FIRST_VALID if kind.startswith("first")
                else agg_ops.LAST_VALID)
            words.append(r.clamp(min=0))
            oks.append(r >= 0)
            continue
        if kind in ("min", "max"):
            x = c.data.to(torch.float64).view(torch.int64) \
                if dtype.is_floating else c.data.to(torch.int64)
            words.append(agg_ops.min_max_plain(
                x, present, agg_ops.reduce_kind(kind, dtype)))
            oks.append(present.any())
            continue
        if K.buffer_words(dtype) == 2:
            words += list(agg_ops.sum128_plain(c.data[:, 0], c.data[:, 1],
                                               present))
            oks += [present.any()]
        elif dtype.is_floating:
            s = torch.where(present, c.data.to(torch.float64), 0.0).sum()
            words.append(s.reshape(1).view(torch.int64)[0])
        else:
            words.append(torch.where(present, c.data.to(torch.int64),
                                     0).sum())
        oks.append(present.any())
    return torch.stack(words).reshape(1, -1), torch.stack(oks).reshape(1, -1)


class TorchFusedAggExec(UnaryExec):
    """Fused [Filter|Project]* chain and the aggregate's update pass: one
    kernel-1 launch per batch, then a kernel-2 fold of its partial rows.
    PARTIAL yields one buffer row per batch; COMPLETE merges them and
    evaluates the final projection.

    A ``count(DISTINCT)`` (COMPLETE over one batch, no chain: the planner
    runs the chain as a stage below) is K15d's over one group, and a
    ``collect_list`` or ``collect_set`` K15's (``[]`` over no row), beside
    kernel 1 for the other aggregates, as the JAX package's
    ``_complete_collect`` (``exec/aggregate.py:510``) runs its collect
    slots beside the scalar ones."""

    def __init__(self, ops, layout, mode: str, child, promoted=()):
        from spark_rapids_tpu_torch.exec.aggregate import (COMPLETE,
                                                           _AggLayout,
                                                           collect_input,
                                                           distinct_input)
        from spark_rapids_tpu_torch.expressions.aggregates import (
            CollectList, CountDistinct)
        super().__init__(child)
        self.ops = list(ops)
        self.layout = layout
        self.mode = mode
        self.promoted = list(promoted)
        #: agg index -> the input ordinal of each count(DISTINCT), and of
        #: each collect_list or collect_set
        self.distinct = {i: distinct_input(a.func)
                         for i, a in enumerate(layout.aggs)
                         if isinstance(a.func, CountDistinct)}
        self.distinct.update({i: collect_input(a.func)
                              for i, a in enumerate(layout.aggs)
                              if isinstance(a.func, CollectList)})
        if self.distinct and (mode != COMPLETE or self.ops):
            raise ValueError("a count(DISTINCT) or a collect runs in "
                             "COMPLETE mode over a chain's output")
        #: the aggregates kernel 1 updates
        self.scalar = _AggLayout([], [a for i, a in enumerate(layout.aggs)
                                      if i not in self.distinct])
        self.program = FusedAggProgram(
            self.ops, self.scalar, [f.data_type for f in child.schema.fields],
            len(self.promoted)) if self.scalar.aggs else None

    @property
    def schema(self):
        from spark_rapids_tpu_torch.exec.aggregate import PARTIAL
        return self.layout.buffer_schema if self.mode == PARTIAL else \
            self.layout.result_schema

    def node_string(self):
        distinct = "".join(f", {self.layout.aggs[i].func.sql()}"
                           for i in self.distinct)
        return (f"TorchFusedAgg[mode={self.mode}, "
                f"keys={self.layout.num_keys}{distinct}]" +
                chain_string(self.ops, self.promoted))

    def update_batch(self, batch: ColumnarBatch, lits: LiteralArgs,
                     transfers=None) -> ColumnarBatch:
        """One buffer row for ``batch``: kernel 1 (its code-space
        conjuncts over a dictionary column's codes), then kernel 2's
        fold."""
        program, batch, lits = self.program.for_batch(batch, lits,
                                                      transfers)
        words, valid = fused_agg_update(program, batch, lits)
        row, row_valid = agg_ops.global_reduce(words, valid,
                                               self.program.fold_kinds)
        return self.program.buffer_row(row, row_valid, batch,
                                       self.scalar.buffer_names, transfers)

    def distinct_row(self, part: List[ColumnarBatch], ctx: ExecContext
                     ) -> ColumnarBatch:
        """The result row of an aggregation with a ``count(DISTINCT)`` or a
        collect: kernel 1 and 2 for the other aggregates, K15d for each
        distinct count, K15 for each collect."""
        from spark_rapids_tpu_torch.exec.aggregate import (SET, finish,
                                                           merge_partials)
        from spark_rapids_tpu_torch.expressions.aggregates import \
            CollectList
        if len(part) != 1:
            raise NotImplementedError(
                f"count(DISTINCT) over {len(part)} batches is not in the "
                "port yet")
        batch = part[0]
        scalar = iter([])
        if self.program is not None:
            lits = LiteralArgs.upload(self.promoted, ctx.transfers)
            scalar = iter(finish(self.scalar, merge_partials(
                self.scalar, [self.update_batch(batch, lits,
                                                ctx.transfers)],
                ctx.transfers)).columns)
        cols = []
        for i in range(len(self.layout.aggs)):
            if i not in self.distinct:
                cols.append(next(scalar))
                continue
            f = self.layout.aggs[i].func
            values = batch.columns[self.distinct[i]]
            if isinstance(f, CollectList):
                cols.append(agg_ops.collect(values, None, 1,
                                            f.kind == SET, ctx.transfers))
                continue
            counts = agg_ops.count_distinct(values)
            cols.append(DeviceColumn(counts, torch.ones_like(
                counts, dtype=torch.bool), T.LONG))
        return ColumnarBatch(cols, 1, self.layout.result_schema.names)

    def execute(self, ctx: ExecContext) -> Partitions:
        from spark_rapids_tpu_torch.exec.aggregate import (PARTIAL, finish,
                                                           merge_partials)
        if self.distinct:
            return [[self.distinct_row(part, ctx)]
                    for part in self.child.execute(ctx)]
        lits = LiteralArgs.upload(self.promoted, ctx.transfers)
        out = []
        for part in self.child.execute(ctx):
            rows = [self.update_batch(b, lits, ctx.transfers) for b in part]
            if self.mode == PARTIAL:
                out.append(rows)
            elif rows:
                out.append([finish(self.layout, merge_partials(
                    self.layout, rows, ctx.transfers))])
        return out


# -- K5: the compacting stage ---------------------------------------------------
#
# ``TorchFusedStageExec`` is the counterpart of ``TpuFusedStageExec``
# (``exec/fused.py:147``; its program ``_program`` ``:202``, kind
# ``fused.stage``): a filter/project chain that no aggregate absorbs.
# ``fused_stage_compact`` is K5's wrapper: it launches the three Triton
# kernels ``kernels/fused_stage.py`` emits for the chain (count, scan,
# write; the host reads the survivors' count between them), and returns
# the survivors' row indices and the computed outputs.  The outputs that
# are input columns as they are go through K7 with those indices.  A chain
# of bare column references with no filter is a column selection and
# launches nothing (``exec/basic.py TorchSelectExec``).

#: launches of K5 (wrapper calls that launch it), and of K5 in its
#: code-space mode (a stage with lookup tables of dictionary conjuncts,
#: ``columnar/encoding.py DictContains``), counted apart; and those of
#: either that run K12
STAGE_LAUNCHES = 0
CODE_SPACE_LAUNCHES = 0
DECIMAL_STAGE_LAUNCHES = 0
#: rows per tile, warps per program of K5's count and write kernels
STAGE_BLOCK = 1024
STAGE_WARPS = 4
#: tile counts one step of K5's scan takes
SCAN_CHUNK = 1024


def bare_ordinal(e) -> Optional[int]:
    """The input ordinal when ``e`` is a column as it is (under aliases)."""
    while isinstance(e, Alias):
        e = e.children[0]
    return e.ordinal if isinstance(e, BoundReference) else None


def flatten_chain(ops, schema: T.StructType):
    """``(conditions, outputs)`` of a filter/project chain, both as
    expressions over the chain's input columns."""
    current = [BoundReference(i, f.data_type, f.nullable, f.name)
               for i, f in enumerate(schema.fields)]
    conditions = []
    for kind, payload in ops:
        if kind == "filter":
            conditions.append(over_outputs(payload, current))
        else:
            current = [over_outputs(e, current) for e in payload]
    return conditions, current


def over_outputs(e, outputs):
    """``e``, which reads columns ``outputs``, rewritten to read what
    they read."""
    def fix(node):
        return outputs[node.ordinal] \
            if isinstance(node, BoundReference) else node
    return e.transform_up(fix)


class StageProgram:
    """One chain over one input schema: its predicates, its outputs (bare
    ordinals, K13's string forms or computed expressions) and the key of
    its kernels, one per set of input columns that may hold nulls.  A
    chain with predicates is K5's (``fused.stage``), one without K6's
    (``expr.project``); a computed string that K13 writes
    (``expressions/strings.py k13_form``) is left out of both and
    written after them from the chain's input columns (for K5's
    survivors alone)."""

    def __init__(self, ops, schema: T.StructType, n_literals: int):
        from spark_rapids_tpu_torch.expressions.aggregates import avg_form
        from spark_rapids_tpu_torch.expressions.strings import k13_form
        from spark_rapids_tpu_torch.kernels.fused_stage import \
            string_view_ordinal
        self.input_types = list(schema.types)
        self.conditions, outputs = flatten_chain(ops, schema)
        self.outputs = outputs
        self.bare = [bare_ordinal(e) for e in outputs]
        #: the form of each output written after K5 or K6: K13's of a
        #: computed string, the decimal avg finish's; else None
        self.strings = [None if b is not None else
                        k13_form(e) or avg_form(e)
                        for e, b in zip(outputs, self.bare)]
        self.computed = [e for e, b, f in zip(outputs, self.bare,
                                              self.strings)
                         if b is None and f is None]
        for e in self.computed:
            if isinstance(e.data_type, T.StringType):
                string_view_ordinal(e)   # a CASE view, or refused by name
        self.n_literals = n_literals
        self.n_tables = 0
        self.key = (_ops_signature(ops),
                    tuple(str(t) for t in self.input_types), n_literals)
        self._encoded = {}
        self._setup()

    def _setup(self) -> None:
        self.used = K.referenced_columns(self.conditions + self.computed)
        self.runs_k12 = K.runs_k12(self.conditions + self.computed)
        # emitting checks that every expression has a kernel form
        self.kernel_for((True,) * len(self.input_types))

    def for_batch(self, batch: ColumnarBatch, lits: LiteralArgs, transfers):
        """``(program, batch, lits, kept)`` for a batch that may hold
        encoded columns: the chain with its code-space conjuncts over the
        dictionary columns' codes (their tables in ``lits``), the columns
        a computed output or another predicate reads decoded (K16), and
        ``kept``, the dictionary columns read as codes, whose bare outputs
        the caller rewraps."""
        from spark_rapids_tpu_torch.columnar import encoding as ENC
        plan = ENC.plan_code_space(
            self.conditions, [e for e, b in zip(self.outputs, self.bare)
                              if b is None], batch)
        if plan is None:
            return self, batch, lits, ()
        encoded, tables = ENC.encoded_inputs(plan, batch, lits.values,
                                             transfers)
        return code_space_variant(self, plan), encoded, \
            lits.with_tables(tables), plan.kept

    @property
    def computes(self) -> bool:
        """An output is computed (by K6 or K13), not a column as it is."""
        return any(b is None for b in self.bare)

    def assemble(self, bare, kernel_outs, inputs, n: int, transfers,
                 rows: Optional[torch.Tensor] = None) -> List[DeviceColumn]:
        """The ``n`` output rows' columns in order: a bare one from
        ``bare`` (by input ordinal), a kernel-computed one from
        ``kernel_outs`` (K5's or K6's, in order), a string one written by
        K13, or a decimal average by its finish, from the ``inputs``
        columns (``rows``: the input row of each output row)."""
        it = iter(kernel_outs)
        out = []
        for b, form in zip(self.bare, self.strings):
            if b is not None:
                out.append(bare[b])
            elif form is None:
                out.append(next(it))
            elif transfers is None:
                raise ValueError("K13 needs the transfer gateway")
            else:
                out.append(form.run(inputs, n, inputs[0].device, transfers,
                                    rows))
        return out

    def kernel_for(self, nullable: Tuple[bool, ...]) -> FusedKernel:
        from spark_rapids_tpu_torch.kernels import fused_stage as S
        if not self.conditions:
            return get_or_build(
                "expr.project", self.key + (nullable,),
                lambda: FusedKernel(S.project_source(
                    self.input_types, nullable, self.computed,
                    self.n_literals), prefix="project_"))
        return get_or_build(
            "fused.stage", self.key + (nullable,),
            lambda: FusedKernel(S.stage_source(
                self.input_types, nullable, self.conditions, self.computed,
                self.n_literals, self.n_tables), prefix="fused_stage_"))


def _column_args(program, batch: ColumnarBatch, lits: LiteralArgs) -> List:
    """The kernel arguments of the columns ``program`` uses, in the order
    ``kernels/fused_agg.py load_columns`` names them (data, a string's
    offsets, the validity plane of a column that may hold nulls), then
    the literal table."""
    args: List = []
    for i in program.used:
        c = batch.columns[i]
        data = c.data.contiguous()
        args.append(data.view(torch.uint8) if data.dtype == torch.bool
                    else data)
        if c.is_string:
            args.append(c.offsets.contiguous())
        if not c.all_valid:
            args.append(c.validity.contiguous().view(torch.uint8))
    if program.n_literals:
        args.append(lits.words)
    if program.n_tables:
        args += lits.tables
    return args


def fused_stage_compact(program: StageProgram, batch: ColumnarBatch,
                        lits: LiteralArgs, transfers
                        ) -> Tuple[torch.Tensor, List[DeviceColumn]]:
    """K5's wrapper: ``(row indices of the survivors, computed outputs)``."""
    types = [c.data_type for c in batch.columns]
    if types != program.input_types:
        raise TypeError(f"batch of {types} for a stage over "
                        f"{program.input_types}")
    device = batch.device
    if device.type == "cpu":
        return fused_stage_compact_plain(program, batch, lits, transfers)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = batch.row_count
    if n == 0:
        return (torch.empty(0, dtype=torch.int64, device=device),
                [DeviceColumn(empty_data(0, e.data_type, device),
                              torch.empty(0, dtype=torch.bool,
                                          device=device), e.data_type)
                 for e in program.computed])
    if program.n_literals and (lits.words is None or
                               lits.words.device != device):
        raise ValueError("the literal table must lie on the batch's device")
    from spark_rapids_tpu_torch.kernels import fused_stage as S
    fk = program.kernel_for(tuple(not c.all_valid for c in batch.columns))
    args = _column_args(program, batch, lits)
    n_tiles = -(-n // STAGE_BLOCK)
    with torch.cuda.device(device):
        counts = torch.empty(n_tiles + 1, dtype=torch.int64, device=device)
        fk.kernel(S.COUNT_KERNEL)[(n_tiles,)](
            *args, counts, n, BLOCK=STAGE_BLOCK, num_warps=STAGE_WARPS)
        fk.kernel(S.SCAN_KERNEL)[(1,)](counts, n_tiles, CHUNK=SCAN_CHUNK)
        total, = transfers.read_counts([counts[n_tiles]])
        idx = torch.empty(total, dtype=torch.int64, device=device)
        outs, planes = [], []
        for e in program.computed:
            data = empty_data(total, e.data_type, device)
            valid = torch.empty(total, dtype=torch.bool, device=device)
            outs.append(DeviceColumn(data, valid, e.data_type))
            planes += [data.view(torch.uint8) if data.dtype == torch.bool
                       else data, valid.view(torch.uint8)]
        if total:
            fk.kernel(S.WRITE_KERNEL)[(n_tiles,)](
                *args, counts, idx, *planes, n, BLOCK=STAGE_BLOCK,
                num_warps=STAGE_WARPS)
    global STAGE_LAUNCHES, CODE_SPACE_LAUNCHES, DECIMAL_STAGE_LAUNCHES
    DECIMAL_STAGE_LAUNCHES += program.runs_k12
    if program.n_tables:
        CODE_SPACE_LAUNCHES += 1
    else:
        STAGE_LAUNCHES += 1
    return idx, outs


def fused_stage_compact_plain(program: StageProgram, batch: ColumnarBatch,
                              lits: LiteralArgs, transfers
                              ) -> Tuple[torch.Tensor, List[DeviceColumn]]:
    """The plain PyTorch version of K5 (it reads the survivors' count
    through the gateway, as the kernel does)."""
    dev = batch.device
    ctx = EvalContext(batch_cols(batch), batch.row_count, dev, lits.values,
                      lits.tables)
    sel = torch.ones(batch.row_count, dtype=torch.bool, device=dev)
    for cond in program.conditions:
        p = cond.eval(ctx)
        sel = sel & p.valid & p.data
    transfers.read_counts([sel.sum()])
    idx = torch.nonzero(sel).flatten()
    outs = []
    for e in program.computed:
        c = e.eval(ctx)
        outs.append(DeviceColumn(c.data[idx].to(e.data_type.torch_dtype),
                                 c.valid[idx], e.data_type))
    return idx, outs


class TorchFusedStageExec(UnaryExec):
    """A [Filter|Project]* chain compacted on the device: K5, then K7 for
    the columns it passes through."""

    def __init__(self, ops, child, promoted=()):
        super().__init__(child)
        self.ops = list(ops)
        self.promoted = list(promoted)
        self.program = StageProgram(self.ops, child.schema,
                                    len(self.promoted))

    @property
    def schema(self):
        projects = [p for k, p in self.ops if k == "project"]
        if not projects:
            return self.child.schema
        return T.StructType([T.StructField(output_name(e), e.data_type,
                                           e.nullable)
                             for e in projects[-1]])

    def node_string(self):
        return "TorchFusedStage" + chain_string(self.ops, self.promoted)

    def stage_batch(self, batch: ColumnarBatch, lits: LiteralArgs,
                    transfers) -> ColumnarBatch:
        """K5 over one batch; a dictionary column kept as codes (its
        conjuncts looked up in code space) leaves as the survivors'
        codes, still encoded."""
        from spark_rapids_tpu_torch.ops.batch_ops import gather_columns
        original = batch
        program, batch, lits, kept = self.program.for_batch(batch, lits,
                                                            transfers)
        idx, computed = fused_stage_compact(program, batch, lits,
                                            transfers)
        wanted = sorted({b for b in program.bare if b is not None})
        moved = dict(zip(wanted, gather_columns(
            [batch.columns[b] for b in wanted], idx, transfers,
            unique=True))) if wanted else {}
        for b in set(kept) & set(moved):
            moved[b] = original.columns[b].with_codes(moved[b])
        # K13 reads the input columns at the survivors' rows
        cols = program.assemble(moved, computed, batch.columns,
                                idx.shape[0], transfers, idx)
        return ColumnarBatch(cols, idx.shape[0], self.schema.names)

    def execute(self, ctx: ExecContext) -> Partitions:
        lits = LiteralArgs.upload(self.promoted, ctx.transfers)
        return [[self.stage_batch(b, lits, ctx.transfers) for b in part]
                for part in self.child.execute(ctx)]


# -- K6: the computing projection ---------------------------------------------
#
# A ``StageProgram`` with no predicates is the counterpart of the JAX
# package's ``expr.project`` in its computing form
# (``expressions/evaluator.py:160 eval_exprs_tpu``, built ``:197``),
# reached from a projection with no filter
# (``exec/basic.py TorchFusedProjectExec``) and from a group-by's final
# expressions (``exec/aggregate.py``, as ``exec/fused.py:653`` runs them).
# ``fused_project`` is K6's wrapper: one launch of the ``stage_project``
# kernel ``kernels/fused_stage.py`` emits, which writes each computed
# output for every row; bare outputs pass through as the input columns,
# and a substring, a concat or a string literal is K13's
# (``ops/string_ops.py``), written by ``project_batch`` after K6.
#
# Bound: device memory bytes.  It reads the planes of the columns the
# outputs read once and writes each output's data and validity once; a
# division is the most arithmetic it does per row.

#: launches of K6 (wrapper calls that launch it), and those that run K12
PROJECT_LAUNCHES = 0
DECIMAL_PROJECT_LAUNCHES = 0


def fused_project(program: StageProgram, batch: ColumnarBatch,
                  lits: LiteralArgs) -> List[DeviceColumn]:
    """K6's wrapper: the computed outputs, each of the batch's rows."""
    if program.conditions:
        raise ValueError("a chain with a filter is K5's work")
    types = [c.data_type for c in batch.columns]
    if types != program.input_types:
        raise TypeError(f"batch of {types} for a projection over "
                        f"{program.input_types}")
    device = batch.device
    if device.type == "cpu":
        return fused_project_plain(program, batch, lits)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if program.n_literals and (lits.words is None or
                               lits.words.device != device):
        raise ValueError("the literal table must lie on the batch's device")
    n = batch.row_count
    outs, planes = [], []
    for e in program.computed:
        valid = torch.empty(n, dtype=torch.bool, device=device)
        if isinstance(e.data_type, T.StringType):
            outs.append(_string_view(batch, e, valid))
            planes.append(valid.view(torch.uint8))
            continue
        data = empty_data(n, e.data_type, device)
        outs.append(DeviceColumn(data, valid, e.data_type))
        planes += [data.view(torch.uint8) if data.dtype == torch.bool
                   else data, valid.view(torch.uint8)]
    if n == 0 or not outs:
        return outs
    from spark_rapids_tpu_torch.kernels import fused_stage as S
    fk = program.kernel_for(tuple(not c.all_valid for c in batch.columns))
    args = _column_args(program, batch, lits)
    with torch.cuda.device(device):
        fk.kernel(S.PROJECT_KERNEL)[(-(-n // STAGE_BLOCK),)](
            *args, *planes, n, BLOCK=STAGE_BLOCK, num_warps=STAGE_WARPS)
    global PROJECT_LAUNCHES, DECIMAL_PROJECT_LAUNCHES
    PROJECT_LAUNCHES += 1
    DECIMAL_PROJECT_LAUNCHES += program.runs_k12
    return outs


def _string_view(batch: ColumnarBatch, e, valid) -> DeviceColumn:
    """A string output of K6: the chars and offsets of the column it is a
    view of, with its own validity plane."""
    from spark_rapids_tpu_torch.kernels.fused_stage import \
        string_view_ordinal
    c = batch.columns[string_view_ordinal(e)]
    return DeviceColumn(c.data, valid, T.STRING, offsets=c.offsets)


def fused_project_plain(program: StageProgram, batch: ColumnarBatch,
                        lits: LiteralArgs) -> List[DeviceColumn]:
    """The plain PyTorch version of K6."""
    ctx = EvalContext(batch_cols(batch), batch.row_count, batch.device,
                      lits.values)
    outs = []
    for e in program.computed:
        c = e.eval(ctx)
        if isinstance(e.data_type, T.StringType):
            outs.append(_string_view(batch, e, c.valid))
            continue
        outs.append(DeviceColumn(c.data.to(e.data_type.torch_dtype),
                                 c.valid, e.data_type))
    return outs


def project_batch(program: StageProgram, batch: ColumnarBatch,
                  lits: LiteralArgs, names: Sequence[str],
                  transfers=None) -> ColumnarBatch:
    """The projection of ``batch``: K6's outputs, K13's strings (which
    need ``transfers``), and the bare outputs as the input columns."""
    cols = program.assemble(batch.columns,
                            fused_project(program, batch, lits),
                            batch.columns, batch.row_count, transfers)
    return ColumnarBatch(cols, batch.row_count, names)
