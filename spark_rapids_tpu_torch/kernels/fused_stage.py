"""K5's source: the compacting stage, three Triton kernels per filter chain;
and K6's: the computing projection, one Triton kernel per projection.

The JAX package's ``fused.stage`` program
(``spark_rapids_tpu/exec/fused.py:202 TpuFusedStageExec._program``, built
``:272``) evaluates a filter/project chain and compacts the surviving rows
with a stable multi-operand sort on the drop flag.  Here the chain is
flattened to predicates and outputs over the stage's input columns
(``exec/fused.py flatten_chain``) and emitted, with kernel 1's emitter
registry (``kernels/fused_agg.py ChainEmitter``), into:

- ``stage_count``: one program per tile of ``BLOCK`` rows evaluates the
  predicates and writes the tile's number of survivors;
- ``stage_scan``: one program scans the tile counts in place into
  exclusive tile offsets and writes the total after them (the host reads
  it: the stage's one sync, which sizes its outputs exactly);
- ``stage_write``: each tile evaluates the predicates again, scans its
  keep flags (``tl.cumsum``) and writes, at its offset plus that rank, the
  survivors' row indices and the values of the outputs that compute
  something.

K6 (``project_source``) is the JAX package's ``expr.project`` in its
computing form (``spark_rapids_tpu/expressions/evaluator.py:160
eval_exprs_tpu``, built ``:197``): a projection with no filter.  Its one
kernel, ``stage_project``, writes the computed outputs of every row at
the row's own position, so it needs no count, no scan, no sync and no
row indices.

A string column is read through its chars and offsets (``in{i}``,
``in{i}_off``); the ``=``, ``<>`` and ``IN`` emitters compare it, or a
``Substring`` view of it, with a literal's bytes, and ``=`` and ``<>``
compare two such views (two columns' chars buffers: the lengths first,
then a byte loop bounded by the tile's longest equal length).  A computed
string output is K13's (``ops/string_ops.py``: a substring, a concat, a
string literal, an upper or lower case; and a string's length), written
after these kernels, or, for K6's string ``CASE
WHEN`` over one column and nulls, a view of that column, whose validity
plane alone K6 writes; any other is refused, by its expression.

Outputs that are input columns as they are (bare references) are not
written here: K5's caller gathers them through the row indices (K7), and
K6's passes them on as they are.  The
row indices are in input order, so the compaction is stable.  Only the
input columns that a predicate or a computed output reads are kernel
arguments.  This module only writes source text."""

from __future__ import annotations

from typing import List, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Alias, Expression
from spark_rapids_tpu_torch.expressions.conditional import CaseWhen
from spark_rapids_tpu_torch.kernels.fused_agg import (_PREAMBLE, _TL,
                                                      ChainEmitter,
                                                      load_columns,
                                                      referenced_columns,
                                                      table_params)

PROJECT_KERNEL = "stage_project"
COUNT_KERNEL = "stage_count"
SCAN_KERNEL = "stage_scan"
WRITE_KERNEL = "stage_write"

_SCAN = f'''

@triton.jit
def {SCAN_KERNEL}(counts, n_tiles, CHUNK: tl.constexpr):
    carry = tl.sum(tl.zeros([CHUNK], tl.int64), axis=0)
    for start in range(0, n_tiles, CHUNK):
        idx = start + tl.arange(0, CHUNK)
        inside = idx < n_tiles
        c = tl.load(counts + idx, mask=inside, other=0)
        tl.store(counts + idx, carry + tl.cumsum(c, axis=0) - c,
                 mask=inside)
        carry += tl.sum(c, axis=0)
    tl.store(counts + n_tiles, carry)
'''


def _kernel_type(e: Expression) -> str:
    dt = e.data_type
    if isinstance(dt, T.BooleanType):
        return "tl.uint8"
    if isinstance(dt, T.DecimalType):
        return "tl.int64"
    if dt not in _TL:
        raise NotImplementedError(
            f"a computed {dt} output ({e.sql()}) has no kernel form yet")
    return _TL[dt]


def _store(em: ChainEmitter, j: int, e: Expression, v: str, at: str,
           mask: str) -> List[str]:
    """The stores of computed output ``j`` (value ``v``) at row ``at``: a
    decimal128's hi and lo words into its ``[rows, 2]`` plane."""
    dt = e.data_type
    if isinstance(dt, T.DecimalType) and dt.is_decimal128:
        hi, lo = em.wide[v]
        return [f"tl.store(out{j} + 2 * {at}, {hi}, mask={mask})",
                f"tl.store(out{j} + 2 * {at} + 1, {lo}, mask={mask})"]
    return [f"tl.store(out{j} + {at}, {v}.to({_kernel_type(e)}), "
            f"mask={mask})"]


def _kernel(name: str, params: List[str], em: ChainEmitter,
            tail: List[str]) -> str:
    body = ["pid = tl.program_id(0)",
            "lane = tl.arange(0, BLOCK)",
            "offs = pid.to(tl.int64) * BLOCK + lane",
            "inb = offs < n_rows",
            "all_true = offs >= 0",
            "all_false = offs < 0",
            *em.prologue, *em.lines, *tail]
    return (f"\n\n@triton.jit(do_not_specialize=[\"n_rows\"])\n"
            f"def {name}({', '.join(params)}, BLOCK: tl.constexpr):\n" +
            "".join(f"    {line}\n" for line in body))


def stage_source(input_types: Sequence[T.DataType],
                 nullable: Sequence[bool],
                 conditions: Sequence[Expression],
                 computed: Sequence[Expression], n_literals: int,
                 n_tables: int = 0) -> str:
    """Source of a module with the three kernels of one stage.

    ``conditions`` and ``computed`` are expressions over the input columns;
    a column marked in ``nullable`` is read with its validity plane.  The
    kernels take the columns, the literal table, then the ``n_tables``
    tables of the code-space conjuncts (``DictContains``)."""
    used = referenced_columns(list(conditions) + list(computed))
    lits = (["lits"] if n_literals else []) + table_params(n_tables)

    em = ChainEmitter()
    params, _cols, sel = load_columns(input_types, nullable, used,
                                      conditions, em)
    count = _kernel(COUNT_KERNEL, params + lits + ["counts", "n_rows"], em,
                    [f"tl.store(counts + pid, tl.sum({sel}.to(tl.int64), "
                     "axis=0))"])

    em = ChainEmitter()
    params, cols, sel = load_columns(input_types, nullable, used,
                                     conditions, em)
    outs, stores = [], []
    for j, e in enumerate(computed):
        v, valid = em.emit(e, cols)
        outs += [f"out{j}", f"out{j}_valid"]
        stores += _store(em, j, e, v, "dst", sel)
        stores.append(f"tl.store(out{j}_valid + dst, {valid}.to(tl.uint8), "
                      f"mask={sel})")
    tail = [f"k = {sel}.to(tl.int32)",
            "dst = tl.load(offsets + pid) + (tl.cumsum(k, axis=0) - k)"
            ".to(tl.int64)",
            f"tl.store(out_idx + dst, offs, mask={sel})",
            *stores]
    write = _kernel(WRITE_KERNEL, params + lits +
                    ["offsets", "out_idx"] + outs + ["n_rows"], em, tail)
    return _PREAMBLE + count + _SCAN + write


def string_view_ordinal(e: Expression) -> int:
    """The input column a computed string output is a view of (a string
    ``CASE WHEN``, ``CaseWhen.view_column``); K6 writes its validity
    alone.  A substring or a concat K13 writes (``exec/fused.py
    StageProgram``) never comes here; any other computed string is
    refused, by its expression."""
    while isinstance(e, Alias):
        e = e.children[0]
    if not isinstance(e, CaseWhen):
        raise NotImplementedError(
            f"a computed {e.data_type} output ({e.sql()}) has no kernel "
            "form yet (K13 writes a substring, an upper or lower case of "
            "a string column and a concat of string columns and literals)")
    return e.view_column().ordinal


def project_source(input_types: Sequence[T.DataType],
                   nullable: Sequence[bool],
                   computed: Sequence[Expression], n_literals: int) -> str:
    """Source of a module with K6's one kernel: ``stage_project`` writes
    each computed output (data and validity) for every row of its tile,
    in row order; no count, no scan, no row indices.  A string output
    (a view, ``string_view_ordinal``) has its validity written alone."""
    used = referenced_columns(list(computed))
    em = ChainEmitter()
    params, cols, _sel = load_columns(input_types, nullable, used, [], em)
    outs, stores = [], []
    for j, e in enumerate(computed):
        v, valid = em.emit(e, cols)
        if isinstance(e.data_type, T.StringType):
            string_view_ordinal(e)
            outs.append(f"out{j}_valid")
            stores.append(f"tl.store(out{j}_valid + offs, "
                          f"{valid}.to(tl.uint8), mask=inb)")
            continue
        outs += [f"out{j}", f"out{j}_valid"]
        stores += _store(em, j, e, v, "offs", "inb")
        stores.append(f"tl.store(out{j}_valid + offs, {valid}.to(tl.uint8), "
                      "mask=inb)")
    lits = ["lits"] if n_literals else []
    return _PREAMBLE + _kernel(PROJECT_KERNEL, params + lits + outs +
                               ["n_rows"], em, stores)
