"""K5's source: the compacting stage, three Triton kernels per filter chain.

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

Outputs that are input columns as they are (bare references) are not
written here: the caller gathers them through the row indices (K7).  The
row indices are in input order, so the compaction is stable.  Only the
input columns that a predicate or a computed output reads are kernel
arguments.  This module only writes source text."""

from __future__ import annotations

from typing import List, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Expression
from spark_rapids_tpu_torch.kernels.fused_agg import (_PREAMBLE, _TL,
                                                      ChainEmitter, Value)

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


def referenced_columns(exprs: Sequence[Expression]) -> List[int]:
    """The input ordinals ``exprs`` read, in order."""
    from spark_rapids_tpu_torch.expressions.base import BoundReference
    found = set()

    def visit(e):
        if isinstance(e, BoundReference):
            found.add(e.ordinal)
        for c in e.children:
            visit(c)
    for e in exprs:
        visit(e)
    return sorted(found)


def _kernel_type(dt: T.DataType) -> str:
    if isinstance(dt, T.BooleanType):
        return "tl.uint8"
    if dt not in _TL:
        raise NotImplementedError(
            f"a computed {dt} output has no kernel form yet")
    return _TL[dt]


def _body(input_types, nullable, used, conditions, em: ChainEmitter
          ) -> tuple:
    """Emits the loads of the ``used`` columns and the predicates:
    ``(parameter names, the columns as values, the selection mask)``."""
    params = []
    cols: List[Value] = [None] * len(input_types)
    for i in used:
        dt = input_types[i]
        params.append(f"in{i}")
        load = f"tl.load(in{i} + offs, mask=inb, other=0)"
        if isinstance(dt, T.BooleanType):
            load += " != 0"
        elif dt not in _TL:
            raise NotImplementedError(
                f"a {dt} column cannot be read inside a fused stage yet")
        em.lines.append(f"x{i} = {load}")
        valid = em.TRUE
        if nullable[i]:
            params.append(f"in{i}_valid")
            em.lines.append(f"m{i} = tl.load(in{i}_valid + offs, mask=inb, "
                            "other=0) != 0")
            valid = f"m{i}"
        cols[i] = (f"x{i}", valid)
    sel = "inb"
    for cond in conditions:
        pred, pred_valid = em.emit(cond, cols)
        sel = em.both(em.both(sel, pred_valid), pred)
    return params, cols, sel


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
                 computed: Sequence[Expression], n_literals: int) -> str:
    """Source of a module with the three kernels of one stage.

    ``conditions`` and ``computed`` are expressions over the input columns;
    a column marked in ``nullable`` is read with its validity plane."""
    used = referenced_columns(list(conditions) + list(computed))
    lits = ["lits"] if n_literals else []

    em = ChainEmitter()
    params, _cols, sel = _body(input_types, nullable, used, conditions, em)
    count = _kernel(COUNT_KERNEL, params + lits + ["counts", "n_rows"], em,
                    [f"tl.store(counts + pid, tl.sum({sel}.to(tl.int64), "
                     "axis=0))"])

    em = ChainEmitter()
    params, cols, sel = _body(input_types, nullable, used, conditions, em)
    outs, stores = [], []
    for j, e in enumerate(computed):
        v, valid = em.emit(e, cols)
        kt = _kernel_type(e.data_type)
        outs += [f"out{j}", f"out{j}_valid"]
        stores.append(f"tl.store(out{j} + dst, {v}.to({kt}), mask={sel})")
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
