"""Kernel 1's source: one Triton kernel per filter -> project -> update chain.

The JAX package traces one XLA program per chain signature
(``spark_rapids_tpu/exec/fused.py:337 TpuFusedAggExec._fused_update`` with
``_trace_chain`` ``:82`` and ``ops/agg_ops.py:259 global_agg_trace``).  The
counterpart here emits the source of one ``@triton.jit`` kernel per chain
signature from the expression tree:

- each program instance walks tiles of ``BLOCK`` rows with a grid stride
  (tile ``pid``, ``pid + n_programs``, ...) and loads each input column
  the flattened chain reads once (``load_columns``: a string column as its
  chars and offsets), with its validity plane (bool viewed as uint8) where
  the column may hold nulls: a column known to hold none is all valid,
  read no plane, and gets a kernel of its own;
- filters AND into a selection mask that the reductions read, with no
  compaction; projections are evaluated inline; Spark's murmur3 runs as
  uint32 device functions with wrapping multiplies and logical shifts;
- each lane adds its rows into per-buffer accumulators kept in registers
  across tiles, and the program reduces them once at the end, writing one
  partial row: for each buffer a word (int64 sum with wrap, double sum as
  its bits, or a count) and a validity byte, into an ``[n_programs,
  n_buffers]`` table the wrapper allocates.  No atomics: kernel 2 folds
  the table in a fixed order, and for a given grid every addition happens
  in a fixed order;
- min and max (``_global_reduce`` ``:180-198``) keep an int64 word a lane:
  an int, date or long widened, a double's bits mapped to an int64 that
  orders as the double does (-0.0 below 0.0), with NaN counted apart, as
  ``_segment_reduce`` keeps it; the program writes its min or max (a
  double's NaN where its rule says), which kernel 2 folds under the same
  kind;
- first and last (and their ``_valid`` forms, ``:199-208``) keep the
  lowest or highest selected row (present row) a lane; the program writes
  its lowest or highest row, "none" (not valid) where it selected none,
  and kernel 2 folds the rows by min or max, so a program with no row is
  skipped within a batch; the caller gathers the value (K7).

Decimals (K12, ``expressions/decimal_math.py``): a decimal64 value is an
int64 of the kernel, a decimal128 a (hi, lo) pair of int64 values (a
column's ``[rows, 2]`` plane loaded as two planes); ``Sym`` values run
``decimal_math``'s algorithms (the plain version's own code) and write
them into the kernel as int64 operations, so the kernel does the plain
version's arithmetic step for step: add, subtract, multiply, divide and
remainder with rescales and bound checks against 10^p, the 64 x 64 ->
128 multiply in 32-bit limbs, the 128-bit add and the HALF_UP divide by
10^d, comparisons across scales, the decimal casts.  A decimal128 sum
(``_segment_reduce``'s four 32-bit limbs) keeps four int64 limb sums a
lane; the program sums them, propagates the carries once and writes the
(hi, lo) pair as two words of its partial row.

Promoted literals (``plan/stages.py``) are read from a runtime table of
int64 words, so one built kernel serves every literal value.  K5 and K6
(``kernels/fused_stage.py``) share the emitters and ``load_columns``:
comparisons (``=``, ``<>``, the orders; strings against a literal's bytes
or another view's), ``IN``, ``NOT`` and Kleene ``AND``/``OR``, arithmetic
(``+``, ``-``, ``*``, ``/``, ``div``, ``%``), ``sqrt``, casts, ``If``,
``CASE WHEN`` (a string one as a view of its column), substring views
and murmur3.

The emitters live in a registry keyed by expression class, so the
expression modules never import ``triton``; a class with no emitter is
refused when a chain is planned.  This module only writes source text."""

from __future__ import annotations

import struct
from typing import Callable, Dict, List, Sequence, Tuple

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import unscaled_of, words_of
from spark_rapids_tpu_torch.columnar.encoding import DictContains
from spark_rapids_tpu_torch.expressions import arithmetic as A
from spark_rapids_tpu_torch.expressions import cast as CA
from spark_rapids_tpu_torch.expressions import decimal_math as DM
from spark_rapids_tpu_torch.expressions import conditional as CO
from spark_rapids_tpu_torch.expressions import hashing as H
from spark_rapids_tpu_torch.expressions import mathexprs as M
from spark_rapids_tpu_torch.expressions import predicates as P
from spark_rapids_tpu_torch.expressions import strings as ST
from spark_rapids_tpu_torch.expressions.base import (Alias, BoundReference,
                                                     Expression, Literal)
from spark_rapids_tpu_torch.ops.agg_ops import ROW_KINDS
from spark_rapids_tpu_torch.plan.stages import PromotedLiteral

KERNEL_NAME = "fused_agg_update"

_TL = {T.INT: "tl.int32", T.LONG: "tl.int64", T.DOUBLE: "tl.float64",
       T.DATE: "tl.int32"}

#: a generated value: (data expression, validity expression) names
Value = Tuple[str, str]
Emitter = Callable[["ChainEmitter", Expression, List[Value]], Value]

EMITTERS: Dict[type, Emitter] = {}


def emits(*classes: type):
    def register(fn: Emitter) -> Emitter:
        for cls in classes:
            EMITTERS[cls] = fn
        return fn
    return register


def _signed32(x: int) -> int:
    return x - (1 << 32) if x >= 1 << 31 else x


def f64_bits(value: float) -> int:
    return struct.unpack("<q", struct.pack("<d", float(value)))[0]


def literal_word(value, dtype: T.DataType) -> int:
    """A literal's value as the int64 word the kernel reads."""
    if dtype.is_floating:
        return f64_bits(value)
    if isinstance(dtype, T.DecimalType):
        return unscaled_of(value, dtype.scale)
    if isinstance(dtype, T.DateType):
        return T.date_days(value)
    return int(value)


_PREAMBLE = f'''"""Generated by spark_rapids_tpu_torch/kernels/fused_agg.py."""
import triton
import triton.language as tl


@triton.jit
def _c32(value: tl.constexpr, BLOCK: tl.constexpr):
    # a uint32 plane from the signed 32-bit pattern of a constant
    return tl.full([BLOCK], value, tl.int32).to(tl.uint32, bitcast=True)


@triton.jit
def _rotl32(x, r: tl.constexpr, BLOCK: tl.constexpr):
    return (x << _c32(r, BLOCK)) | (x >> _c32(32 - r, BLOCK))


@triton.jit
def _mix_k1(k1, BLOCK: tl.constexpr):
    k1 = k1 * _c32({_signed32(H.C1)}, BLOCK)
    k1 = _rotl32(k1, 15, BLOCK)
    return k1 * _c32({_signed32(H.C2)}, BLOCK)


@triton.jit
def _mix_h1(h1, k1, BLOCK: tl.constexpr):
    h1 = _rotl32(h1 ^ k1, 13, BLOCK)
    return h1 * _c32(5, BLOCK) + _c32({_signed32(H.C3)}, BLOCK)


@triton.jit
def _fmix(h1, length: tl.constexpr, BLOCK: tl.constexpr):
    h1 = h1 ^ _c32(length, BLOCK)
    h1 = h1 ^ (h1 >> _c32(16, BLOCK))
    h1 = h1 * _c32({_signed32(H.F1)}, BLOCK)
    h1 = h1 ^ (h1 >> _c32(13, BLOCK))
    h1 = h1 * _c32({_signed32(H.F2)}, BLOCK)
    return h1 ^ (h1 >> _c32(16, BLOCK))


@triton.jit
def _murmur3_int(x, seed, BLOCK: tl.constexpr):
    k1 = _mix_k1(x.to(tl.uint32, bitcast=True), BLOCK)
    return _fmix(_mix_h1(seed, k1, BLOCK), 4, BLOCK)


@triton.jit
def _murmur3_long(x, seed, BLOCK: tl.constexpr):
    low = x.to(tl.uint32)
    high = (x >> 32).to(tl.uint32)
    h1 = _mix_h1(seed, _mix_k1(low, BLOCK), BLOCK)
    h1 = _mix_h1(h1, _mix_k1(high, BLOCK), BLOCK)
    return _fmix(h1, 8, BLOCK)
'''


def _i64(c: int) -> str:
    """An int64 constant as kernel source (INT64_MIN as an expression: its
    magnitude is no int64 literal)."""
    return "(-9223372036854775807 - 1)" if c == -(1 << 63) else f"({c})"


class Sym:
    """A value of a kernel being emitted (an int64 or a mask), named in
    its source: Python's operators on it write the Triton operation and
    give the result's name (``ChainEmitter.let``), so
    ``expressions/decimal_math.py``'s algorithms emit themselves."""

    __slots__ = ("em", "name")
    __hash__ = None

    def __init__(self, em: "ChainEmitter", name: str):
        self.em = em
        self.name = name

    def __str__(self) -> str:
        return self.name

    def _op(self, op: str, other, swap: bool = False) -> "Sym":
        o = other.name if isinstance(other, Sym) else _i64(int(other))
        a, b = (o, self.name) if swap else (self.name, o)
        return Sym(self.em, self.em.let(f"{a} {op} {b}"))

    def __add__(self, o): return self._op("+", o)
    def __radd__(self, o): return self._op("+", o, True)
    def __sub__(self, o): return self._op("-", o)
    def __rsub__(self, o): return self._op("-", o, True)
    def __mul__(self, o): return self._op("*", o)
    def __rmul__(self, o): return self._op("*", o, True)
    def __floordiv__(self, o): return self._op("//", o)
    def __mod__(self, o): return self._op("%", o)
    def __and__(self, o): return self._op("&", o)
    def __rand__(self, o): return self._op("&", o, True)
    def __or__(self, o): return self._op("|", o)
    def __ror__(self, o): return self._op("|", o, True)
    def __xor__(self, o): return self._op("^", o)
    def __lshift__(self, o): return self._op("<<", o)
    def __rshift__(self, o): return self._op(">>", o)
    def __lt__(self, o): return self._op("<", o)
    def __le__(self, o): return self._op("<=", o)
    def __gt__(self, o): return self._op(">", o)
    def __ge__(self, o): return self._op(">=", o)
    def __eq__(self, o): return self._op("==", o)
    def __ne__(self, o): return self._op("!=", o)

    def __invert__(self):
        return Sym(self.em, self.em.let(f"~{self.name}"))


class KernelBackend:
    """``decimal_math``'s backend that writes a kernel (``Sym`` values)."""

    def __init__(self, em: "ChainEmitter"):
        self.em = em

    def _term(self, x) -> str:
        return x.name if isinstance(x, Sym) else _i64(int(x))

    def where(self, mask, a, b) -> Sym:
        return Sym(self.em, self.em.let(
            f"tl.where({mask}, {self._term(a)}, {self._term(b)})"))

    def i64(self, mask) -> Sym:
        return Sym(self.em, self.em.let(f"{mask}.to(tl.int64)"))


class ChainEmitter:
    """Accumulates the body of one kernel."""

    TRUE = "all_true"
    FALSE = "all_false"

    def __init__(self):
        self.prologue: List[str] = []   # before the tile loop
        self.lines: List[str] = []      # the loop body
        self._n = 0
        self._named: Dict[str, str] = {}
        self.slots: Dict[int, str] = {}
        #: a string value's name -> (chars parameter, start, length): the
        #: row's bytes are chars[start:start + length].  A column enters
        #: as (chars, offsets parameter, None); ``string_view`` loads its
        #: offsets at first use.
        self.strings: Dict[str, Tuple[str, str, object]] = {}
        #: a decimal128 value's name -> its (hi, lo) int64 names
        self.wide: Dict[str, Tuple[str, str]] = {}
        self.backend = KernelBackend(self)

    def let(self, code: str, hoist: bool = False) -> str:
        """Names the value of ``code``; the same code (every emitted
        expression is pure) gets the name it got before."""
        if code not in self._named:
            self._n += 1
            self._named[code] = f"t{self._n}"
            (self.prologue if hoist else self.lines).append(
                f"{self._named[code]} = {code}")
        return self._named[code]

    def both(self, a: str, b: str) -> str:
        """``a & b`` of two masks, with all-true operands folded away."""
        if a == self.TRUE:
            return b
        if b == self.TRUE:
            return a
        return self.let(f"{a} & {b}")

    def string_view(self, v: str, what: str) -> Tuple[str, str, str]:
        """``(chars, start, length)`` of string value ``v``; a string that
        is not a column or a view of one is refused, naming ``what``."""
        if v not in self.strings:
            raise NotImplementedError(
                f"a computed string ({what}) has no kernel form yet")
        chars, start, length = self.strings[v]
        if length is None:
            offsets = start
            start = self.let(f"tl.load({offsets} + offs, mask=inb, "
                             "other=0).to(tl.int64)")
            end = self.let(f"tl.load({offsets} + offs + 1, mask=inb, "
                           "other=0).to(tl.int64)")
            length = self.let(f"{end} - {start}")
            self.strings[v] = (chars, start, length)
        return chars, start, length

    def emit(self, e: Expression, cols: List[Value]) -> Value:
        fn = EMITTERS.get(type(e))
        if fn is None:
            raise NotImplementedError(
                f"{type(e).__name__} has no Triton emitter in "
                "kernels/fused_agg.py; it cannot run in a fused stage yet")
        return fn(self, e, cols)

    def cast(self, value: str, src: T.DataType, dst: T.DataType) -> str:
        if src == dst:
            return value
        if isinstance(src, T.DecimalType) and dst.is_floating:
            if src.is_decimal128:
                raise NotImplementedError(f"a {src} as a double has no "
                                          "kernel form (a decimal64 has)")
            scale, _ = self.constant(10.0 ** src.scale, T.DOUBLE)
            return self.let(f"{value}.to(tl.float64) / {scale}")
        if dst not in _TL:
            raise NotImplementedError(f"no kernel form for {dst}")
        return self.let(f"{value}.to({_TL[dst]})")

    def constant(self, value, dtype: T.DataType) -> Value:
        if isinstance(dtype, T.BooleanType):
            return (self.TRUE if value else self.FALSE,
                    self.FALSE if value is None else self.TRUE)
        if isinstance(dtype, T.DecimalType):
            u = 0 if value is None else unscaled_of(value, dtype.scale)
            if dtype.is_decimal128:
                hi, lo = words_of(u)
                return self.wide_value(
                    self.let(f"tl.full([BLOCK], {_i64(hi)}, tl.int64)"),
                    self.let(f"tl.full([BLOCK], {_i64(lo)}, tl.int64)")), \
                    self.FALSE if value is None else self.TRUE
            return (self.let(f"tl.full([BLOCK], {_i64(u)}, tl.int64)"),
                    self.FALSE if value is None else self.TRUE)
        if value is None:
            tl_type = _TL.get(dtype, "tl.int32")
            return self.let(f"tl.zeros([BLOCK], {tl_type})"), self.FALSE
        if dtype.is_floating:
            return (self.let(f"tl.full([BLOCK], {f64_bits(value)}, tl.int64)"
                             ".to(tl.float64, bitcast=True)"), self.TRUE)
        if dtype not in _TL:
            raise NotImplementedError(f"no kernel form for a {dtype} literal")
        return self.let(f"tl.full([BLOCK], {literal_word(value, dtype)}, "
                        f"{_TL[dtype]})"), self.TRUE

    def wide_value(self, hi: str, lo: str) -> str:
        """The name of the decimal128 value (hi, lo); a key of
        ``self.wide``, never code of the kernel."""
        name = f"wide[{hi},{lo}]"
        self.wide[name] = (hi, lo)
        return name

    def operand(self, v: str, dt: T.DataType) -> tuple:
        """A decimal, int or long value as a ``decimal_math`` operand."""
        if isinstance(dt, T.DecimalType) and dt.is_decimal128:
            hi, lo = self.wide[v]
            return ("128", Sym(self, hi), Sym(self, lo))
        return ("64", Sym(self, self.cast(v, dt, T.LONG)
                          if dt == T.INT else v))

    def decimal_result(self, value, ok, valid: str) -> Value:
        """A ``decimal_math`` result, valid where ``ok`` and ``valid``,
        0 elsewhere (as the plain version's ``result_data``)."""
        full = self.both(valid, str(ok))
        parts = [self.let(f"tl.where({full}, {x}, 0)") for x in value[1:]]
        if value[0] == "128":
            return self.wide_value(*parts), full
        return parts[0], full

    def slot(self, slot: int, dtype: T.DataType) -> str:
        """The value of promoted literal ``slot``, read from the table."""
        if slot not in self.slots:
            word = f"tl.load(lits + {slot})"
            if dtype.is_floating:
                code = f"{word}.to(tl.float64, bitcast=True)"
            elif isinstance(dtype, T.BooleanType):
                code = f"{word} != 0"
            elif dtype in _TL:
                code = f"{word}.to({_TL[dtype]})"
            else:
                raise NotImplementedError(f"no kernel form for a {dtype} "
                                          "literal")
            self.slots[slot] = self.let(code, hoist=True)
        return self.slots[slot]


@emits(BoundReference)
def _bound_reference(em, e, cols):
    return cols[e.ordinal]


@emits(DictContains)
def _dict_contains(em, e, cols):
    """A code-space conjunct: its runtime table ``tab{slot}`` (uint8: the
    null verdict, then one flag a dictionary value) at ``code + 1``, or
    at 0 for a null row; never null."""
    code, valid = em.emit(e.children[0], cols)
    idx = em.let(f"{code}.to(tl.int64) + 1") if valid == em.TRUE else \
        em.let(f"tl.where({valid}, {code}.to(tl.int64) + 1, 0)")
    return em.let(f"tl.load(tab{e.slot} + {idx}, mask=inb, other=0) != 0"), \
        em.TRUE


@emits(Alias)
def _alias(em, e, cols):
    return em.emit(e.children[0], cols)


@emits(Literal)
def _literal(em, e, cols):
    return em.constant(e.value, e.data_type)


@emits(PromotedLiteral)
def _promoted_literal(em, e, cols):
    return em.slot(e.slot, e.data_type), em.TRUE


_ARITH = {A.Add: "+", A.Subtract: "-", A.Multiply: "*"}


def _decimal_binary(em, e, cols, out: T.DecimalType) -> Value:
    """K12: a decimal ``+``, ``-``, ``*``, ``/`` or ``%``
    (``decimal_math.binary``), valid where its operands are and it does
    not overflow or divide by zero."""
    lt, rt = e.left.data_type, e.right.data_type
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    value, ok = DM.binary(e.decimal_op, em.operand(a, lt),
                          T.integral_decimal(lt), em.operand(b, rt),
                          T.integral_decimal(rt), out, em.backend)
    return em.decimal_result(value, ok, em.both(av, bv))


@emits(*_ARITH)
def _arithmetic(em, e, cols):
    out = e.decimal_type()
    if out is not None:
        return _decimal_binary(em, e, cols, out)
    rt = e.data_type
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    a = em.cast(a, e.left.data_type, rt)
    b = em.cast(b, e.right.data_type, rt)
    return em.let(f"{a} {_ARITH[type(e)]} {b}"), em.both(av, bv)


#: each order comparison: its operator, and its form for doubles, where
#: NaN is greater than every other value (x != x tests NaN)
_ORDER = {
    P.GreaterThan: (">", "({a} > {b}) | (({a} != {a}) & ({b} == {b}))"),
    P.GreaterThanOrEqual: (">=", "({a} >= {b}) | ({a} != {a})"),
    P.LessThan: ("<", "({a} < {b}) | (({b} != {b}) & ({a} == {a}))"),
    P.LessThanOrEqual: ("<=", "({a} <= {b}) | ({b} != {b})"),
}


def _decimal_compare(em, e, cols) -> Value:
    """K12: a comparison of two decimal operands across scales
    (``decimal_math.compare``)."""
    lt, rt = e.left.data_type, e.right.data_type
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    less, eq = DM.compare(em.operand(a, lt), T.integral_decimal(lt),
                          em.operand(b, rt), T.integral_decimal(rt),
                          em.backend)
    return str(e._from_order(less, eq)), em.both(av, bv)


@emits(*_ORDER)
def _order_comparison(em, e, cols):
    if e.decimal_space():
        return _decimal_compare(em, e, cols)
    ot = e.operand_type
    if ot not in _TL:
        raise NotImplementedError(
            f"{e.sql()}: {e.symbol} of {ot} has no kernel form yet")
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    a = em.cast(a, e.left.data_type, ot)
    b = em.cast(b, e.right.data_type, ot)
    op, floating = _ORDER[type(e)]
    out = floating.format(a=a, b=b) if ot.is_floating else f"{a} {op} {b}"
    return em.let(out), em.both(av, bv)


def _view_equals(em, view, raw: bytes) -> str:
    """Rows whose string view holds the bytes ``raw``: the lengths, then
    each byte against the literal's, which are constants of the kernel.
    A byte is read only where every byte before it matched."""
    chars, start, length = view
    eq = em.let(f"{length} == {len(raw)}")
    for j, byte in enumerate(raw):
        eq = em.let(f"{eq} & (tl.load({chars} + {start} + {j}, "
                    f"mask=inb & {eq}, other=0).to(tl.int32) == {byte})")
    return eq


def _views_equal(em, a, b) -> str:
    """Rows whose two string views hold the same bytes: the lengths
    first, then a byte loop bounded by the longest length of the tile
    among the rows still equal; a byte is read only where the row's
    bytes so far matched and it lies inside the view.  The two views may
    read different chars buffers."""
    (ca, sa, la), (cb, sb, lb) = a, b
    em._n += 1
    eq, top, j = f"veq{em._n}", f"vtop{em._n}", f"vj{em._n}"
    em.lines += [
        f"{eq} = ({la} == {lb}) & inb",
        f"{top} = tl.max(tl.where({eq}, {la}, 0), axis=0).to(tl.int32)",
        f"for {j} in range(0, {top}):",
        f"    {eq} = {eq} & ((tl.load({ca} + {sa} + {j}, mask={eq} & "
        f"({j} < {la}), other=0) == tl.load({cb} + {sb} + {j}, "
        f"mask={eq} & ({j} < {lb}), other=0)) | ({j} >= {la}))"]
    return eq


def _string_equality(em, e, cols) -> Value:
    """``=`` of two string operands: a literal's bytes are constants of
    the kernel; otherwise two views (columns or substrings of them) are
    compared byte by byte."""
    for column, other in ((e.left, e.right), (e.right, e.left)):
        if type(other) is Literal and other.value is not None:
            v, valid = em.emit(column, cols)
            return (_view_equals(em, em.string_view(v, column.sql()),
                                 other.value.encode("utf-8")), valid)
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    return (_views_equal(em, em.string_view(a, e.left.sql()),
                         em.string_view(b, e.right.sql())),
            em.both(av, bv))


def _equality(em, e, cols) -> Value:
    """``=`` of ``e``'s operands (NaN equals NaN)."""
    if e.decimal_space():
        lt, rt = e.left.data_type, e.right.data_type
        (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
        less, eq = DM.compare(em.operand(a, lt), T.integral_decimal(lt),
                              em.operand(b, rt), T.integral_decimal(rt),
                              em.backend)
        return str(eq), em.both(av, bv)
    ot = e.operand_type
    if isinstance(ot, T.StringType):
        return _string_equality(em, e, cols)
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    a = em.cast(a, e.left.data_type, ot)
    b = em.cast(b, e.right.data_type, ot)
    if ot.is_floating:
        out = f"({a} == {b}) | (({a} != {a}) & ({b} != {b}))"
    else:
        out = f"{a} == {b}"
    return em.let(out), em.both(av, bv)


@emits(P.EqualTo)
def _equal_to(em, e, cols):
    return _equality(em, e, cols)


@emits(P.NotEqual)
def _not_equal(em, e, cols):
    eq, valid = _equality(em, e, cols)
    return em.let(f"~{eq}"), valid


@emits(P.Not)
def _not(em, e, cols):
    v, valid = em.emit(e.children[0], cols)
    if v in (em.TRUE, em.FALSE):
        return em.FALSE if v == em.TRUE else em.TRUE, valid
    return em.let(f"~{v}"), valid


@emits(P.IsNull, P.IsNotNull)
def _is_null(em, e, cols):
    """The operand's validity (its negation for IS NULL); never null."""
    _v, valid = em.emit(e.children[0], cols)
    if isinstance(e, P.IsNotNull):
        return valid, em.TRUE
    if valid in (em.TRUE, em.FALSE):
        return em.FALSE if valid == em.TRUE else em.TRUE, em.TRUE
    return em.let(f"~{valid}"), em.TRUE


#: string IN lists longer than this, of literals of at most 8 bytes, are
#: compared as one packed word per row (``_view_in_words``)
LONG_IN = 16


def _view_in_words(em, view, raws) -> str:
    """Rows whose string view holds one of the byte strings ``raws`` (each
    at most 8 bytes): the row's first bytes are loaded once and packed
    big-endian into an int64 word, zeros past its length, and each
    literal costs one word compare beside a length compare per distinct
    length (q8's 128 zips: 5 loads and 129 compares a row, where the
    byte-by-byte form emits 640 masked loads)."""
    chars, start, length = view
    word = None
    for j in range(max(len(r) for r in raws)):
        b = em.let(f"tl.load({chars} + {start} + {j}, mask=inb & "
                   f"({j} < {length}), other=0).to(tl.int64)")
        term = b if j == 7 else em.let(f"{b} << {8 * (7 - j)}")
        word = term if word is None else em.let(f"{word} | {term}")
    by_len = {}
    for r in sorted(set(raws)):
        x = int.from_bytes(r.ljust(8, b"\0"), "big")
        by_len.setdefault(len(r), []).append(x - (1 << 64)
                                              if x >= 1 << 63 else x)
    found = em.FALSE
    for n, words in sorted(by_len.items()):
        hit = " | ".join(f"({word} == {x})" for x in words)
        eq = em.let(f"({length} == {n}) & ({hit})")
        found = eq if found == em.FALSE else em.let(f"{found} | {eq}")
    return found


@emits(P.In)
def _in(em, e, cols):
    """The OR of ``value = option`` over the non-null options; a null
    option makes a miss null, as the JAX package's OR chain does.  A long
    list of short string literals is one packed word compare each
    (``_view_in_words``)."""
    value = e.children[0]
    vt = value.data_type
    v, valid = em.emit(value, cols)
    view = em.string_view(v, value.sql()) \
        if isinstance(vt, T.StringType) else None
    raws = [o.value.encode("utf-8") for o in e.options
            if o.value is not None] if view is not None else []
    words = len(raws) > LONG_IN and 1 <= max(map(len, raws)) <= 8
    found = _view_in_words(em, view, raws) if words else em.FALSE
    for o in e.options:
        if o.value is None or words:
            continue
        ot = T.common_type(vt, o.data_type)
        if view is not None:
            eq = _view_equals(em, view, o.value.encode("utf-8"))
        else:
            if ot not in _TL:
                raise NotImplementedError(
                    f"{e.sql()}: IN over {ot} has no kernel form yet")
            a = em.cast(v, vt, ot)
            b = em.cast(em.constant(o.value, o.data_type)[0], o.data_type,
                        ot)
            eq = em.let(f"({a} == {b}) | (({a} != {a}) & ({b} != {b}))"
                        if ot.is_floating else f"{a} == {b}")
        found = eq if found == em.FALSE else em.let(f"{found} | {eq}")
    if not e.options:
        return found, em.TRUE
    if any(o.value is None for o in e.options):
        return found, em.both(valid, found)
    return found, valid


@emits(ST.Substring)
def _substring(em, e, cols):
    """A byte view into the value's chars (``Substring.bounds``, with the
    literal ``pos`` and ``len`` folded into the source)."""
    v, valid = em.emit(e.children[0], cols)
    chars, start, length = em.string_view(v, e.children[0].sql())
    pos = e.pos
    if pos > 0:
        skip = em.let(f"tl.where({length} < {pos - 1}, {length}, "
                      f"{pos - 1})")
    elif pos < 0:
        skip = em.let(f"tl.where({length} + {pos} > 0, {length} + {pos}, "
                      "0)")
    else:
        skip = None
    rest = length if skip is None else em.let(f"{length} - {skip}")
    slen = ST.NO_LENGTH if e.length is None else e.length
    if slen <= 0:
        out_len = em.let(f"{length} * 0")
    elif e.length is None:
        out_len = rest
    else:
        out_len = em.let(f"tl.where({rest} < {slen}, {rest}, {slen})")
    begin = start if skip is None else em.let(f"{start} + {skip}")
    # the view's name is a key of em.strings, never code of the kernel
    name = f"view[{begin},{out_len}]"
    em.strings[name] = (chars, begin, out_len)
    return name, valid


@emits(P.And)
def _and(em, e, cols):
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    at, bt = em.both(a, av), em.both(b, bv)
    af = em.let(f"(~{a}) & {av}")
    bf = em.let(f"(~{b}) & {bv}")
    out = em.both(at, bt)
    return out, em.let(f"{out} | {af} | {bf}")


@emits(P.Or)
def _or(em, e, cols):
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    at, bt = em.both(a, av), em.both(b, bv)
    out = em.let(f"{at} | {bt}")
    return out, em.let(f"{out} | {em.both(av, bv)}")


@emits(A.Divide)
def _divide(em, e, cols):
    out = e.decimal_type()
    if out is not None:
        return _decimal_binary(em, e, cols, out)
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    a = em.cast(a, e.left.data_type, T.DOUBLE)
    b = em.cast(b, e.right.data_type, T.DOUBLE)
    zero = em.let(f"{b} == 0.0")   # -0.0 too
    out = em.let(f"{a} / tl.where({zero}, 1.0, {b})")
    return out, em.let(f"{em.both(av, bv)} & (~{zero})")


@emits(M.Sqrt)
def _sqrt(em, e, cols):
    """IEEE square root of the operand as a double (``tl.sqrt`` of an
    f64 is ``sqrt.rn``); one quiet NaN below 0 and for a NaN, as
    ``Sqrt.eval`` gives it."""
    v, valid = em.emit(e.children[0], cols)
    x = em.cast(v, e.children[0].data_type, T.DOUBLE)
    nan, _ = em.constant(float("nan"), T.DOUBLE)
    return (em.let(f"tl.where(({x} < 0.0) | ({x} != {x}), {nan}, "
                   f"tl.sqrt({x}))"), valid)


def _decimal_branch(em, c, v: str, valid: str, rt: T.DecimalType):
    """An ``If`` branch as a ``decimal_math`` operand of the result type
    (rescaled where its type differs; a NULL literal a null zero) and its
    validity."""
    dt = c.data_type
    if dt == rt:
        return em.operand(v, rt), valid
    if isinstance(dt, T.NullType):
        z, _ = em.constant(None, rt)
        return em.operand(z, rt), em.FALSE
    value, ok = DM.rescale(em.operand(v, dt), T.integral_decimal(dt), rt,
                           em.backend)
    return value, em.both(valid, str(ok))


@emits(CO.If)
def _if(em, e, cols):
    rt = e.data_type
    (p, pv), (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    if isinstance(rt, T.DecimalType):
        cond = em.both(pv, p)
        (x, xv), (y, yv) = (_decimal_branch(em, c, v, valid, rt)
                            for c, v, valid in ((e.children[1], a, av),
                                                (e.children[2], b, bv)))
        parts = [em.let(f"tl.where({cond}, {xa}, {ya})")
                 for xa, ya in zip(x[1:], y[1:])]
        data = em.wide_value(*parts) if rt.is_decimal128 else parts[0]
        return data, em.let(f"({cond} & {xv}) | ((~{cond}) & {yv})")
    a = em.cast(a, e.children[1].data_type, rt)
    b = em.cast(b, e.children[2].data_type, rt)
    cond = em.both(pv, p)   # a null predicate takes the else branch
    return (em.let(f"tl.where({cond}, {a}, {b})"),
            em.let(f"({cond} & {av}) | ((~{cond}) & {bv})"))


@emits(A.IntegralDivide, A.Remainder)
def _integral_division(em, e, cols):
    """``div`` (a long) and ``%`` (the operands' type).  Triton's ``//``
    and ``%`` on signed integers truncate as C does (``sdiv``, ``srem``);
    a zero divisor gives null, and a divisor of -1 is taken apart
    (``0 - a`` wraps for INT64_MIN; ``% -1`` is 0), where C is
    undefined."""
    e.check_operands()
    out = e.decimal_type()
    if out is not None:
        return _decimal_binary(em, e, cols, out)
    rt = e.data_type if isinstance(e, A.Remainder) else T.LONG
    (a, av), (b, bv) = (em.emit(c, cols) for c in e.children)
    a = em.cast(a, e.left.data_type, rt)
    b = em.cast(b, e.right.data_type, rt)
    zero = em.let(f"{b} == 0")
    minus_one = em.let(f"{b} == -1")
    safe = em.let(f"tl.where({zero} | {minus_one}, 1, {b})")
    out = f"tl.where({minus_one}, 0 - {a}, {a} // {safe})" \
        if isinstance(e, A.IntegralDivide) else \
        f"tl.where({minus_one}, 0, {a} % {safe})"
    return em.let(out), em.let(f"{em.both(av, bv)} & (~{zero})")


@emits(CO.CaseWhen)
def _case_when(em, e, cols):
    """A numeric CASE is its fold of ``If``.  A string CASE is a view of
    its one column (``CaseWhen.view_column``): the column's value, valid
    where a branch holding the column is taken and the row is valid."""
    if not isinstance(e.data_type, T.StringType):
        return em.emit(e.folded(), cols)
    v, valid = em.emit(e.view_column(), cols)
    rest, taken = em.TRUE, em.FALSE
    for p, value in e.branches:
        pv, pvalid = em.emit(p, cols)
        hit = em.both(rest, em.both(pvalid, pv))
        if e.holds_column(value):
            taken = hit if taken == em.FALSE else em.let(f"{taken} | {hit}")
        rest = em.both(rest, em.let(f"~{hit}"))
    if e.holds_column(e.else_value):
        taken = rest if taken == em.FALSE else em.let(f"{taken} | {rest}")
    return v, em.both(taken, valid)


@emits(CA.Cast)
def _cast(em, e, cols):
    v, valid = em.emit(e.children[0], cols)
    src, dst = e.children[0].data_type, e.data_type
    if src != dst and CA.decimal_cast(src, dst):
        value, ok = DM.rescale(em.operand(v, src), T.integral_decimal(src),
                               dst, em.backend)
        return em.decimal_result(value, ok, valid)
    return em.cast(v, src, dst), valid


@emits(H.Murmur3Hash)
def _murmur3(em, e, cols):
    h = em.let(f"_c32({_signed32(e.seed & H.MASK32)}, BLOCK)")
    for child in e.children:
        v, valid = em.emit(child, cols)
        if isinstance(child.data_type, T.LongType):
            hashed = em.let(f"_murmur3_long({v}, {h}, BLOCK)")
        elif isinstance(child.data_type, T.IntegerType):
            hashed = em.let(f"_murmur3_int({v}, {h}, BLOCK)")
        else:
            raise NotImplementedError(
                f"murmur3 of {child.data_type} has no kernel form yet")
        # nulls pass h on
        h = hashed if valid == em.TRUE else \
            em.let(f"tl.where({valid}, {hashed}, {h})")
    return em.let(f"{h}.to(tl.int32, bitcast=True)"), em.TRUE


def runs_k12(exprs: Sequence[Expression]) -> bool:
    """Whether a chain's expressions run K12: an operation, comparison,
    cast or selection over a decimal value (a decimal column read as it
    is does not)."""
    def visit(e) -> bool:
        if not isinstance(e, (BoundReference, Alias, Literal)) and (
                isinstance(e.data_type, T.DecimalType) or
                any(isinstance(c.data_type, T.DecimalType)
                    for c in e.children)):
            return True
        return any(visit(c) for c in e.children)
    return any(visit(e) for e in exprs)


def referenced_columns(exprs: Sequence[Expression]) -> List[int]:
    """The input ordinals ``exprs`` read, in order."""
    found = set()

    def visit(e):
        if isinstance(e, BoundReference):
            found.add(e.ordinal)
        for c in e.children:
            visit(c)
    for e in exprs:
        visit(e)
    return sorted(found)


def load_columns(input_types, nullable, used, conditions, em: ChainEmitter
                 ) -> tuple:
    """Emits the loads of the ``used`` columns and the predicates:
    ``(parameter names, the columns as values, the selection mask)``.  A
    fixed-width column is one plane (``in{i}``); a string column is its
    chars and offsets (``in{i}``, ``in{i}_off``), and the emitters that
    read it load what they need (``em.strings``); a column marked in
    ``nullable`` adds its validity plane (``in{i}_valid``)."""
    params = []
    cols: List[Value] = [None] * len(input_types)
    for i in used:
        dt = input_types[i]
        params.append(f"in{i}")
        if isinstance(dt, T.StringType):
            params.append(f"in{i}_off")
            em.strings[f"x{i}"] = (f"in{i}", f"in{i}_off", None)
        elif isinstance(dt, T.DecimalType) and dt.is_decimal128:
            # the [rows, 2] plane's hi and lo words
            em.lines += [f"x{i}h = tl.load(in{i} + 2 * offs, mask=inb, "
                         "other=0)",
                         f"x{i}l = tl.load(in{i} + 2 * offs + 1, mask=inb, "
                         "other=0)"]
            em.wide[f"x{i}"] = (f"x{i}h", f"x{i}l")
        else:
            load = f"tl.load(in{i} + offs, mask=inb, other=0)"
            if isinstance(dt, T.BooleanType):
                load += " != 0"
            elif dt not in _TL and not isinstance(dt, T.DecimalType):
                raise NotImplementedError(
                    f"a {dt} column cannot be read inside a fused kernel "
                    "yet")
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


def table_params(n_tables: int) -> List[str]:
    """The parameters of a chain's code-space tables, after its literal
    table (``DictContains``)."""
    return [f"tab{s}" for s in range(n_tables)]


_INT64_MAX = 2 ** 63 - 1
_INT64_MIN = -(2 ** 63)


def _min_max(em: ChainEmitter, j: int, kind: str, v: str,
             vtype: T.DataType, present: str, inits: List[str]) -> str:
    """A min or max buffer's lane accumulator and the program's word: an
    int64 a lane (an int or date widened; a double's bits in an order
    that puts -0.0 below 0.0, its NaN flagged apart) and the program's
    reduction of it, a double's NaN where Spark's rule gives one."""
    ident = _INT64_MAX if kind == "min" else _INT64_MIN
    pick = "tl.minimum" if kind == "min" else "tl.maximum"
    fold = "tl.min" if kind == "min" else "tl.max"
    inits.append(f"acc{j} = tl.full([BLOCK], {ident}, tl.int64)")
    if not vtype.is_floating:
        w = em.cast(v, vtype, T.LONG)
        em.lines.append(f"acc{j} = {pick}(acc{j}, tl.where({present}, {w}, "
                        f"{ident}))")
        return f"{fold}(acc{j}, axis=0)"
    bits = em.let(f"{v}.to(tl.int64, bitcast=True)")
    order = em.let(f"{bits} ^ (({bits} >> 63) & {_INT64_MAX})")
    num = em.both(present, em.let(f"{v} == {v}"))
    nan = em.both(present, em.let(f"{v} != {v}"))
    inits.append(f"nan{j} = tl.zeros([BLOCK], tl.int32)")
    em.lines.append(f"acc{j} = {pick}(acc{j}, tl.where({num}, {order}, "
                    f"{ident}))")
    em.lines.append(f"nan{j} = nan{j} | {nan}.to(tl.int32)")
    # the fold of the lanes, back to bits; a NaN where the rule says
    best = f"{fold}(acc{j}, axis=0)"
    back = f"({best} ^ (({best} >> 63) & {_INT64_MAX}))"
    has_nan = f"(tl.max(nan{j}, axis=0) > 0)"
    nan_word = 0x7ff8000000000000
    if kind == "max":
        return f"tl.where({has_nan}, {nan_word}, {back})"
    # min: NaN only where no number was present (the fold kept the
    # identity)
    return f"tl.where({has_nan} & ({best} == {ident}), {nan_word}, {back})"


def _row_pick(em: ChainEmitter, j: int, kind: str, sel: str, present: str,
              inits: List[str]) -> Tuple[str, str]:
    """A row-order buffer's lane accumulator: the lowest (first) or
    highest (last) row the chain selected, of the present rows for the
    ``_valid`` kinds; the program's word is its row, not valid where it
    has none."""
    cond = present if kind.endswith("_valid") else sel
    if kind.startswith("first"):
        inits.append(f"acc{j} = tl.full([BLOCK], {_INT64_MAX}, tl.int64)")
        em.lines.append(f"acc{j} = tl.minimum(acc{j}, tl.where({cond}, offs, "
                        f"{_INT64_MAX}))")
        word = f"tl.min(acc{j}, axis=0)"
        return word, f"({word} != {_INT64_MAX}).to(tl.uint8)"
    inits.append(f"acc{j} = tl.full([BLOCK], -1, tl.int64)")
    em.lines.append(f"acc{j} = tl.maximum(acc{j}, tl.where({cond}, offs, -1))")
    word = f"tl.max(acc{j}, axis=0)"
    return word, f"({word} >= 0).to(tl.uint8)"


def buffer_words(dtype: T.DataType) -> int:
    """Words a buffer takes in a partial row: two for a decimal128 (its
    hi and lo words), else one."""
    return 2 if isinstance(dtype, T.DecimalType) and dtype.is_decimal128 \
        else 1


def _wide_sum(em: ChainEmitter, j: int, value, present: str,
              inits: List[str], stores: List[str], col: int) -> str:
    """A decimal128 sum buffer (``_segment_reduce``'s four limbs): each
    lane adds the 32-bit limbs of its present values into four int64
    sums (a limb is below 2^32 and a lane's rows below 2^31: no sum
    wraps); the program sums the lanes, carries once (scalars, after the
    tile loop) and stores the lo word at ``col + 1``; its hi word is the
    returned word.  The sum wraps mod 2^128, as the JAX kernel's does."""
    hi, lo = value[1], value[2]
    limbs = DM.split(hi, lo)
    post = []
    for k, limb in enumerate(limbs):
        inits.append(f"acc{j}_{k} = tl.zeros([BLOCK], tl.int64)")
        em.lines.append(f"acc{j}_{k} += tl.where({present}, {limb}, 0)")
        post.append(f"s{j}_{k} = tl.sum(acc{j}_{k}, axis=0)")
    for k in range(4):
        carry = "" if k == 0 else f" + (s{j}_{k - 1} >> 32)"
        post.append(f"s{j}_{k} = s{j}_{k}{carry}")
    for k in range(4):
        post.append(f"n{j}_{k} = s{j}_{k} & {DM.M32}")
    post.append(f"lo{j} = n{j}_0 | (n{j}_1 << 32)")
    post.append(f"hi{j} = n{j}_2 | (n{j}_3 << 32)")
    stores += post
    stores.append(f"tl.store(out + row + {col + 1}, lo{j})")
    return f"hi{j}"


def kernel_source(input_types: Sequence[T.DataType], nullable: Sequence[bool],
                  conditions: Sequence[Expression],
                  update_exprs: Sequence[Expression], update_specs,
                  n_literals: int, n_tables: int = 0) -> str:
    """Source of a module whose ``fused_agg_update`` kernel evaluates the
    chain's ``conditions`` and ``update_exprs`` (both over the input
    columns: the chain flattened, ``exec/fused.py flatten_chain``) and
    writes one partial row per program.

    The kernel takes the columns the expressions read (``load_columns``),
    then the literal table, then the tables of its code-space conjuncts
    (``n_tables``; a dictionary column's codes are read as an INT
    column).  ``update_specs`` are ``(ordinal, kind,
    count_valid_only, dtype)`` over ``update_exprs``; kinds ``sum``,
    ``count``, ``min``, ``max`` and the row-order kinds (``first``,
    ``last``, ``first_valid``, ``last_valid``: a row number) have kernel
    forms."""
    em = ChainEmitter()
    used = referenced_columns(list(conditions) + list(update_exprs))
    params, cols, sel = load_columns(input_types, nullable, used,
                                     conditions, em)
    if n_literals:
        params.append("lits")
    params += table_params(n_tables)
    n_words = sum(buffer_words(dt) for _o, _k, _c, dt in update_specs)
    inits, stores = [], []
    counts: Dict[str, str] = {}   # presence mask -> its count accumulator
    col = 0   # the buffer's first word in the partial row
    for j, (ordinal, kind, count_valid_only, dtype) in \
            enumerate(update_specs):
        e = update_exprs[ordinal]
        v, valid = em.emit(e, cols)
        present = sel if kind == "count" and not count_valid_only \
            else em.both(sel, valid)
        if present not in counts:
            counts[present] = f"cnt_{present}"
            inits.append(f"{counts[present]} = tl.zeros([BLOCK], tl.int64)")
            em.lines.append(f"{counts[present]} += {present}.to(tl.int64)")
        count = f"tl.sum({counts[present]}, axis=0)"
        if kind == "count":
            word, ok = count, "1"
        elif kind == "sum" and isinstance(dtype, T.DecimalType) and \
                dtype.is_decimal128:
            word = _wide_sum(em, j, em.operand(v, dtype), present, inits,
                             stores, col)
            ok = f"({count} > 0).to(tl.uint8)"
            stores.append(f"tl.store(out_valid + row + {col + 1}, {ok})")
        elif kind == "sum" and (dtype in (T.LONG, T.DOUBLE) or
                                isinstance(dtype, T.DecimalType)):
            v = em.cast(v, e.data_type, dtype)
            zero = "0.0" if dtype.is_floating else "0"
            tl_type = "tl.int64" if isinstance(dtype, T.DecimalType) \
                else _TL[dtype]
            inits.append(f"acc{j} = tl.zeros([BLOCK], {tl_type})")
            em.lines.append(f"acc{j} += tl.where({present}, {v}, {zero})")
            word = f"tl.sum(acc{j}, axis=0)"
            if dtype.is_floating:
                word = f"{word}.to(tl.int64, bitcast=True)"
            ok = f"({count} > 0).to(tl.uint8)"
        elif kind in ("min", "max") and dtype in _TL:
            word = _min_max(em, j, kind, v, e.data_type, present, inits)
            ok = f"({count} > 0).to(tl.uint8)"
        elif kind in ROW_KINDS:
            word, ok = _row_pick(em, j, kind, sel, present, inits)
        else:
            raise NotImplementedError(
                f"update kind {kind!r} over {dtype} has no kernel form yet")
        stores.append(f"tl.store(out + row + {col}, {word})")
        stores.append(f"tl.store(out_valid + row + {col}, {ok})")
        col += buffer_words(dtype)
    params += ["out", "out_valid", "n_rows"]
    loop = ["offs = tile.to(tl.int64) * BLOCK + lane",
            "inb = offs < n_rows",
            "all_true = offs >= 0",
            "all_false = offs < 0",
            *em.lines]
    body = ["pid = tl.program_id(0)",
            "lane = tl.arange(0, BLOCK)",
            "n_tiles = tl.cdiv(n_rows, BLOCK)",
            *em.prologue,
            *inits,
            "for tile in range(pid, n_tiles, tl.num_programs(0)):",
            *(f"    {line}" for line in loop),
            f"row = pid.to(tl.int64) * {n_words}",
            *stores]
    header = (f"\n\n@triton.jit(do_not_specialize=[\"n_rows\"])\n"
              f"def {KERNEL_NAME}({', '.join(params)}, "
              f"BLOCK: tl.constexpr):\n")
    return _PREAMBLE + header + "".join(f"    {line}\n" for line in body)
