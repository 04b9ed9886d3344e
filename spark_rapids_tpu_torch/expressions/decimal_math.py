"""Decimal arithmetic, K12 (the analog of ``spark_rapids_tpu/expressions/
decimal_math.py``): Spark's result types, the gate of what runs on the
card, and the exact integer algorithms that both the plain PyTorch version
and the Triton kernels run.

Spark non-ANSI semantics: HALF_UP rounding (away from zero on a tie),
overflow past the result's precision gives NULL, and so does a division
or remainder by zero.  A decimal64 (precision up to 18) is its unscaled
int64; a decimal128 its (hi, lo) int64 pair, two's complement over 128
bits.  The JAX package splits each 128-bit value into four 32-bit limbs
held in int64 lanes (``split128`` ``:104``), adds and multiplies limb by
limb and propagates carries once (``_normalize`` ``:128``); so does this
module.  A 32-bit limb times a 32-bit limb is formed as an int64 product:
it wraps, but its 64 bits are those of the exact unsigned product, so its
low and high halves are exact (the JAX package splits each limb into
16-bit halves instead, ``:206``).

Every algorithm here is written once over values that support Python's
integer operators: torch int64 tensors (the plain version, ``TORCH``) or
the symbolic values of the Triton emitter (``kernels/fused_agg.py``,
which writes the same operations into a kernel's source).  So the kernel
and its plain version do the same integer operations, in the same order.
A backend gives ``where(mask, a, b)`` and ``i64(mask)``.

``device_supported`` is the JAX package's gate (``:419``), copied: an
operation it refuses goes to the JAX package's host tier, and the port,
which has no host tier, refuses it by name.  The port adds two limits
of its own, refused by name too: a cast that drops more than 18 digits
of scale (no ``device_supported`` operation divides by more than
10^18), and a decimal128 as a double."""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from spark_rapids_tpu_torch import types as T

D = T.DecimalType
MAX_P = D.MAX_PRECISION          # 38
MAX_LONG = D.MAX_LONG_DIGITS     # 18
M32 = 0xFFFFFFFF
M64 = (1 << 64) - 1

#: the binary operations of each arithmetic class, by its op name
OPS = ("add", "sub", "mul", "div", "rem")


# -- Spark's result types (DecimalPrecision, allowPrecisionLoss=true) -------

def bounded(precision: int, scale: int) -> D:
    """Spark's ``DecimalType.adjustPrecisionScale``."""
    if precision <= MAX_P:
        return D(precision, scale)
    digits = precision - scale
    min_scale = min(scale, 6)
    return D(MAX_P, max(MAX_P - digits, min_scale))


def binary_result_type(op: str, lt: T.DataType, rt: T.DataType) -> D:
    a, b = T.integral_decimal(lt), T.integral_decimal(rt)
    if a is None or b is None:
        raise TypeError(f"decimal {op} of {lt} and {rt}")
    if op in ("add", "sub"):
        scale = max(a.scale, b.scale)
        digits = max(a.precision - a.scale, b.precision - b.scale)
        return bounded(digits + scale + 1, scale)
    if op == "mul":
        return bounded(a.precision + b.precision + 1, a.scale + b.scale)
    if op == "div":
        scale = max(6, a.scale + b.precision + 1)
        digits = a.precision - a.scale + b.scale
        return bounded(digits + scale, scale)
    if op == "rem":
        scale = max(a.scale, b.scale)
        digits = min(a.precision - a.scale, b.precision - b.scale)
        return bounded(digits + scale, scale)
    raise ValueError(op)


def device_supported(op: str, lt: T.DataType, rt: T.DataType
                     ) -> Optional[str]:
    """None where the JAX device kernels compute ``op`` exactly, else the
    JAX package's reason (``decimal_math.py:419``)."""
    a, b = T.integral_decimal(lt), T.integral_decimal(rt)
    out = binary_result_type(op, lt, rt)
    if op in ("add", "sub"):
        if max(a.scale, b.scale) - out.scale > 18:
            return "decimal add/sub scale reduction beyond 18 is host tier"
        return None
    if op == "mul":
        raw = a.scale + b.scale
        if a.precision <= MAX_LONG and b.precision <= MAX_LONG and \
                raw - out.scale <= 18:
            return None
        return (f"decimal multiply {a.simple_name} x {b.simple_name} "
                "needs >128-bit intermediates (host tier)")
    if op == "div":
        d = out.scale + b.scale - a.scale
        if a.precision + d <= MAX_LONG and b.precision <= MAX_LONG:
            return None
        return (f"decimal divide {a.simple_name} / {b.simple_name} "
                "needs 128-bit division (host tier)")
    s = max(a.scale, b.scale)
    if a.precision + (s - a.scale) <= MAX_LONG and \
            b.precision + (s - b.scale) <= MAX_LONG:
        return None
    return f"decimal {op} at this precision is host tier"


def check_binary(op: str, lt: T.DataType, rt: T.DataType, what: str) -> D:
    """The result type of a decimal ``op``; raises NotImplementedError,
    naming ``what``, where the JAX package's gate sends it to the host."""
    reason = device_supported(op, lt, rt)
    if reason is not None:
        raise NotImplementedError(f"{what}: {reason}, which the port does "
                                  "not have")
    return binary_result_type(op, lt, rt)


def compare_supported(lt: T.DataType, rt: T.DataType) -> Optional[str]:
    """The JAX gate of a comparison in decimal space (``:653``)."""
    a, b = T.integral_decimal(lt), T.integral_decimal(rt)
    s = max(a.scale, b.scale)
    if max(a.precision + (s - a.scale), b.precision + (s - b.scale)) <= MAX_P:
        return None
    return "decimal comparison at this scale mix is host tier"


def involves_decimal(lt: T.DataType, rt: T.DataType) -> bool:
    return isinstance(lt, D) or isinstance(rt, D)


def decimal_operands(lt: T.DataType, rt: T.DataType) -> bool:
    """Both operands are decimal, int or long, one of them decimal: the
    operation runs in decimal space (a double partner promotes to
    double instead)."""
    return involves_decimal(lt, rt) and T.integral_decimal(lt) is not None \
        and T.integral_decimal(rt) is not None


# -- backends ---------------------------------------------------------------

class TorchBackend:
    """The plain version's operations on int64 tensors."""

    @staticmethod
    def where(mask, a, b):
        return torch.where(mask, a, b)

    @staticmethod
    def i64(mask):
        return mask.to(torch.int64)


TORCH = TorchBackend()


# -- 128-bit helpers over (hi, lo) int64 pairs ------------------------------

def split(hi, lo) -> list:
    """Four 32-bit limbs, little-endian, in int64 lanes."""
    return [lo & M32, (lo >> 32) & M32, hi & M32, (hi >> 32) & M32]


def join(limbs) -> Tuple:
    """Four limbs below 2^32 as (hi, lo)."""
    return limbs[2] | (limbs[3] << 32), limbs[0] | (limbs[1] << 32)


def normalize(limbs) -> Tuple[list, object]:
    """Carries propagated so every limb is below 2^32; the carry out."""
    out, carry = [], None
    for limb in limbs:
        s = limb if carry is None else limb + carry
        out.append(s & M32)
        carry = s >> 32
    return out, carry


def ult(a, b):
    """``a < b`` of int64 words read as unsigned."""
    return (a < b) != ((a < 0) != (b < 0))


def ugt_const(a, c: int):
    """``a > c`` of an int64 word and a constant's word, unsigned."""
    return (a < 0) | (a > c) if c >= 0 else (a < 0) & (a > c)


def neg(hi, lo, B):
    """Two's-complement negation."""
    return ~hi + B.i64(lo == 0), 0 - lo


def signed(n, hi, lo, B):
    """(hi, lo), negated where ``n``."""
    nh, nl = neg(hi, lo, B)
    return B.where(n, nh, hi), B.where(n, nl, lo)


def absolute(hi, lo, B):
    return signed(hi < 0, hi, lo, B)


def add(ah, al, bh, bl, B):
    """Signed 128-bit sum: (hi, lo, overflow)."""
    lo = al + bl
    hi = ah + bh + B.i64(ult(lo, al))
    ovf = ((ah < 0) == (bh < 0)) & ((hi < 0) != (ah < 0))
    return hi, lo, ovf


def _or(a, b):
    return b if a is None else a | b


def _plus(a, b):
    return b if a is None else a + b


def mul_const(hi, lo, c: int, B):
    """A non-negative 128-bit magnitude times the constant ``c`` (0 < c <
    2^128): (hi, lo, overflow past 2^127 - 1)."""
    a = split(hi, lo)
    acc: List = [None] * 4
    ovf = None
    for j in range(4):
        m = (c >> (32 * j)) & M32
        if m == 0:
            continue
        for i in range(4):
            k = i + j
            if k >= 4:
                ovf = _or(ovf, a[i] != 0)
                continue
            p = a[i] * m                  # wraps; its bits are exact
            acc[k] = _plus(acc[k], p & M32)
            if k + 1 < 4:
                acc[k + 1] = _plus(acc[k + 1], (p >> 32) & M32)
            else:
                ovf = _or(ovf, ((p >> 32) & M32) != 0)
    acc = [x if x is not None else lo * 0 for x in acc]
    norm, carry = normalize(acc)
    rh, rl = join(norm)
    ovf = _or(ovf, carry != 0)
    return rh, rl, ovf | (rh < 0)


def rescale_up(hi, lo, d: int, B):
    """``x * 10^d`` (signed): (hi, lo, overflow)."""
    if d == 0:
        return hi, lo, hi != hi
    ah, al = absolute(hi, lo, B)
    mh, ml, ovf = mul_const(ah, al, 10 ** d, B)
    rh, rl = signed(hi < 0, mh, ml, B)
    return rh, rl, ovf


def div_pow10_half_up(hi, lo, d: int, B):
    """``round_half_up(x / 10^d)`` (signed), 0 < d <= 18: long division of
    the magnitude's limbs by at most 9 digits at a time, the remainders
    gathered, then a tie or more rounds away from zero."""
    if not 0 < d <= MAX_LONG:
        raise NotImplementedError(f"a rounding division by 10^{d} is not "
                                  "in the port (at most 10^18 is)")
    ah, al = absolute(hi, lo, B)
    q = split(ah, al)
    rem, scale, left = None, 1, d
    while left:
        step = min(left, 9)
        dv = 10 ** step
        r = None
        out: List = [None] * 4
        for i in (3, 2, 1, 0):
            cur = q[i] if r is None else (r << 32) | q[i]
            out[i] = cur // dv
            r = cur % dv
        q = out
        rem = _plus(rem, r if scale == 1 else r * scale)
        scale *= dv
        left -= step
    q[0] = q[0] + B.i64(rem * 2 >= 10 ** d)
    norm, _carry = normalize(q)
    qh, ql = join(norm)
    return signed(hi < 0, qh, ql, B)


def over_bound(hi, lo, precision: int, B):
    """``|x| > 10^precision - 1``."""
    bound = 10 ** precision - 1
    ah, al = absolute(hi, lo, B)
    bh = bound >> 64
    bl = bound & M64
    bl = bl - (1 << 64) if bl >= 1 << 63 else bl
    return (ah > bh) | ((ah == bh) & ugt_const(al, bl))


def mul64(x, y, B):
    """The signed 128-bit product of two int64 values below 2^63 in
    magnitude: four 32-bit limb products, one carry pass."""
    n = (x < 0) != (y < 0)
    ax = B.where(x < 0, 0 - x, x)
    ay = B.where(y < 0, 0 - y, y)
    xl, xh = ax & M32, (ax >> 32) & M32
    yl, yh = ay & M32, (ay >> 32) & M32
    ll, lh, hl, hh = xl * yl, xl * yh, xh * yl, xh * yh   # wrap; exact bits
    acc0 = ll & M32
    acc1 = ((ll >> 32) & M32) + (lh & M32) + (hl & M32)
    acc2 = ((lh >> 32) & M32) + ((hl >> 32) & M32) + (hh & M32)
    acc3 = (hh >> 32) & M32
    norm, _carry = normalize([acc0, acc1, acc2, acc3])
    rh, rl = join(norm)
    return rh, rl, n


def widen(v):
    """A decimal64 (int64) value as (hi, lo)."""
    return v >> 63, v


# -- the operations ---------------------------------------------------------
#
# Each takes operands as ("64", v) or ("128", hi, lo) with their decimal
# types and gives (value, ok): value ("64", v) or ("128", hi, lo) of the
# result type, ok the rows that neither overflow nor divide by zero.  The
# caller ANDs in the operands' validity.

def _wide(x):
    return (x[1], x[2]) if x[0] == "128" else widen(x[1])


def _pack(hi, lo, ok, out: D, B):
    """A (hi, lo) result of type ``out``: its bound checked."""
    ok = ok & ~over_bound(hi, lo, out.precision, B)
    if out.is_decimal128:
        return ("128", hi, lo), ok
    return ("64", lo), ok


def _fits64(dt: D, up: int) -> bool:
    return dt.precision + up <= MAX_LONG


def binary(op: str, x, a: D, y, b: D, out: D, B):
    """``x op y`` of decimals ``a`` and ``b`` (an int or long operand as
    its decimal view) as ``out``, exactly, as the JAX package's
    ``tpu_binary_eval`` (``:530``) computes it."""
    if op in ("add", "sub"):
        s = max(a.scale, b.scale)
        da, db = s - a.scale, s - b.scale
        if x[0] == "64" and y[0] == "64" and _fits64(a, da) and \
                _fits64(b, db) and out.scale == s and \
                not out.is_decimal128:
            # both aligned operands fit int64, and so does their sum
            xs = x[1] * 10 ** da if da else x[1]
            ys = y[1] * 10 ** db if db else y[1]
            r = xs + ys if op == "add" else xs - ys
            return _pack(r >> 63, r, r == r, out, B)
        ah, al = _wide(x)
        bh, bl = _wide(y)
        ah, al, o1 = rescale_up(ah, al, da, B)
        bh, bl, o2 = rescale_up(bh, bl, db, B)
        if op == "sub":
            bh, bl = neg(bh, bl, B)
        rh, rl, o3 = add(ah, al, bh, bl, B)
        if out.scale < s:
            rh, rl = div_pow10_half_up(rh, rl, s - out.scale, B)
        return _pack(rh, rl, ~(o1 | o2 | o3), out, B)
    if op == "mul":
        drop = a.scale + b.scale - out.scale
        if not out.is_decimal128 and drop == 0:
            # |x| < 10^pa, |y| < 10^pb and pa + pb < 18: exact in int64
            r = x[1] * y[1]
            return _pack(r >> 63, r, r == r, out, B)
        rh, rl, n = mul64(x[1], y[1], B)
        if drop:
            rh, rl = div_pow10_half_up(rh, rl, drop, B)
        rh, rl = signed(n, rh, rl, B)
        return _pack(rh, rl, rh == rh, out, B)
    if op == "div":
        d = out.scale + b.scale - a.scale
        num = x[1] * 10 ** d if d else x[1]
        den = y[1]
        zero = den == 0
        den = B.where(zero, den * 0 + 1, den)
        an = B.where(num < 0, 0 - num, num)
        ad = B.where(den < 0, 0 - den, den)
        q = (an * 2 + ad) // (ad * 2)
        r = B.where((num < 0) != (den < 0), 0 - q, q)
        return _pack(r >> 63, r, ~zero, out, B)
    if op == "rem":
        s = max(a.scale, b.scale)
        xs = x[1] * 10 ** (s - a.scale) if s > a.scale else x[1]
        ys = y[1] * 10 ** (s - b.scale) if s > b.scale else y[1]
        zero = ys == 0
        ys = B.where(zero, ys * 0 + 1, ys)
        ax = B.where(xs < 0, 0 - xs, xs)
        ay = B.where(ys < 0, 0 - ys, ys)
        r = ax % ay
        r = B.where(xs < 0, 0 - r, r)
        rh = r >> 63
        if s > out.scale:
            rh, r = div_pow10_half_up(rh, r, s - out.scale, B)
        return _pack(rh, r, ~zero, out, B)
    raise ValueError(op)


def compare(x, a: D, y, b: D, B):
    """(x < y, x == y) of two decimal operands, across scales (the JAX
    package's ``compare``, ``:653``)."""
    s = max(a.scale, b.scale)
    da, db = s - a.scale, s - b.scale
    if x[0] == "64" and y[0] == "64" and _fits64(a, da) and _fits64(b, db):
        xs = x[1] * 10 ** da if da else x[1]
        ys = y[1] * 10 ** db if db else y[1]
        return xs < ys, xs == ys
    ah, al = _wide(x)
    bh, bl = _wide(y)
    ah, al, _o1 = rescale_up(ah, al, da, B)
    bh, bl, _o2 = rescale_up(bh, bl, db, B)
    lt = (ah < bh) | ((ah == bh) & ult(al, bl))
    return lt, (ah == bh) & (al == bl)


def rescale(x, src: D, dst: D, B):
    """A decimal cast (Spark's ``changePrecision``): the scale raised or
    lowered (HALF_UP), NULL past ``dst``'s precision."""
    d = dst.scale - src.scale
    if d == 0 and dst.precision >= src.precision:
        # a widening: the value as it is
        if x[0] == "64" and dst.is_decimal128:
            return ("128",) + widen(x[1]), x[1] == x[1]
        return x, x[1] == x[1]
    if x[0] == "64" and not dst.is_decimal128 and d >= 0 and \
            _fits64(src, d):
        v = x[1] * 10 ** d if d else x[1]
        return _pack(v >> 63, v, v == v, dst, B)
    hi, lo = _wide(x)
    ok = hi == hi
    if d > 0:
        hi, lo, ovf = rescale_up(hi, lo, d, B)
        ok = ~ovf
    elif d < 0:
        hi, lo = div_pow10_half_up(hi, lo, -d, B)
    return _pack(hi, lo, ok, dst, B)


def check_rescale(src: D, dst: D, what: str) -> None:
    if src.scale - dst.scale > MAX_LONG:
        raise NotImplementedError(f"{what}: a decimal cast that drops more "
                                  "than 18 digits of scale is not in the "
                                  "port")


# -- the plain version over torch ----------------------------------------

def operand(data: torch.Tensor, dt: T.DataType):
    """A column's data as an operand: ("64", int64) or ("128", hi, lo)."""
    if isinstance(dt, D) and dt.is_decimal128:
        return ("128", data[:, 0], data[:, 1])
    return ("64", data.to(torch.int64))


def result_data(value, ok: torch.Tensor) -> torch.Tensor:
    """A result value as a column's data plane, 0 where not ``ok``."""
    if value[0] == "128":
        hi = torch.where(ok, value[1], 0)
        lo = torch.where(ok, value[2], 0)
        return torch.stack([hi, lo], 1)
    return torch.where(ok, value[1], 0)


def to_double(data: torch.Tensor, dt: D) -> torch.Tensor:
    """``decimal_to_double`` (``:612``): the unscaled value as a double
    divided by 10^scale, correctly rounded (decimal64)."""
    if dt.is_decimal128:
        raise NotImplementedError(f"a {dt} as a double is not in the port "
                                  "yet (a decimal64 is)")
    x = data.to(torch.float64)
    # a divisor tensor: PyTorch's CUDA division by a Python scalar is a
    # multiplication by its reciprocal, which rounds otherwise
    return x / torch.full((), 10.0 ** dt.scale, dtype=torch.float64,
                          device=x.device)
