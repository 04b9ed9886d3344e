"""Spark's Murmur3Hash (the analog of ``spark_rapids_tpu/expressions/
hashing.py``): murmur3_x86_32 with seed 42, chained over the columns, a
null field leaving the running hash unchanged (``murmur3_col``, ``:128``).

The plain version below keeps each uint32 in an int64 tensor (values in
[0, 2**32)) and multiplies in 16-bit halves, so no intermediate overflows.
Every type a hash exchange keys on is hashed as the JAX package hashes it:
int and date (``_hash_int`` ``:67``), bool as 0 or 1, long
(``_hash_long`` ``:73``), float and double with -0.0 as 0.0 and every NaN
as the canonical NaN (``_normalize_float_bits`` ``:82``), and string
(Spark's ``hashUnsafeBytes``, ``_hash_string_murmur`` ``:99``: aligned
4-byte blocks little-endian, then each tail byte as a signed int, then
the byte length into ``fmix``).  The kernel forms are the Triton device
functions in ``kernels/fused_agg.py`` (int and long, inside K1) and
``csrc/murmur3.cuh`` (every type, inside K11h)."""

from __future__ import annotations

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.expressions.base import Col, EvalContext, \
    Expression

MASK32 = 0xFFFFFFFF
C1 = 0xCC9E2D51
C2 = 0x1B873593
C3 = 0xE6546B64
F1 = 0x85EBCA6B
F2 = 0xC2B2AE35


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for a in [0, 2**32) without int64 overflow."""
    lo = a * (c & 0xFFFF)
    hi = (a * (c >> 16)) & 0xFFFF
    return (lo + (hi << 16)) & MASK32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & MASK32) | (x >> (32 - r))


def _mix_k1(k1):
    return _mul32(_rotl32(_mul32(k1, C1), 15), C2)


def _mix_h1(h1, k1):
    h1 = _rotl32(h1 ^ k1, 13)
    return (_mul32(h1, 5) + C3) & MASK32


def _fmix(h1, length: int):
    h1 = h1 ^ length
    h1 = h1 ^ (h1 >> 16)
    h1 = _mul32(h1, F1)
    h1 = h1 ^ (h1 >> 13)
    h1 = _mul32(h1, F2)
    return h1 ^ (h1 >> 16)


def hash_int(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of int32 values under per-row seeds (uint32 in int64)."""
    k1 = _mix_k1(values.to(torch.int64) & MASK32)
    return _fmix(_mix_h1(seed, k1), 4)


def hash_long(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of int64 values: low word, then high word."""
    low = values & MASK32
    high = (values >> 32) & MASK32
    h1 = _mix_h1(seed, _mix_k1(low))
    h1 = _mix_h1(h1, _mix_k1(high))
    return _fmix(h1, 8)


def hash_double(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of float64 values: the bits of the value with -0.0 as 0.0
    and every NaN as the canonical NaN, hashed as a long."""
    x = torch.where(values == 0, 0.0, values.to(torch.float64))
    x = torch.where(torch.isnan(x), float("nan"), x)
    return hash_long(x.contiguous().view(torch.int64), seed)


def hash_float(values: torch.Tensor, seed: torch.Tensor) -> torch.Tensor:
    """murmur3 of float32 values, normalised as ``hash_double``, hashed as
    an int."""
    x = torch.where(values == 0, 0.0, values.to(torch.float32))
    x = torch.where(torch.isnan(x), float("nan"), x)
    return hash_int(x.contiguous().view(torch.int32), seed)


def hash_string(offsets: torch.Tensor, chars: torch.Tensor,
                seed: torch.Tensor) -> torch.Tensor:
    """Spark's hashUnsafeBytes of each row's bytes: the aligned 4-byte
    blocks little-endian, each tail byte as a signed int, then ``fmix``
    with the byte length."""
    off = offsets.to(torch.int64)
    starts = off[:-1]
    lens = off[1:] - starts
    n = lens.shape[0]
    width = int(lens.max()) if n else 0
    pos = torch.arange(width, dtype=torch.int64, device=off.device)
    inside = pos[None, :] < lens[:, None]
    data = chars if chars.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=off.device)
    mat = torch.where(inside, data[torch.where(inside, starts[:, None] +
                                               pos[None, :], 0)], 0)
    mat = mat.to(torch.int64)
    h1 = seed.clone()
    nblocks = lens // 4
    for b in range(width // 4):
        k = mat[:, 4 * b] | (mat[:, 4 * b + 1] << 8) | \
            (mat[:, 4 * b + 2] << 16) | (mat[:, 4 * b + 3] << 24)
        h1 = torch.where(b < nblocks, _mix_h1(h1, _mix_k1(k)), h1)
    signed = torch.where(mat >= 128, mat - 256, mat) & MASK32
    for t in range(3):
        at = nblocks * 4 + t
        byte = signed.gather(1, at.clamp(max=max(width - 1, 0))[:, None]
                             )[:, 0] if width else torch.zeros_like(h1)
        h1 = torch.where(at < lens, _mix_h1(h1, _mix_k1(byte)), h1)
    return _fmix(h1, lens & MASK32)


def murmur3_col(c: Col, dtype: T.DataType, seed: torch.Tensor
                ) -> torch.Tensor:
    """Running murmur3 update for one column; nulls pass the seed on."""
    if isinstance(dtype, T.LongType):
        h = hash_long(c.data, seed)
    elif isinstance(dtype, (T.IntegerType, T.DateType)):
        h = hash_int(c.data, seed)
    elif isinstance(dtype, T.BooleanType):
        h = hash_int(c.data.to(torch.int64), seed)
    elif isinstance(dtype, T.DoubleType):
        h = hash_double(c.data, seed)
    elif isinstance(dtype, T.StringType):
        h = hash_string(c.offsets, c.data, seed)
    else:
        raise NotImplementedError(f"murmur3 of {dtype} is not in this port "
                                  "yet")
    return torch.where(c.valid, h, seed)


def to_int32(h: torch.Tensor) -> torch.Tensor:
    """uint32-in-int64 -> the same 32 bits as int32."""
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


class Murmur3Hash(Expression):
    """hash(cols...) -> int32, seed 42 (Spark's ``hash`` function)."""

    def __init__(self, *exprs: Expression, seed: int = 42):
        super().__init__(list(exprs))
        self.seed = seed

    @property
    def data_type(self):
        return T.INT

    @property
    def nullable(self):
        return False

    def eval(self, ctx: EvalContext) -> Col:
        h = torch.full((ctx.row_count,), self.seed & MASK32,
                       dtype=torch.int64, device=ctx.device)
        for child in self.children:
            h = murmur3_col(child.eval(ctx), child.data_type, h)
        return Col(to_int32(h), torch.ones(ctx.row_count, dtype=torch.bool,
                                           device=ctx.device))
