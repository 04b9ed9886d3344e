"""Spark's Murmur3Hash (the analog of ``spark_rapids_tpu/expressions/
hashing.py``): murmur3_x86_32 with seed 42, chained over the columns, a
null field leaving the running hash unchanged (``murmur3_col``, ``:128``).

The plain version below keeps each uint32 in an int64 tensor (values in
[0, 2**32)) and multiplies in 16-bit halves, so no intermediate overflows.
The kernel form is the Triton device functions in ``kernels/fused_agg.py``.
This slice hashes int and long columns (``_hash_int`` ``:67``,
``_hash_long`` ``:73``); float, double and string inputs are refused."""

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


def murmur3_col(c: Col, dtype: T.DataType, seed: torch.Tensor
                ) -> torch.Tensor:
    """Running murmur3 update for one column; nulls pass the seed on."""
    if isinstance(dtype, T.LongType):
        h = hash_long(c.data, seed)
    elif isinstance(dtype, T.IntegerType):
        h = hash_int(c.data, seed)
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
