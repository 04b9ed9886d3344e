"""Multi-key sort: kernel K8 (the analog of ``spark_rapids_tpu/ops/
sort_ops.py``: ``sort_gather_batch`` ``:237``, built ``:298``, with the key
normalizers ``_float_sortable`` ``:61``, ``sortable_words`` ``:92`` and
``_order_words`` ``:115``).

``sort_permutation`` is the kernel's wrapper: each key becomes unsigned
64-bit words whose integer order is the SQL order (``csrc/sort.cu``
``sort_words``: a null-rank word for a key that may hold nulls, then the
value word; descending flips the value word; NaN sorts after +inf and -0.0
equals 0.0), and a stable LSD radix sort orders the row indices by them.
``sort_batch`` gathers the batch through the permutation (K7, every row
once, so no sync).  Ties keep their input order.

Under a null the value word is 0, as the JAX package's host twin
``host_order_words`` has it; its device path leaves the data under a null
in the word, so rows whose key is null are ordered there by whatever the
null slot holds.  Spark orders them by the keys that follow, as here.

On CPU tensors ``sort_permutation_plain`` builds words with the same order
as int64 values and sorts them stably with ``torch.sort``, last key first.
Int, long and double keys are ported; string keys are still to port
(ROADMAP queue 2, K8)."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K8 (wrapper calls that launch it)
LAUNCHES = 0
RADIX_TILE = 256

_KEY_CODES = {T.INT: 0, T.LONG: 1, T.DOUBLE: 2}
SORT_KEY_TYPES = tuple(_KEY_CODES)
_VALUE_BITS = {T.INT: 32, T.LONG: 64, T.DOUBLE: 64}
_SIGN = -(1 << 63)

_SIGNATURES = {
    "srt_sort_words": "pipqiippp",
    "srt_sort_perm": "ppiqppppp",
}


@dataclasses.dataclass(frozen=True)
class SortOrder:
    """One sort key over a batch ordinal (Spark's SortOrder)."""
    ordinal: int
    ascending: bool = True
    nulls_first: bool = True

    @staticmethod
    def asc(ordinal: int) -> "SortOrder":
        return SortOrder(ordinal, True, True)

    @staticmethod
    def desc(ordinal: int) -> "SortOrder":
        return SortOrder(ordinal, False, False)


def load_library():
    """Builds (first call) and binds ``csrc/sort.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("sort.fused", "csrc/sort.cu",
                        lambda: load_cuda("sort.cu", _SIGNATURES))


def _check(columns: Sequence[DeviceColumn], orders) -> None:
    for o in orders:
        c = columns[o.ordinal]
        if c.data_type not in _KEY_CODES:
            raise NotImplementedError(
                f"a sort key of {c.data_type} is not in the port yet "
                "(int, long and double keys are)")


def sort_permutation(columns: Sequence[DeviceColumn],
                     orders: Sequence[SortOrder]) -> torch.Tensor:
    """K8's wrapper: int64 row indices in SQL order (stable)."""
    _check(columns, orders)
    device = columns[0].device
    if device.type == "cpu":
        return sort_permutation_plain(columns, orders)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      pointers)
    lib = load_library()
    n = columns[0].row_count

    def empty(count, dtype=torch.int64):
        return torch.empty(count, dtype=dtype, device=device)

    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        words: List[torch.Tensor] = []
        bits: List[int] = []
        for o in orders:
            c = columns[o.ordinal]
            rank = None if c.all_valid else empty(n)
            value = empty(n)
            data = c.data.contiguous()
            valid = None if c.all_valid else \
                c.validity.contiguous().view(torch.uint8)
            check_launch(lib.srt_sort_words(
                data.data_ptr(), _KEY_CODES[c.data_type],
                None if valid is None else valid.data_ptr(), n,
                int(o.ascending), int(o.nulls_first),
                None if rank is None else rank.data_ptr(), value.data_ptr(),
                stream), "K8 words")
            if rank is not None:
                words.append(rank)
                bits.append(1)
            words.append(value)
            bits.append(_VALUE_BITS[c.data_type])
        perm = empty(n)
        # scratch is held by name until the launch is queued: a tensor
        # freed at once would let the next one reuse its memory
        scratch = (empty(n), empty(256 * -(-n // RADIX_TILE), torch.int32),
                   empty(256))
        check_launch(lib.srt_sort_perm(
            pointers(words), int32s(bits), len(words), n, perm.data_ptr(),
            *(t.data_ptr() for t in scratch), stream), "K8 radix sort")
    global LAUNCHES
    LAUNCHES += 1
    return perm


def order_words_plain(c: DeviceColumn, o: SortOrder) -> List[torch.Tensor]:
    """int64 words whose signed order is the SQL order of key ``o``: the
    order ``csrc/sort.cu`` gives its unsigned words."""
    words = []
    if not c.all_valid:
        first = int(o.nulls_first)
        words.append(torch.where(c.validity, first, 1 - first))
    if c.data_type.is_floating:
        x = torch.where(c.data == 0, 0.0, c.data)
        x = torch.where(torch.isnan(x), float("nan"), x)
        b = x.contiguous().view(torch.int64)
        w = torch.where(b < 0, ~b, b | _SIGN) ^ _SIGN
    else:
        w = c.data.to(torch.int64)
    w = torch.where(c.validity, w, 0)
    words.append(w if o.ascending else ~w)
    return words


def sort_permutation_plain(columns: Sequence[DeviceColumn],
                           orders: Sequence[SortOrder]) -> torch.Tensor:
    """The plain PyTorch version of K8: stable sorts, last word first."""
    _check(columns, orders)
    n = columns[0].row_count
    perm = torch.arange(n, dtype=torch.int64, device=columns[0].device)
    words = [w for o in orders
             for w in order_words_plain(columns[o.ordinal], o)]
    for w in reversed(words):
        _, order = torch.sort(w[perm], stable=True)
        perm = perm[order]
    return perm


def sort_batch(batch: ColumnarBatch, orders: Sequence[SortOrder],
               transfers) -> ColumnarBatch:
    """The batch in SQL order: K8, then K7 through the permutation."""
    from spark_rapids_tpu_torch.ops.batch_ops import gather_batch
    if batch.row_count == 0:
        return batch
    perm = sort_permutation(batch.columns, orders)
    return gather_batch(batch, perm, transfers, unique=True)
