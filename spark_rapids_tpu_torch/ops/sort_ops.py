"""Multi-key sort: kernel K8 (the analog of ``spark_rapids_tpu/ops/
sort_ops.py``: ``sort_gather_batch`` ``:237``, built ``:298``, with the key
normalizers ``_float_sortable`` ``:61``, ``sortable_words`` ``:92`` and
``_order_words`` ``:115``).

``sort_permutation`` is the kernel's wrapper: each key becomes unsigned
64-bit words whose integer order is the SQL order (``csrc/sort.cu``
``sort_words``: a null-rank word for a key that may hold nulls, then the
value word; descending flips the value word; NaN sorts after +inf and -0.0
equals 0.0), and a stable LSD radix sort orders the row indices by them.
``exec/sort.py`` gathers the batch through the permutation (K7, every
row once, so no sync).  Ties keep their input order.

Under a null the value word is 0, as the JAX package's host twin
``host_order_words`` has it; its device path leaves the data under a null
in the word, so rows whose key is null are ordered there by whatever the
null slot holds.  Spark orders them by the keys that follow, as here.

A string key becomes ``ceil(longest / 7)`` words (at least one), the JAX
package's ``_string_words`` (``:71``) bit for bit: 7 bytes a word,
big-endian, each byte stored as byte + 1 in a 9-bit field and 0 past the
end, so a prefix sorts first and bytes >= 0x80 above ASCII.  Its longest
length is computed on the card and read through the gateway (one sync
for each string key), since the number of radix passes is the host's to
choose.

A decimal64 key is its unscaled int64 (a long's word); a decimal128 key
(``:101-111``, ``:182``) two words, its hi word as a long's, then its lo
word's bits unsigned.

On CPU tensors ``sort_permutation_plain`` builds words with the same order
as int64 values and sorts them stably with ``torch.sort``, last key first.
Int, date (its int32 days), long, double, decimal and string keys are
ported."""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K8 (wrapper calls that launch it), and those with a
#: decimal key
LAUNCHES = 0
DECIMAL_LAUNCHES = 0
RADIX_TILE = 256

_KEY_CODES = {T.INT: 0, T.DATE: 0, T.LONG: 1, T.DOUBLE: 2}
SORT_KEY_TYPES = tuple(_KEY_CODES) + (T.STRING,)
#: bytes one string word holds, bits of each byte's field
STRING_WORD_BYTES = 7
_BYTE_BITS = 9
_VALUE_BITS = {T.INT: 32, T.DATE: 32, T.LONG: 64, T.DOUBLE: 64}
_SIGN = -(1 << 63)

_SIGNATURES = {
    "srt_sort_words": "pipqiippp",
    "srt_sort_perm": "ppiqppppp",
    "srt_string_max_len": "piqpp",
    "srt_string_words": "pippqiiippp",
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


#: K8's key codes of a decimal128's hi and lo words (csrc/sort.cu)
_DEC128_HI, _DEC128_LO = 3, 4


def _value_words(dt: T.DataType) -> List[Tuple[int, int]]:
    """(key code, bits) of each value word of a fixed-width key."""
    if isinstance(dt, T.DecimalType):
        return [(_DEC128_HI, 64), (_DEC128_LO, 64)] if dt.is_decimal128 \
            else [(_KEY_CODES[T.LONG], 64)]
    return [(_KEY_CODES[dt], _VALUE_BITS[dt])]


def _check(columns: Sequence[DeviceColumn], orders, transfers) -> None:
    for o in orders:
        c = columns[o.ordinal]
        if c.data_type not in SORT_KEY_TYPES and \
                not isinstance(c.data_type, T.DecimalType):
            raise NotImplementedError(
                f"a sort key of {c.data_type} is not in the port yet "
                "(int, date, long, double and string keys are)")
        if c.is_string and transfers is None:
            raise ValueError("a string key needs the transfer gateway (its "
                             "word count is read from the device)")


def string_word_count(longest: int) -> int:
    """Words of a string key whose longest value has ``longest`` bytes."""
    return max(1, -(-longest // STRING_WORD_BYTES))


def sort_permutation(columns: Sequence[DeviceColumn],
                     orders: Sequence[SortOrder],
                     transfers=None) -> torch.Tensor:
    """K8's wrapper: int64 row indices in SQL order (stable).  A string
    key needs ``transfers``, which reads its longest length."""
    _check(columns, orders, transfers)
    device = columns[0].device
    if device.type == "cpu":
        return sort_permutation_plain(columns, orders, transfers)
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
        strings = [columns[o.ordinal] for o in orders
                   if columns[o.ordinal].is_string]
        longest = empty(max(1, len(strings)))
        for j, c in enumerate(strings):
            check_launch(lib.srt_string_max_len(
                c.offsets.contiguous().data_ptr(),
                int(c.offsets.dtype == torch.int64), n,
                longest[j:].data_ptr(), stream), "K8 string length")
        counts = iter(transfers.read_counts(list(longest)) if strings
                      else [])
        for o in orders:
            c = columns[o.ordinal]
            rank = None if c.all_valid else empty(n)
            if c.is_string:
                n_words = string_word_count(next(counts))
                value = empty(n_words * n)
                offsets = c.offsets.contiguous()
                valid = None if c.all_valid else \
                    c.validity.contiguous().view(torch.uint8)
                check_launch(lib.srt_string_words(
                    offsets.data_ptr(), int(offsets.dtype == torch.int64),
                    c.data.data_ptr(),
                    None if valid is None else valid.data_ptr(), n,
                    n_words, int(o.ascending), int(o.nulls_first),
                    None if rank is None else rank.data_ptr(),
                    value.data_ptr(), stream), "K8 string words")
                if rank is not None:
                    words.append(rank)
                    bits.append(1)
                words += list(value.view(n_words, n))
                bits += [64] * n_words
                continue
            data = c.data.contiguous()
            valid = None if c.all_valid else \
                c.validity.contiguous().view(torch.uint8)
            if rank is not None:
                words.append(rank)
                bits.append(1)
            for code, width in _value_words(c.data_type):
                value = empty(n)
                check_launch(lib.srt_sort_words(
                    data.data_ptr(), code,
                    None if valid is None else valid.data_ptr(), n,
                    int(o.ascending), int(o.nulls_first),
                    None if rank is None else rank.data_ptr(),
                    value.data_ptr(), stream), "K8 words")
                words.append(value)
                bits.append(width)
        perm = empty(n)
        # scratch is held by name until the launch is queued: a tensor
        # freed at once would let the next one reuse its memory
        scratch = (empty(n), empty(256 * -(-n // RADIX_TILE), torch.int32),
                   empty(256))
        check_launch(lib.srt_sort_perm(
            pointers(words), int32s(bits), len(words), n, perm.data_ptr(),
            *(t.data_ptr() for t in scratch), stream), "K8 radix sort")
    global LAUNCHES, DECIMAL_LAUNCHES
    LAUNCHES += 1
    DECIMAL_LAUNCHES += any(isinstance(columns[o.ordinal].data_type,
                                       T.DecimalType) for o in orders)
    return perm


def string_words_plain(c: DeviceColumn, n_words: int) -> torch.Tensor:
    """``[n_words, rows]`` ascending words of a string column, as
    ``csrc/sort.cu string_words`` writes them (each below 2**63, so their
    signed order is their unsigned order); 0 under a null."""
    off = c.offsets.to(torch.int64)
    starts = off[:-1]
    lens = torch.where(c.validity, off[1:] - starts, 0)
    pos = torch.arange(n_words * STRING_WORD_BYTES, dtype=torch.int64,
                       device=off.device)
    inside = pos[None, :] < lens[:, None]
    data = c.data if c.data.numel() else \
        torch.zeros(1, dtype=torch.uint8, device=off.device)
    at = torch.where(inside, starts[:, None] + pos[None, :], 0)
    vals = torch.where(inside, data[at].to(torch.int64) + 1, 0)
    shifts = _BYTE_BITS * (STRING_WORD_BYTES - 1 -
                           torch.arange(STRING_WORD_BYTES,
                                        device=off.device))
    vals = vals.view(lens.shape[0], n_words, STRING_WORD_BYTES) << shifts
    return vals.sum(dim=2).t()


def order_words_plain(c: DeviceColumn, o: SortOrder,
                      n_words: int = 1) -> List[torch.Tensor]:
    """int64 words whose signed order is the SQL order of key ``o``: the
    order ``csrc/sort.cu`` gives its unsigned words (``n_words`` for a
    string key)."""
    words = []
    if not c.all_valid:
        first = int(o.nulls_first)
        words.append(torch.where(c.validity, first, 1 - first))
    if c.is_string:
        ws = string_words_plain(c, n_words)
        return words + [w if o.ascending else ~w for w in ws]
    if isinstance(c.data_type, T.DecimalType) and c.data_type.is_decimal128:
        ws = [c.data[:, 0], c.data[:, 1] ^ _SIGN]   # lo unsigned
        return words + [torch.where(c.validity, w, 0) if o.ascending
                        else ~torch.where(c.validity, w, 0) for w in ws]
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


def string_longest_plain(c: DeviceColumn) -> torch.Tensor:
    """The longest value of a string column, as a one-element tensor."""
    off = c.offsets.to(torch.int64)
    return (off[1:] - off[:-1]).max() if c.row_count else off[0]


def sort_permutation_plain(columns: Sequence[DeviceColumn],
                           orders: Sequence[SortOrder],
                           transfers=None) -> torch.Tensor:
    """The plain PyTorch version of K8: stable sorts, last word first (the
    longest strings are read through the gateway, as the kernel reads
    them)."""
    _check(columns, orders, transfers)
    n = columns[0].row_count
    perm = torch.arange(n, dtype=torch.int64, device=columns[0].device)
    strings = [columns[o.ordinal] for o in orders
               if columns[o.ordinal].is_string]
    counts = iter(transfers.read_counts(
        [string_longest_plain(c) for c in strings]) if strings else [])
    words = [w for o in orders
             for w in order_words_plain(
                 columns[o.ordinal], o,
                 string_word_count(next(counts))
                 if columns[o.ordinal].is_string else 1)]
    for w in reversed(words):
        _, order = torch.sort(w[perm], stable=True)
        perm = perm[order]
    return perm
