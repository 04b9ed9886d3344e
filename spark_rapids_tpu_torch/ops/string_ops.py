"""Computed strings: kernel K13 (the device forms of the JAX package's
``expressions/strings.py``: ``Substring.eval_tpu`` ``:179`` and
``Concat.eval_tpu`` ``:115``).

``string_column`` is K13's wrapper.  It writes a string column with
offsets, chars and validity: a substring of one string column (the JAX
device form's byte rule, ``expressions/strings.py Substring``), or the
concat of string columns and string literals (NULL if any part is NULL; a
null literal makes every row null).  The JAX forms write padded
``[rows, width]`` byte planes, a static-shape form for the TPU; here the
output is sized exactly.  On CUDA columns it launches ``csrc/strings.cu``:
the sizes pass and the scan of the lengths into offsets (one call), one
read of the total through ``TransferGateway.read_counts``, then the write
pass.  The literals of a concat reach the kernel as one small device
byte buffer (one counted H2D copy a call).  ``rows``
(int64 input row indices) makes output row ``i`` input row ``rows[i]``:
a compacting stage's survivors, so nothing is gathered first.  On CPU
columns it runs ``string_column_plain``, which builds the same offsets
and chars with a gather (``compute_plain``, also the expressions' plain
``eval``)."""

from __future__ import annotations

from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K13 (wrapper calls that launch it)
LAUNCHES = 0

SUBSTRING = 0
CONCAT = 1
#: csrc/strings.cu part kinds
_COLUMN, _LITERAL, _NULL_LITERAL = 0, 1, 2
#: parts one launch takes (csrc/strings.cu kMaxParts)
MAX_PARTS = 8
#: values one scan tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024
#: the length of a substring with no ``len`` (the JAX package's 2**30)
NO_LENGTH = 2 ** 30

_SIGNATURES = {
    "srt_string_sizes": "iipppppppiipqpppp",
    "srt_string_write": "iipppppppiipqpppp",
}

#: a part: a string column, a literal's UTF-8 bytes, or None (a null
#: literal)
Part = Union[DeviceColumn, bytes, None]

def load_library():
    """Builds (first call) and binds ``csrc/strings.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("string.write", "csrc/strings.cu",
                        lambda: load_cuda("strings.cu", _SIGNATURES))


def _check(op: int, parts: Sequence[Part], n: int, rows, device) -> None:
    if op not in (SUBSTRING, CONCAT):
        raise ValueError(f"K13 op {op}")
    if not 1 <= len(parts) <= MAX_PARTS:
        raise NotImplementedError(
            f"K13 takes 1 to {MAX_PARTS} parts, got {len(parts)}")
    if op == SUBSTRING and (len(parts) != 1 or
                            not isinstance(parts[0], DeviceColumn)):
        raise ValueError("a substring reads one string column")
    for p in parts:
        if isinstance(p, DeviceColumn):
            if not p.is_string:
                raise TypeError(f"K13 reads string columns, got "
                                f"{p.data_type}")
            if p.device != device:
                raise ValueError("K13's parts lie on different devices")
            if rows is None and p.row_count != n:
                raise ValueError(f"a part of {p.row_count} rows for {n}")
        elif p is not None and not isinstance(p, bytes):
            raise TypeError(f"a K13 literal is bytes or None, got {p!r}")
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 1
                             or rows.shape[0] != n or rows.device != device):
        raise ValueError("K13's rows must be n int64 row indices on the "
                         "parts' device")


def string_column(op: int, parts: Sequence[Part], n: int,
                  device: torch.device, transfers, pos: int = 1,
                  length: Optional[int] = None,
                  rows: Optional[torch.Tensor] = None) -> DeviceColumn:
    """K13's wrapper: ``n`` rows of a computed string (``op`` SUBSTRING of
    ``parts[0]`` at ``pos`` for ``length`` bytes, or CONCAT of
    ``parts``), output row ``i`` reading input row ``rows[i]`` when
    ``rows`` is given."""
    device = torch.device(device)
    _check(op, parts, n, rows, device)
    if device.type == "cpu":
        return string_column_plain(op, parts, n, device, transfers, pos,
                                   length, rows)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if n == 0:
        return DeviceColumn(torch.empty(0, dtype=torch.uint8, device=device),
                            torch.empty(0, dtype=torch.bool, device=device),
                            T.STRING,
                            offsets=torch.zeros(1, dtype=torch.int64,
                                                device=device))
    from spark_rapids_tpu_torch.kernels.build import (check_launch, int32s,
                                                      int64s, pointers)
    lib = load_library()
    literals = [p for p in parts if isinstance(p, bytes)]
    # every literal's bytes in one small device buffer, one H2D copy
    buf = transfers.to_device(np.frombuffer(b"".join(literals) or b"\0",
                                            dtype=np.uint8)) \
        if literals else None
    kinds, off64, chars, offsets, valid, starts, lens = [], [], [], [], [], \
        [], []
    at = 0
    for p in parts:
        if isinstance(p, DeviceColumn):
            # held by name until the launches are queued
            chars.append(p.data.contiguous())
            offsets.append(p.offsets.contiguous())
            valid.append(None if p.all_valid else
                         p.validity.contiguous().view(torch.uint8))
            kinds.append(_COLUMN)
            off64.append(int(p.offsets.dtype == torch.int64))
            starts.append(0)
            lens.append(0)
            continue
        kinds.append(_NULL_LITERAL if p is None else _LITERAL)
        off64.append(0)
        chars.append(None if p is None else buf)
        offsets.append(None)
        valid.append(None)
        starts.append(at)
        lens.append(0 if p is None else len(p))
        at += 0 if p is None else len(p)
    slen = NO_LENGTH if length is None else max(min(length, NO_LENGTH),
                                                -NO_LENGTH)
    # a position past 2**30 bytes acts as 2**30 on any string shorter
    pos = max(min(pos, NO_LENGTH), -NO_LENGTH)
    ridx = None if rows is None else rows.contiguous()
    args = (op, len(parts), int32s(kinds), int32s(off64), pointers(chars),
            pointers(offsets), pointers(valid), int64s(starts), int64s(lens),
            int(pos), slen, None if ridx is None else ridx.data_ptr(), n)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out_off = torch.empty(n + 1, dtype=torch.int64, device=device)
        out_valid = torch.empty(n, dtype=torch.bool, device=device)
        scratch = torch.empty(max(1, -(-n // SCAN_TILE)), dtype=torch.int64,
                              device=device)
        check_launch(lib.srt_string_sizes(
            *args, out_off.data_ptr(), out_valid.data_ptr(),
            scratch.data_ptr(), stream), "K13 sizes")
        total, = transfers.read_counts([out_off[n]])
        out_chars = torch.empty(total, dtype=torch.uint8, device=device)
        if total:
            check_launch(lib.srt_string_write(
                *args, out_off.data_ptr(), out_valid.data_ptr(),
                out_chars.data_ptr(), stream), "K13 write")
    global LAUNCHES
    LAUNCHES += 1
    return DeviceColumn(out_chars, out_valid, T.STRING, offsets=out_off)


def substring_range(lens: torch.Tensor, pos: int, length: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(start within the value, byte length)`` of each substring of
    values of ``lens`` bytes: the JAX device form's rule, ``pos``
    clamped against the length first (ROADMAP queue 3)."""
    if pos > 0:
        start = torch.clamp(lens, max=pos - 1)
    elif pos < 0:
        start = torch.clamp(lens + pos, min=0)
    else:
        start = torch.zeros_like(lens)
    slen = NO_LENGTH if length is None else length
    return start, torch.clamp(torch.clamp(lens - start, max=slen), min=0)


def compute_plain(op: int, parts: Sequence, n: int, device, read_total,
                  pos: int = 1, length: Optional[int] = None,
                  rows: Optional[torch.Tensor] = None):
    """``(chars, int64 offsets, validity)`` of K13's output over raw parts
    (each a ``(chars, offsets, validity)`` triple of tensors, a literal's
    bytes or None): each (row, part) piece's length and source in the
    parts' chars laid end to end, the offsets, then one gather of the
    bytes; ``read_total`` brings the chars total to the host."""
    valid = torch.ones(n, dtype=torch.bool, device=device)
    buffers, srcs, lens = [], [], []
    base = 0
    for p in parts:
        if isinstance(p, tuple):
            chars, offsets, pvalid = p
            off = offsets.to(torch.int64)
            first = off[:-1] if rows is None else off[rows]
            last = off[1:] if rows is None else off[rows + 1]
            valid = valid & (pvalid if rows is None else pvalid[rows])
            start, ln = first, last - first
            if op == SUBSTRING:
                skip, ln = substring_range(ln, pos, length)
                start = start + skip
            buffers.append(chars)
            srcs.append(start + base)
            lens.append(ln)
            base += chars.shape[0]
        elif p is None:
            valid = torch.zeros_like(valid)
        else:
            buffers.append(torch.tensor(list(p), dtype=torch.uint8,
                                        device=device))
            srcs.append(torch.full((n,), base, dtype=torch.int64,
                                   device=device))
            lens.append(torch.full((n,), len(p), dtype=torch.int64,
                                   device=device))
            base += len(p)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    if not lens or not n:
        if n:   # the kernel launches, and reads its total, for n > 0
            read_total(offsets[n])
        return torch.empty(0, dtype=torch.uint8, device=device), offsets, \
            valid
    seg = torch.where(valid[:, None], torch.stack(lens, 1), 0).reshape(-1)
    ends = torch.cumsum(seg, 0)
    offsets[1:] = ends.reshape(n, -1)[:, -1]
    total = read_total(offsets[n])
    at = torch.repeat_interleave(torch.stack(srcs, 1).reshape(-1) -
                                 (ends - seg), seg, output_size=total) + \
        torch.arange(total, dtype=torch.int64, device=device)
    return torch.cat(buffers)[at], offsets, valid


def string_column_plain(op: int, parts: Sequence[Part], n: int,
                        device: torch.device, transfers, pos: int = 1,
                        length: Optional[int] = None,
                        rows: Optional[torch.Tensor] = None
                        ) -> DeviceColumn:
    """The plain PyTorch version of K13 (it reads the chars total through
    the gateway, as the kernel does)."""
    device = torch.device(device)
    _check(op, parts, n, rows, device)
    raw = [(p.data, p.offsets, p.validity) if isinstance(p, DeviceColumn)
           else p for p in parts]
    chars, offsets, valid = compute_plain(
        op, raw, n, device, lambda t: transfers.read_counts([t])[0], pos,
        length, rows)
    return DeviceColumn(chars, valid, T.STRING, offsets=offsets)

