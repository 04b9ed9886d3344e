"""Computed strings: kernel K13 (the device forms of the JAX package's
``expressions/strings.py``: ``Substring.eval_tpu`` ``:179``,
``Concat.eval_tpu`` ``:115``, ``Length.eval_tpu`` ``:49`` and
``Upper``/``Lower`` ``:68``, ``eval_tpu`` ``:78``).

``string_column`` is K13's wrapper.  It writes a string column with
offsets, chars and validity: a substring of one string column by
characters (Spark's rule, which the JAX CPU engine follows; the JAX
device form cuts bytes, ROADMAP queue 3), the concat of string columns
and string literals (NULL if any part is NULL; a null literal makes every
row null), or the upper or lower case of one string column (Python's
``str.upper``/``str.lower``, the JAX CPU engine's and Spark's rule; the
JAX device form maps ASCII only).  A character is a byte that is not a
continuation byte (``10xxxxxx``) with the continuation bytes after it,
the rule the JAX ``Length`` counts by.  The JAX forms write padded
``[rows, width]`` byte planes, a static-shape form for the TPU; here the
output is sized exactly.  On CUDA columns it launches ``csrc/strings.cu``:
the sizes pass and the scan of the lengths into offsets (one call), one
read of the total through ``TransferGateway.read_counts``, then the write
pass.  The literals of a concat reach the kernel as one small device
byte buffer (one counted H2D copy a call); the case table
(``case_table``) is built at first use from Python's own case mappings
and copied to each device once.  ``rows`` (int64 input row indices) makes
output row ``i`` input row ``rows[i]``: a compacting stage's survivors,
so nothing is gathered first.  ``string_length`` is K13's length pass
(one int32 a row, no sync).  On CPU columns they run
``string_column_plain`` and ``string_length_plain``, which build the same
planes with tensor ops (``compute_plain``, also the expressions' plain
``eval``)."""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple, Union

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K13's string writes (wrapper calls that launch it); of
#: those, the substrings' and the case maps'; and of its length pass
LAUNCHES = 0
SUBSTRING_LAUNCHES = 0
CASE_LAUNCHES = 0
LENGTH_LAUNCHES = 0

SUBSTRING = 0
CONCAT = 1
#: the length pass (``string_length``), a form of its own
LENGTH = 2
UPPER = 3
LOWER = 4
#: the ops that read one string column
_SINGLE = (SUBSTRING, UPPER, LOWER)
#: csrc/strings.cu part kinds
_COLUMN, _LITERAL, _NULL_LITERAL = 0, 1, 2
#: parts one launch takes (csrc/strings.cu kMaxParts)
MAX_PARTS = 8
#: values one scan tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024
#: the length of a substring with no ``len`` (the JAX package's 2**30)
NO_LENGTH = 2 ** 30

_SIGNATURES = {
    "srt_string_sizes": "iipppppppiipqpppppp",
    "srt_string_write": "iipppppppiipqpppppp",
    "srt_string_length": "ppippqppp",
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
    if op not in (SUBSTRING, CONCAT, UPPER, LOWER):
        raise ValueError(f"K13 op {op}")
    if not 1 <= len(parts) <= MAX_PARTS:
        raise NotImplementedError(
            f"K13 takes 1 to {MAX_PARTS} parts, got {len(parts)}")
    if op in _SINGLE and (len(parts) != 1 or
                          not isinstance(parts[0], DeviceColumn)):
        raise ValueError("a substring or a case map reads one string "
                         "column")
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
    ``parts[0]`` at character ``pos`` for ``length`` characters, CONCAT of
    ``parts``, UPPER or LOWER of ``parts[0]``), output row ``i`` reading
    input row ``rows[i]`` when ``rows`` is given."""
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
    # a position past 2**30 characters acts as 2**30 on any string shorter
    pos = max(min(pos, NO_LENGTH), -NO_LENGTH)
    ridx = None if rows is None else rows.contiguous()
    table = device_case_table(op == LOWER, device, transfers) \
        if op in (UPPER, LOWER) else None
    tptr = pointers(table.planes) if table is not None else None
    tsizes = int64s(table.sizes) if table is not None else None
    args = (op, len(parts), int32s(kinds), int32s(off64), pointers(chars),
            pointers(offsets), pointers(valid), int64s(starts), int64s(lens),
            int(pos), slen, None if ridx is None else ridx.data_ptr(), n,
            tptr, tsizes)
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
    global LAUNCHES, SUBSTRING_LAUNCHES, CASE_LAUNCHES
    LAUNCHES += 1
    SUBSTRING_LAUNCHES += op == SUBSTRING
    CASE_LAUNCHES += op in (UPPER, LOWER)
    return DeviceColumn(out_chars, out_valid, T.STRING, offsets=out_off)


def _check_length(column: DeviceColumn, n: int, rows) -> None:
    if not isinstance(column, DeviceColumn) or not column.is_string:
        raise TypeError("K13's length reads one string column")
    if rows is None and column.row_count != n:
        raise ValueError(f"a column of {column.row_count} rows for {n}")
    if rows is not None and (rows.dtype != torch.int64 or rows.dim() != 1
                             or rows.shape[0] != n or
                             rows.device != column.device):
        raise ValueError("K13's rows must be n int64 row indices on the "
                         "column's device")


def string_length(column: DeviceColumn, n: int,
                  rows: Optional[torch.Tensor] = None) -> DeviceColumn:
    """K13's length pass: an INT column of the characters of each of ``n``
    rows of ``column`` (``rows[i]`` for output row ``i``), null where the
    input is."""
    _check_length(column, n, rows)
    device = column.device
    if device.type == "cpu":
        return string_length_plain(column, n, rows)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # held by name until the launch is queued
        chars = column.data.contiguous()
        offsets = column.offsets.contiguous()
        valid = None if column.all_valid else \
            column.validity.contiguous().view(torch.uint8)
        ridx = None if rows is None else rows.contiguous()
        out = torch.empty(n, dtype=torch.int32, device=device)
        out_valid = torch.empty(n, dtype=torch.bool, device=device)
        check_launch(lib.srt_string_length(
            chars.data_ptr(), offsets.data_ptr(),
            int(offsets.dtype == torch.int64),
            None if valid is None else valid.data_ptr(),
            None if ridx is None else ridx.data_ptr(), n, out.data_ptr(),
            out_valid.data_ptr(), stream), "K13 length")
    global LENGTH_LAUNCHES
    LENGTH_LAUNCHES += 1
    return DeviceColumn(out, out_valid, T.INT)


def string_length_plain(column: DeviceColumn, n: int,
                        rows: Optional[torch.Tensor] = None
                        ) -> DeviceColumn:
    """The plain PyTorch version of K13's length pass."""
    _check_length(column, n, rows)
    count, valid = length_plain(column.data, column.offsets,
                                column.validity, rows)
    return DeviceColumn(count, valid, T.INT)


def _leads_before(chars: torch.Tensor) -> torch.Tensor:
    """int64 ``[len + 1]``: the characters (non-continuation bytes) before
    each byte of the plane."""
    lead = (chars & 0xC0) != 0x80
    out = torch.zeros(chars.shape[0] + 1, dtype=torch.int64,
                      device=chars.device)
    torch.cumsum(lead.to(torch.int64), 0, out=out[1:])
    return out


def length_plain(chars, offsets, valid, rows=None):
    """``(int32 characters, validity)`` of each row (``rows``: the input
    row of each output row)."""
    off = offsets.to(torch.int64)
    first = off[:-1] if rows is None else off[rows]
    last = off[1:] if rows is None else off[rows + 1]
    ok = valid if rows is None else valid[rows]
    cl = _leads_before(chars)
    count = torch.where(ok, cl[last] - cl[first], 0).to(torch.int32)
    return count, ok.clone()


def substring_range(chars: torch.Tensor, first: torch.Tensor,
                    last: torch.Tensor, pos: int, length: Optional[int]
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(first byte, byte length)`` of each substring of the values at
    ``chars[first:last]``, by characters (the value's c-th character
    starts at its c-th non-continuation byte, a character past the last
    at the end): the start character is clamped against the character
    count first (ROADMAP queue 3), as ``csrc/strings.cu`` does."""
    cl = _leads_before(chars)
    n_chars = cl[last] - cl[first]
    if pos > 0:
        c0 = torch.clamp(n_chars, max=pos - 1)
    elif pos < 0:
        c0 = torch.clamp(n_chars + pos, min=0)
    else:
        c0 = torch.zeros_like(n_chars)
    slen = NO_LENGTH if length is None else length
    take = torch.clamp(torch.clamp(n_chars - c0, max=slen), min=0)
    leads = torch.nonzero((chars & 0xC0) != 0x80).reshape(-1)
    top = max(leads.shape[0] - 1, 0)

    def start_of(c):
        at = leads[torch.clamp(cl[first] + c, max=top)] if leads.shape[0] \
            else last
        return torch.where(c < n_chars, at, last)
    b0, b1 = start_of(c0), start_of(c0 + take)
    return b0, b1 - b0


# -- the case table -------------------------------------------------------------

#: capital sigma, and the UTF-8 bytes of its final form
_CAPITAL_SIGMA = 0x3A3
_FINAL_SIGMA = b"\xcf\x82"


@functools.lru_cache(maxsize=2)
def case_table(lower: bool):
    """``(code points, mapping offsets, mapping bytes, cased ranges,
    case-ignorable ranges)`` as numpy arrays: every code point whose
    ``str.lower`` (or ``str.upper``) differs from it, sorted, with the
    UTF-8 bytes of its mapping (a mapping may be longer: 'ß' gives
    "SS"), and the ``[lo, hi]`` int32 ranges of the cased and the
    case-ignorable code points that Final_Sigma reads (cased: lower,
    upper or title case; case-ignorable: read from ``str.lower`` itself,
    as the characters it skips between a cased letter and a sigma)."""
    import unicodedata
    cps, moff, mbytes, cased, ignorable = [], [0], [], [], []
    for c in range(0x110000):
        if 0xD800 <= c < 0xE000:
            continue
        ch = chr(c)
        if unicodedata.category(ch) in ("Cn", "Co"):
            continue
        mapped = ch.lower() if lower else ch.upper()
        if mapped != ch:
            raw = mapped.encode("utf-8")
            cps.append(c)
            mbytes.append(raw)
            moff.append(moff[-1] + len(raw))
        is_cased = ch.islower() or ch.isupper() or ch.istitle()
        if is_cased:
            cased.append(c)
        # a sigma after "1<ch>" is final when ch is cased and not
        # case-ignorable; after "A<ch>" when ch is case-ignorable
        probe = ("1" if is_cased else "A") + ch + "Σ"
        if (probe.lower()[-1] == "σ") == is_cased:
            ignorable.append(c)
    return (np.array(cps, dtype=np.int32), np.array(moff, dtype=np.int32),
            np.frombuffer(b"".join(mbytes), dtype=np.uint8).copy(),
            _ranges(cased), _ranges(ignorable))


def _ranges(values) -> np.ndarray:
    """Sorted ints as int32 ``[k, 2]`` inclusive ``[lo, hi]`` runs."""
    v = np.asarray(values, dtype=np.int64)
    if not len(v):
        return np.zeros((0, 2), dtype=np.int32)
    breaks = np.flatnonzero(np.diff(v) != 1) + 1
    lo = v[np.concatenate([[0], breaks])]
    hi = v[np.concatenate([breaks - 1, [len(v) - 1]])]
    return np.stack([lo, hi], 1).astype(np.int32)


class DeviceCaseTable:
    """One device's copy of a case table: ``planes`` (code points, mapping
    offsets, mapping bytes, cased ranges, case-ignorable ranges) and
    ``sizes`` (mappings, cased ranges, case-ignorable ranges)."""

    def __init__(self, arrays, device, transfers):
        upload = (lambda a: transfers.to_device(a)) if transfers is not None \
            else (lambda a: torch.from_numpy(a).to(device))
        self.planes = [upload(np.ascontiguousarray(a)) for a in arrays]
        self.sizes = [len(arrays[0]), len(arrays[3]), len(arrays[4])]


_DEVICE_TABLES = {}


def device_case_table(lower: bool, device, transfers=None
                      ) -> DeviceCaseTable:
    """The case table on ``device``, copied there once (counted by
    ``transfers``)."""
    key = (lower, str(device))
    if key not in _DEVICE_TABLES:
        _DEVICE_TABLES[key] = DeviceCaseTable(case_table(lower), device,
                                              transfers)
    return _DEVICE_TABLES[key]


def _in_ranges(ranges: torch.Tensor, code: torch.Tensor) -> torch.Tensor:
    if ranges.shape[0] == 0:
        return torch.zeros_like(code, dtype=torch.bool)
    i = torch.searchsorted(ranges[:, 1].contiguous(), code)
    at = torch.clamp(i, max=ranges.shape[0] - 1)
    return (i < ranges.shape[0]) & (ranges[at, 0] <= code)


def case_map_plain(chars: torch.Tensor, offsets: torch.Tensor,
                   lower: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """``(chars, int64 offsets)`` of every row of a string column mapped
    to upper (or lower) case, as ``csrc/strings.cu`` maps it: the plane's
    units (a valid UTF-8 sequence, else one byte) found in parallel, each
    looked up in the case table with ``torch.searchsorted``, Final_Sigma
    from the nearest units that are not case-ignorable in the same row."""
    device = chars.device
    off = offsets.to(torch.int64)
    rows = off.shape[0] - 1
    total = int(off[-1]) if rows else 0
    table = device_case_table(lower, device)
    cps, moff, mbytes, cased, ign = (t.to(torch.int64)
                                     if t.dtype == torch.int32 else t
                                     for t in table.planes)
    b = chars[:total].to(torch.int64)
    at = torch.arange(total, device=device)
    row_of = torch.searchsorted(off[1:], at, right=True)
    end = off[row_of + 1] if total else at
    n_bytes = torch.where(b < 0x80, 1, torch.where(
        b >= 0xF8, 0, torch.where(b >= 0xF0, 4, torch.where(
            b >= 0xE0, 3, torch.where(b >= 0xC0, 2, 0)))))
    pad = torch.cat([b, b.new_zeros(3)])
    nxt = [pad[k:k + total] for k in (1, 2, 3)]
    cp = torch.where(n_bytes == 2, b & 0x1F,
                     torch.where(n_bytes == 3, b & 0x0F, b & 0x07))
    ok = (n_bytes >= 2) & (at + n_bytes <= end)
    for k in (1, 2, 3):
        need = n_bytes > k
        ok &= ~need | ((nxt[k - 1] & 0xC0) == 0x80)
        cp = torch.where(need, (cp << 6) | (nxt[k - 1] & 0x3F), cp)
    ok &= torch.where(n_bytes == 2, cp >= 0x80, torch.where(
        n_bytes == 3, (cp >= 0x800) & ((cp < 0xD800) | (cp > 0xDFFF)),
        (cp >= 0x10000) & (cp <= 0x10FFFF)))
    width = torch.where(ok, n_bytes, 1)
    covered = torch.zeros(total, dtype=torch.bool, device=device)
    for k in (1, 2, 3):
        if total > k:
            covered[k:] |= ok[:-k] & (width[:-k] > k)
    units = torch.nonzero(~covered).reshape(-1)
    code = torch.where(b < 0x80, b, torch.where(ok, cp, -1))[units]
    ulen = width[units]
    urow = row_of[units]
    idx = torch.searchsorted(cps, code)
    k = torch.clamp(idx, max=max(cps.shape[0] - 1, 0))
    found = (idx < cps.shape[0]) & (cps[k] == code) if cps.shape[0] else \
        torch.zeros_like(code, dtype=torch.bool)
    final = torch.zeros_like(found)
    if lower and bool((code == _CAPITAL_SIGMA).any()):
        n_units = code.shape[0]
        stop = ~_in_ranges(ign, code)
        is_cased = _in_ranges(cased, code)
        j = torch.arange(n_units, device=device)
        before = torch.cummax(torch.where(stop, j, -1), 0).values
        before = torch.cat([before.new_full((1,), -1), before[:-1]])
        after = torch.flip(torch.cummin(torch.flip(
            torch.where(stop, j, n_units), [0]), 0).values, [0])
        after = torch.cat([after[1:], after.new_full((1,), n_units)])
        bi = torch.clamp(before, min=0)
        ai = torch.clamp(after, max=n_units - 1)
        cased_before = (before >= 0) & (urow[bi] == urow) & is_cased[bi]
        cased_after = (after < n_units) & (urow[ai] == urow) & is_cased[ai]
        final = (code == _CAPITAL_SIGMA) & cased_before & ~cased_after
    out_len = torch.where(found, moff[k + 1] - moff[k], ulen)
    row_len = torch.zeros(rows, dtype=torch.int64, device=device)
    row_len.index_add_(0, urow, out_len)
    new_off = torch.zeros(rows + 1, dtype=torch.int64, device=device)
    torch.cumsum(row_len, 0, out=new_off[1:])
    n_out = int(out_len.sum())
    unit = torch.repeat_interleave(torch.arange(units.shape[0],
                                                device=device), out_len,
                                   output_size=n_out)
    j = torch.arange(n_out, device=device) - \
        (torch.cumsum(out_len, 0) - out_len)[unit]
    sigma = torch.tensor(list(_FINAL_SIGMA), dtype=torch.uint8,
                         device=device)
    from_table = mbytes[torch.clamp(moff[k[unit]] + j,
                                    max=max(mbytes.shape[0] - 1, 0))] \
        if mbytes.shape[0] else chars.new_zeros(n_out)
    original = chars[torch.clamp(units[unit] + j, max=max(total - 1, 0))] \
        if total else chars.new_zeros(n_out)
    out = torch.where(found[unit], from_table, original)
    out = torch.where(final[unit], sigma[torch.clamp(j, max=1)], out)
    return out, new_off


def compute_plain(op: int, parts: Sequence, n: int, device, read_total,
                  pos: int = 1, length: Optional[int] = None,
                  rows: Optional[torch.Tensor] = None):
    """``(chars, int64 offsets, validity)`` of K13's output over raw parts
    (each a ``(chars, offsets, validity)`` triple of tensors, a literal's
    bytes or None): each (row, part) piece's length and source in the
    parts' chars laid end to end, the offsets, then one gather of the
    bytes; ``read_total`` brings the chars total to the host.  A case map
    maps the whole column first (``case_map_plain``)."""
    valid = torch.ones(n, dtype=torch.bool, device=device)
    buffers, srcs, lens = [], [], []
    base = 0
    for p in parts:
        if isinstance(p, tuple):
            chars, offsets, pvalid = p
            if op in (UPPER, LOWER):
                chars, offsets = case_map_plain(chars, offsets, op == LOWER)
            off = offsets.to(torch.int64)
            first = off[:-1] if rows is None else off[rows]
            last = off[1:] if rows is None else off[rows + 1]
            valid = valid & (pvalid if rows is None else pvalid[rows])
            start, ln = first, last - first
            if op == SUBSTRING:
                start, ln = substring_range(chars, first, last, pos, length)
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
