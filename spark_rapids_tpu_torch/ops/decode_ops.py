"""Decode of encoded columns: kernel K16 (the JAX package's
``encoding.decode`` programs, ``spark_rapids_tpu/columnar/encoding.py:382
materialize``, built at ``:402`` over ``decode_dictionary`` ``:337`` and at
``:416`` over ``decode_rle`` ``:358``).

``decode_dictionary`` gathers a dictionary's values by int32 code, and
``decode_rle`` expands runs to rows.  Null rows (a null code, a code
outside the dictionary, a null value, a null run) come out null with
zeroed data and length 0, the JAX invariant.  On CUDA tensors they launch
``csrc/decode.cu``: one pass for fixed-width values; for strings a sizes
pass and the scan of the lengths into offsets (one call), one read of the
chars total through ``TransferGateway.read_counts``, then the write pass;
a binary search a row over the run ends for RLE.  On CPU tensors they run
the plain versions, which compute the same planes with torch indexing.
The JAX programs gather padded planes (``jnp.take``); the port sizes the
output exactly."""

from __future__ import annotations

from typing import Optional

import torch

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.column import DeviceColumn

#: launches of K16 (wrapper calls that launch it): its dictionary forms
#: (fixed-width and strings) and its RLE form
DICT_LAUNCHES = 0
RLE_LAUNCHES = 0

#: values one scan tile covers (csrc/common.cuh kScanTile)
SCAN_TILE = 1024

_SIGNATURES = {
    "srt_decode_fixed": "ppqppqippp",
    "srt_decode_sizes": "ppqpipqpppp",
    "srt_decode_chars": "pqpippppp",
    "srt_decode_rle": "pppqiqppp",
}


def load_library():
    """Builds (first call) and binds ``csrc/decode.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("encoding.decode", "csrc/decode.cu",
                        lambda: load_cuda("decode.cu", _SIGNATURES))


def _width(dtype: T.DataType) -> int:
    if dtype.torch_dtype is None:
        raise NotImplementedError(f"K16 has no form for {dtype} values")
    return torch.empty(0, dtype=dtype.torch_dtype).element_size()


def _check_codes(codes: torch.Tensor, valid: Optional[torch.Tensor],
                 device: torch.device) -> int:
    if codes.dtype != torch.int32 or codes.dim() != 1:
        raise TypeError("K16's codes are a 1-D int32 tensor")
    n = codes.shape[0]
    if valid is not None and (valid.dtype != torch.bool or
                              tuple(valid.shape) != (n,)):
        raise TypeError("K16's code validity is a bool tensor of one flag "
                        "a row")
    for t in (codes, valid):
        if t is not None and t.device != device:
            raise ValueError("K16's codes and values lie on different "
                             "devices")
    return n


def decode_dictionary(codes: torch.Tensor, valid: Optional[torch.Tensor],
                      values: DeviceColumn, transfers) -> DeviceColumn:
    """K16's dictionary wrapper: row ``i`` is ``values[codes[i]]``, null
    where ``valid`` (None: every code present) is false or the value is
    null."""
    device = values.device
    n = _check_codes(codes, valid, device)
    if device.type == "cpu":
        return decode_dictionary_plain(codes, valid, values, transfers)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_library()
    global DICT_LAUNCHES
    codes = codes.contiguous()
    vmask = None if valid is None else valid.contiguous()
    vvalid = None if values.all_valid else values.validity.contiguous()
    nv = values.row_count
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        out_valid = torch.empty(n, dtype=torch.bool, device=device)
        args = (codes.data_ptr(), None if vmask is None else vmask.data_ptr())
        vv = None if vvalid is None else vvalid.data_ptr()
        if not values.is_string:
            vdata = values.data.contiguous()
            out = torch.empty(n, dtype=vdata.dtype, device=device)
            if n:
                check_launch(lib.srt_decode_fixed(
                    *args, n, vdata.data_ptr(), vv, nv,
                    _width(values.data_type), out.data_ptr(),
                    out_valid.data_ptr(), stream), "K16 fixed")
                DICT_LAUNCHES += 1
            return DeviceColumn(out, out_valid, values.data_type)
        voff = values.offsets.contiguous()
        off64 = int(voff.dtype == torch.int64)
        vchars = values.data.contiguous()
        out_off = torch.empty(n + 1, dtype=torch.int64, device=device)
        scratch = torch.empty(max(1, -(-n // SCAN_TILE)), dtype=torch.int64,
                              device=device)
        if not n:
            out_off.zero_()
            return DeviceColumn(torch.empty(0, dtype=torch.uint8,
                                            device=device), out_valid,
                                T.STRING, offsets=out_off)
        check_launch(lib.srt_decode_sizes(
            *args, n, voff.data_ptr(), off64, vv, nv, out_off.data_ptr(),
            out_valid.data_ptr(), scratch.data_ptr(), stream), "K16 sizes")
        total, = transfers.read_counts([out_off[n]])
        out_chars = torch.empty(total, dtype=torch.uint8, device=device)
        if total:
            check_launch(lib.srt_decode_chars(
                codes.data_ptr(), n, voff.data_ptr(), off64,
                vchars.data_ptr(), out_valid.data_ptr(), out_off.data_ptr(),
                out_chars.data_ptr(), stream), "K16 chars")
        DICT_LAUNCHES += 1
    return DeviceColumn(out_chars, out_valid, T.STRING, offsets=out_off)


def _present(codes: torch.Tensor, valid: Optional[torch.Tensor],
             values: DeviceColumn):
    """``(safe code, row present)`` of each row: a code outside the
    dictionary or a null value is a null row."""
    nv = values.row_count
    ok = (codes >= 0) & (codes < nv)
    if valid is not None:
        ok = ok & valid
    safe = torch.where(ok, codes, 0).to(torch.int64)
    if nv:
        ok = ok & values.validity[safe]
    return safe, ok


def decode_dictionary_plain(codes: torch.Tensor,
                            valid: Optional[torch.Tensor],
                            values: DeviceColumn, transfers) -> DeviceColumn:
    """The plain PyTorch version of K16's dictionary forms (a string's
    chars total is read through the gateway, as the kernel reads it)."""
    n = _check_codes(codes, valid, values.device)
    device = values.device
    safe, ok = _present(codes, valid, values)
    if not values.is_string:
        if values.row_count:
            data = torch.where(ok, values.data[safe],
                               torch.zeros((), dtype=values.data.dtype,
                                           device=device))
        else:
            data = torch.zeros(n, dtype=values.data.dtype, device=device)
        return DeviceColumn(data, ok, values.data_type)
    voff = values.offsets.to(torch.int64)
    if values.row_count:
        first = voff[safe]
        lens = torch.where(ok, voff[safe + 1] - first, 0)
    else:
        first = lens = torch.zeros(n, dtype=torch.int64, device=device)
    offsets = torch.zeros(n + 1, dtype=torch.int64, device=device)
    torch.cumsum(lens, 0, out=offsets[1:])
    if not n:
        return DeviceColumn(torch.empty(0, dtype=torch.uint8, device=device),
                            ok, T.STRING, offsets=offsets)
    total, = transfers.read_counts([offsets[n]])
    at = torch.repeat_interleave(first - offsets[:-1], lens,
                                 output_size=total) + \
        torch.arange(total, dtype=torch.int64, device=device)
    return DeviceColumn(values.data[at], ok, T.STRING, offsets=offsets)


def _check_runs(run_values, run_valid, run_ends, n: int, dtype) -> None:
    r = run_values.shape[0]
    if run_values.dim() != 1 or run_values.dtype != dtype.torch_dtype:
        raise TypeError(f"K16's runs of {dtype} are a 1-D "
                        f"{dtype.torch_dtype} tensor")
    if run_ends.dtype != torch.int32 or tuple(run_ends.shape) != (r,):
        raise TypeError("K16's run ends are int32, one a run")
    if run_valid is not None and (run_valid.dtype != torch.bool or
                                  tuple(run_valid.shape) != (r,)):
        raise TypeError("K16's run validity is a bool tensor of one flag "
                        "a run")
    if n >= 2 ** 31:
        raise NotImplementedError("RLE over 2**31 rows is not in the port")


def decode_rle(run_values: torch.Tensor, run_valid: Optional[torch.Tensor],
               run_ends: torch.Tensor, n: int, dtype: T.DataType
               ) -> DeviceColumn:
    """K16's RLE wrapper: ``n`` rows, row ``i`` the value of the first
    run whose exclusive end exceeds ``i`` (None validity: every run
    present); rows past the last end are null."""
    _check_runs(run_values, run_valid, run_ends, n, dtype)
    device = run_values.device
    if device.type == "cpu":
        return decode_rle_plain(run_values, run_valid, run_ends, n, dtype)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_library()
    vals = run_values.contiguous()
    rvalid = None if run_valid is None else run_valid.contiguous()
    ends = run_ends.contiguous()
    with torch.cuda.device(device):
        out = torch.empty(n, dtype=vals.dtype, device=device)
        out_valid = torch.empty(n, dtype=torch.bool, device=device)
        if n:
            check_launch(lib.srt_decode_rle(
                vals.data_ptr(),
                None if rvalid is None else rvalid.data_ptr(),
                ends.data_ptr(), vals.shape[0], _width(dtype), n,
                out.data_ptr(), out_valid.data_ptr(),
                torch.cuda.current_stream(device).cuda_stream), "K16 rle")
            global RLE_LAUNCHES
            RLE_LAUNCHES += 1
    return DeviceColumn(out, out_valid, dtype)


def decode_rle_plain(run_values: torch.Tensor,
                     run_valid: Optional[torch.Tensor],
                     run_ends: torch.Tensor, n: int, dtype: T.DataType
                     ) -> DeviceColumn:
    """The plain PyTorch version of K16's RLE form."""
    _check_runs(run_values, run_valid, run_ends, n, dtype)
    device = run_values.device
    r = run_values.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=device)
    idx = torch.searchsorted(run_ends, rows, right=True)
    ok = idx < r
    safe = torch.where(ok, idx, 0)
    if r:
        if run_valid is not None:
            ok = ok & run_valid[safe]
        data = torch.where(ok, run_values[safe],
                           torch.zeros((), dtype=run_values.dtype,
                                       device=device))
    else:
        data = torch.zeros(n, dtype=run_values.dtype, device=device)
    return DeviceColumn(data, ok, dtype)
