"""The finish of a decimal ``avg`` (``csrc/decimal.cu``): one kernel over
the buffer rows of a group-by or a global aggregate.

The JAX package finishes a decimal average as a double divide cast back
to decimal (``expressions/aggregates.py:182-190``), which its faulty cast
makes 10^4 too small (ROADMAP queue 3).  Spark's rule
(``expressions/aggregates.py avg_types``): the quotient ``sum /
count`` rounded HALF_UP at the scale of ``Divide(sum, cast(count as
decimal(20,0)))`` (decimal(38,23) for a decimal(7,2) input), then cast
to the result type (decimal(11,6)), HALF_UP again; NULL for a count of
0 or a null sum, and past either precision.  (Spark divides at scale 38
first, then rounds to the quotient's scale; the two agree unless a
count passes 10^15.)

``avg_finish`` is the kernel's wrapper: on CUDA tensors it launches
``srt_decimal_avg`` (a thread a row, ``unsigned __int128``: the sum
times 10^21 is below 10^38); Triton has no 128-bit integer, so this
part is CUDA C++.  ``avg_finish_plain`` does the same over Python ints.

Bound: by device memory bytes (the sum, count and validity read once,
the result written once); its 128-bit divisions by the count are a few
hundred instructions a row, far below the card's rate at the group
counts of the main path (thousands of rows)."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T

#: launches of the decimal avg finish (wrapper calls that launch it)
AVG_LAUNCHES = 0


def load_library():
    """Builds (first call) and binds ``csrc/decimal.cu``."""
    from spark_rapids_tpu_torch.exec.stage_compiler import get_or_build
    from spark_rapids_tpu_torch.kernels.build import load_cuda
    return get_or_build("decimal.avg", "csrc/decimal.cu",
                        lambda: load_cuda("decimal.cu",
                                          {"srt_decimal_avg":
                                           "pipppqiiiiipp" + "p"}))


def avg_shape(input_type: T.DecimalType) -> Tuple[int, int, T.DataType,
                                                   T.DataType, T.DataType]:
    """``(up, down, sum, quotient, result)``: the sum is raised ``up``
    digits before the count divides it, the quotient lowered ``down``
    digits to the result's scale.  Refuses by name what this finish
    does not compute (no decimal(p, s) with p up to 27 does that)."""
    from spark_rapids_tpu_torch.expressions.aggregates import avg_types
    total, mid, out = avg_types(input_type)
    up, down = mid.scale - total.scale, mid.scale - out.scale
    if up < 0 or down < 0 or total.precision + up > T.DecimalType.MAX_PRECISION:
        raise NotImplementedError(f"avg of {input_type}: its finish is not "
                                  "in the port")
    return up, down, total, mid, out


def _check(sdata, svalid, cdata, cvalid) -> None:
    n = sdata.shape[0]
    if cdata.dtype != torch.int64 or cdata.shape != (n,) or \
            svalid.shape != (n,) or cvalid.shape != (n,):
        raise ValueError("a sum, a count and their validity of one length")
    if not (sdata.device == svalid.device == cdata.device == cvalid.device):
        raise ValueError("the avg finish's inputs lie on different devices")


def avg_finish(sdata: torch.Tensor, svalid: torch.Tensor,
               cdata: torch.Tensor, cvalid: torch.Tensor,
               input_type: T.DecimalType
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's wrapper: ``(data, valid)`` of the averages."""
    _check(sdata, svalid, cdata, cvalid)
    up, down, total, mid, out = avg_shape(input_type)
    device = sdata.device
    if device.type == "cpu":
        return avg_finish_plain(sdata, svalid, cdata, cvalid, input_type)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    n = sdata.shape[0]
    data = torch.empty((n, 2) if out.is_decimal128 else n,
                       dtype=torch.int64, device=device)
    valid = torch.empty(n, dtype=torch.bool, device=device)
    if n == 0:
        return data, valid
    from spark_rapids_tpu_torch.kernels.build import check_launch
    lib = load_library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        # held by name until the launch is queued
        s = sdata.contiguous()
        sv = svalid.contiguous().view(torch.uint8)
        c = cdata.contiguous()
        cv = cvalid.contiguous().view(torch.uint8)
        check_launch(lib.srt_decimal_avg(
            s.data_ptr(), int(total.is_decimal128), sv.data_ptr(),
            c.data_ptr(), cv.data_ptr(), n, up, down, mid.precision,
            out.precision, int(out.is_decimal128), data.data_ptr(),
            valid.view(torch.uint8).data_ptr(), stream),
            "decimal avg finish")
    global AVG_LAUNCHES
    AVG_LAUNCHES += 1
    return data, valid


def avg_finish_plain(sdata: torch.Tensor, svalid: torch.Tensor,
                     cdata: torch.Tensor, cvalid: torch.Tensor,
                     input_type: T.DecimalType
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: Spark's rule over Python ints."""
    from spark_rapids_tpu_torch.columnar.column import (decimal128_words,
                                                        unscaled_ints)
    _check(sdata, svalid, cdata, cvalid)
    up, down, total, mid, out = avg_shape(input_type)
    sums = unscaled_ints(sdata.cpu().numpy())
    ok_in = (svalid & cvalid).tolist()
    values, oks = [], []
    for s, c, ok in zip(sums, cdata.tolist(), ok_in):
        q = None
        if ok and c > 0:
            num = abs(s) * 10 ** up
            q = (2 * num + c) // (2 * c)
            if q >= 10 ** mid.precision:
                q = None
            else:
                p = 10 ** down
                q = (2 * q + p) // (2 * p)
                q = None if q >= 10 ** out.precision else \
                    (-q if s < 0 else q)
        oks.append(q is not None)
        values.append(0 if q is None else q)
    data = decimal128_words(values) if out.is_decimal128 else \
        np.array(values, dtype=np.int64)
    dev = sdata.device
    return (torch.from_numpy(data).to(dev),
            torch.tensor(oks, dtype=torch.bool, device=dev))
