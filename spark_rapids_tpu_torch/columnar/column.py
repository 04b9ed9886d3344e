"""Host and device columns (the analog of ``spark_rapids_tpu/columnar/
column.py``).

A device column is a torch data tensor plus a bool validity tensor, both
sized to the exact row count.  The JAX package pads rows to power-of-two
buckets (``bucket_rows``) and defers row counts (``DeferredCount``) because
XLA wants static shapes and a TPU sync is slow; on a CUDA card neither
holds, so neither is carried over."""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from spark_rapids_tpu_torch import types as T


class HostColumn:
    """numpy data plane plus an optional bool validity plane (None: no
    nulls).  Values under a null slot are unspecified."""

    __slots__ = ("data", "validity", "data_type")

    def __init__(self, data: np.ndarray, validity: Optional[np.ndarray],
                 data_type: T.DataType):
        data = np.asarray(data)
        if data.ndim != 1:
            raise ValueError(f"column data must be 1-D, got {data.shape}")
        if data.dtype != data_type.np_dtype:
            data = data.astype(data_type.np_dtype)
        if validity is not None:
            validity = np.asarray(validity, dtype=np.bool_)
            if validity.shape != data.shape:
                raise ValueError(f"validity shape {validity.shape} does not "
                                 f"match data shape {data.shape}")
        self.data = data
        self.validity = validity
        self.data_type = data_type

    def __len__(self) -> int:
        return int(self.data.shape[0])

    def slice(self, start: int, length: int) -> "HostColumn":
        end = start + length
        return HostColumn(self.data[start:end],
                          None if self.validity is None
                          else self.validity[start:end], self.data_type)

    def to_pylist(self) -> List:
        values = self.data.tolist()
        if self.validity is None:
            return values
        return [v if ok else None
                for v, ok in zip(values, self.validity.tolist())]


class DeviceColumn:
    """torch data plane plus a bool validity plane of the same length.
    ``all_valid`` marks a column known to hold no null (its validity plane
    is all true), so a kernel may skip reading the plane."""

    __slots__ = ("data", "validity", "data_type", "all_valid")

    def __init__(self, data: torch.Tensor, validity: torch.Tensor,
                 data_type: T.DataType, all_valid: bool = False):
        if data.dtype != data_type.torch_dtype:
            raise TypeError(f"{data_type} column needs {data_type.torch_dtype}"
                            f" data, got {data.dtype}")
        if validity.dtype != torch.bool or validity.shape != data.shape:
            raise TypeError("validity must be a bool tensor shaped like the "
                            "data")
        self.data = data
        self.validity = validity
        self.data_type = data_type
        self.all_valid = all_valid

    @property
    def row_count(self) -> int:
        return int(self.data.shape[0])

    @property
    def device(self) -> torch.device:
        return self.data.device
