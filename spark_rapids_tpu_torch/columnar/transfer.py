"""Host <-> device copies through one counting gateway (the analog of
``spark_rapids_tpu/columnar/transfer.py`` with the ledger of
``spark_rapids_tpu/aux/transitions.py``).

Every column moves on its own: host planes are staged in pinned memory and
copied with ``non_blocking=True`` on the current stream, and a download
ends in exactly one blocking sync.  A string column moves as its offsets
and chars planes, an encoded column as its codes (or runs) with its
dictionary once a device (``columnar/encoding.py``).  ``read_counts`` is
the one way a size computed on the device reaches the host (a join's pair count, a compaction's survivors, a
gather's chars total, an exchange's histogram): one D2H copy of a few words and one sync, so every
such wait is counted.  The JAX package's one-buffer transfers
(``upload_host_batch`` grouping planes by width into at most four uploads,
``_pack_planes`` packing results and the row count into one uint32 buffer)
work around a slow TPU host link and get no kernel here."""

from __future__ import annotations

import threading
from typing import Dict, List, Sequence, Union

import numpy as np
import torch

from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   HostColumnarBatch)
from spark_rapids_tpu_torch.columnar.column import DeviceColumn, HostColumn


class TransferGateway:
    """Counts every H2D copy, D2H copy and blocking sync of one device.

    On the CPU the copies are plain tensor copies and the sync is a no-op,
    but each still counts, so a test on the host sees the same ledger as a
    run on the card."""

    def __init__(self, device: torch.device):
        self.device = device
        self._lock = threading.Lock()
        self._stats = {"h2d_copies": 0, "h2d_bytes": 0, "d2h_copies": 0,
                       "d2h_bytes": 0, "syncs": 0}

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._stats)

    def _count(self, copies: str, nbytes_key: str, nbytes: int) -> None:
        with self._lock:
            self._stats[copies] += 1
            self._stats[nbytes_key] += int(nbytes)

    def to_device(self, array: np.ndarray) -> torch.Tensor:
        host = torch.from_numpy(np.ascontiguousarray(array))
        self._count("h2d_copies", "h2d_bytes", host.numel() *
                    host.element_size())
        if self.device.type == "cpu":
            return host.clone()
        pinned = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned.copy_(host)
        # the caching host allocator keeps ``pinned`` alive until the copy
        # has run, so it may be dropped here
        return pinned.to(self.device, non_blocking=True)

    def upload_column(self, column: HostColumn, encoding=None
                      ) -> DeviceColumn:
        """One host column on the device.  With ``encoding`` (a session's
        ``columnar/encoding.py EncodingSettings``) a dictionary column
        goes up as its codes (its dictionary once a device) and, with RLE
        on, a column of few runs as runs; a dictionary column that stays
        plain is decoded on the host first."""
        from spark_rapids_tpu_torch.columnar import encoding as ENC
        if encoding is not None:
            encoded = ENC.upload_encoded(column, encoding, self)
            if encoded is not None:
                return encoded
        column = ENC.decoded_host_column(column)
        data = self.to_device(column.data)
        offsets = None if column.offsets is None else \
            self.to_device(column.offsets)
        if column.validity is None:
            validity = torch.ones(len(column), dtype=torch.bool,
                                  device=self.device)
            return DeviceColumn(data, validity, column.data_type,
                                all_valid=True, offsets=offsets)
        return DeviceColumn(data, self.to_device(column.validity),
                            column.data_type, offsets=offsets)

    def upload_batch(self, batch: HostColumnarBatch,
                     encoding=None) -> ColumnarBatch:
        return ColumnarBatch([self.upload_column(c, encoding)
                              for c in batch.columns],
                             batch.row_count, batch.names)

    def _to_host_async(self, tensor: torch.Tensor) -> torch.Tensor:
        self._count("d2h_copies", "d2h_bytes", tensor.numel() *
                    tensor.element_size())
        if tensor.device.type == "cpu":
            return tensor.clone()
        host = torch.empty(tensor.shape, dtype=tensor.dtype, pin_memory=True)
        host.copy_(tensor, non_blocking=True)
        return host

    def sync(self) -> None:
        """The one blocking wait for the device."""
        with self._lock:
            self._stats["syncs"] += 1
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def read_counts(self, counts: Union[torch.Tensor,
                                        Sequence[torch.Tensor]]) -> List[int]:
        """Sizes computed on the device, as host ints: a 1-D integer tensor
        (an exchange's histogram) or a sequence of one-element integer
        tensors; one D2H copy and one sync for all of them."""
        if isinstance(counts, torch.Tensor):
            words = counts.reshape(-1).to(torch.int64)
        else:
            words = torch.stack([c.reshape(()).to(torch.int64)
                                 for c in counts])
        host = self._to_host_async(words)
        self.sync()
        return [int(x) for x in host.tolist()]

    def download_batch(self, batch: ColumnarBatch) -> HostColumnarBatch:
        """Copies every plane to pinned host memory, then syncs once.  A
        dictionary column comes back as its codes and is reassembled
        against its host dictionary, with no decode kernel; runs are
        expanded (K16) first."""
        from spark_rapids_tpu_torch.columnar import encoding as ENC
        batch = ENC.materialize_rle_batch(batch, self)
        planes: List = [(self._to_host_async(c.data),
                         self._to_host_async(c.validity), c.data_type,
                         None if c.offsets is None
                         else self._to_host_async(c.offsets),
                         getattr(c, "dictionary", None))
                        for c in batch.columns]
        self.sync()
        cols = [HostColumn(d.numpy(), v.numpy(), dt,
                           None if o is None else o.numpy())
                if dic is None else ENC.reassemble_host_dictionary(
                    d.numpy(), v.numpy(), dic, dt)
                for d, v, dt, o, dic in planes]
        return HostColumnarBatch(cols, batch.row_count, batch.names)
