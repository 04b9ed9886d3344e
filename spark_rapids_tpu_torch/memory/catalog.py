"""The tiered buffer catalog: DEVICE -> HOST -> DISK with spill (the
analog of ``spark_rapids_tpu/memory/catalog.py``, ``BufferCatalog``
``:139``).

As in the JAX package the device tier is an accounting layer over the
batches' tensors: PyTorch's caching allocator owns the card's memory,
and ``reserve`` is the admission point an out-of-core path calls before
it puts ``nbytes`` on the card.  Short of room, it spills the spillable
device buffers of lowest priority first, synchronously; still short, it
raises ``RetryOOM`` at once (the JAX package's behaviour for a thread the
arbiter does not know; the arbiter's parking, ``memory/arbiter.py``, is
not ported).  A device batch goes to the host through the catalog's
``columnar/transfer.py TransferGateway`` (each column copied once, one
sync a batch), so its copies and syncs are counted; dropping the
catalog's reference is what frees the card's memory, once no one else
holds the tensors.  The host tier overflows to the disk tier: one Arrow
IPC file a buffer in the spill directory, written with codec ``none`` or
``lz4``, read back (and deleted) on the first access."""

from __future__ import annotations

import enum
import itertools
import os
import tempfile
import threading
from typing import Dict, Optional

import torch

from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   HostColumnarBatch)
from spark_rapids_tpu_torch.columnar.transfer import TransferGateway
from spark_rapids_tpu_torch.memory.retry import RetryOOM, maybe_inject_oom


class StorageTier(enum.IntEnum):
    DEVICE = 0
    HOST = 1
    DISK = 2


class SpillPriority:
    """Lower value spills first (the JAX package's ``SpillPriority``)."""
    INPUT_FROM_SHUFFLE = -100
    HOST_MEMORY = -50
    ACTIVE_BATCHING = 0
    ACTIVE_ON_DECK = 100


_handle_ids = itertools.count(1)


class BufferHandle:
    """An opaque handle to a catalog buffer."""

    __slots__ = ("id", "priority", "closed")

    def __init__(self, priority: int):
        self.id = next(_handle_ids)
        self.priority = priority
        self.closed = False

    def __repr__(self):
        return f"BufferHandle(id={self.id}, prio={self.priority})"


class _Buffer:
    __slots__ = ("handle", "tier", "device", "device_batch", "host_batch",
                 "disk_path", "device_nbytes", "host_nbytes", "disk_nbytes",
                 "spillable")

    def __init__(self, handle: BufferHandle, device: torch.device):
        self.handle = handle
        self.tier = StorageTier.DEVICE
        #: where the batch lives when it is on its device tier
        self.device = device
        self.device_batch: Optional[ColumnarBatch] = None
        self.host_batch: Optional[HostColumnarBatch] = None
        self.disk_path: Optional[str] = None
        self.device_nbytes = 0
        self.host_nbytes = 0
        self.disk_nbytes = 0
        self.spillable = True


class BufferCatalog:
    """The registry of spillable buffers across the three tiers."""

    def __init__(self, device_limit_bytes: int, host_limit_bytes: int,
                 disk_dir: Optional[str] = None, codec: str = "lz4",
                 device: Optional[torch.device] = None):
        if codec not in ("none", "lz4"):
            raise ValueError(f"spill codec {codec!r}: none or lz4")
        self.device_limit = int(device_limit_bytes)
        self.host_limit = int(host_limit_bytes)
        self._disk_dir = disk_dir or None
        self.codec = codec
        self.device = device if device is not None else torch.device("cpu")
        self._gateways: Dict[str, TransferGateway] = {}
        self._buffers: Dict[int, _Buffer] = {}
        self._lock = threading.RLock()
        self.device_bytes = 0
        self.device_peak_bytes = 0
        self.host_bytes = 0
        self.disk_bytes = 0
        self.disk_logical_bytes = 0
        self.spill_count = 0
        #: bytes moved down each tier and back up, over the catalog's life
        self.spilled = {"device_to_host": 0, "host_to_disk": 0,
                        "device_to_host_bytes": 0, "host_to_disk_bytes": 0,
                        "unspills": 0, "unspill_bytes": 0}

    def gateway(self, device: Optional[torch.device] = None
                ) -> TransferGateway:
        """The counting gateway of ``device`` (the catalog's own by
        default) that spills and unspills go through."""
        dev = self.device if device is None else device
        with self._lock:
            gw = self._gateways.get(str(dev))
            if gw is None:
                gw = self._gateways[str(dev)] = TransferGateway(dev)
            return gw

    def transfer_stats(self) -> Dict[str, int]:
        """The copies and syncs of every spill and unspill."""
        out = dict.fromkeys(("h2d_copies", "h2d_bytes", "d2h_copies",
                             "d2h_bytes", "syncs"), 0)
        with self._lock:
            for gw in self._gateways.values():
                for k, v in gw.stats().items():
                    out[k] += v
        return out

    # -- admission ----------------------------------------------------------
    def reserve(self, nbytes: int) -> None:
        """Admission before ``nbytes`` go on the device: spills the
        spillable device buffers of lowest priority first; raises RetryOOM
        when that is not enough."""
        maybe_inject_oom()
        with self._lock:
            if self.device_bytes + nbytes <= self.device_limit:
                return
            needed = self.device_bytes + nbytes - self.device_limit
            freed = self._spill_device_locked(needed)
            if self.device_bytes + nbytes <= self.device_limit:
                return
            used = self.device_bytes
        raise RetryOOM(f"device pool exhausted: need {nbytes}, used {used}"
                       f"/{self.device_limit}, freed only {freed}")

    # -- registration -------------------------------------------------------
    def add_device_batch(self, batch: ColumnarBatch,
                         priority: int = SpillPriority.ACTIVE_BATCHING,
                         spillable: bool = True) -> BufferHandle:
        nbytes = batch.nbytes()
        self.reserve(nbytes)
        with self._lock:
            handle = BufferHandle(priority)
            buf = _Buffer(handle, batch.device if batch.columns
                          else self.device)
            buf.device_batch = batch
            buf.device_nbytes = nbytes
            buf.spillable = spillable
            self._buffers[handle.id] = buf
            self.device_bytes += nbytes
            self.device_peak_bytes = max(self.device_peak_bytes,
                                         self.device_bytes)
        return handle

    def add_host_batch(self, batch: HostColumnarBatch,
                       priority: int = SpillPriority.HOST_MEMORY,
                       device: Optional[torch.device] = None
                       ) -> BufferHandle:
        """A host batch whose device tier is ``device`` (the catalog's by
        default)."""
        with self._lock:
            handle = BufferHandle(priority)
            buf = _Buffer(handle, self.device if device is None else device)
            buf.host_batch = batch
            buf.host_nbytes = batch.nbytes()
            buf.tier = StorageTier.HOST
            self._buffers[handle.id] = buf
            self.host_bytes += buf.host_nbytes
            self._maybe_spill_host_locked()
            return handle

    # -- retrieval (unspill on demand) --------------------------------------
    def get_device_batch(self, handle: BufferHandle) -> ColumnarBatch:
        with self._lock:
            buf = self._require(handle)
            if buf.tier == StorageTier.DEVICE:
                return buf.device_batch
            host = self._host_batch_locked(buf)
            device = buf.device
        # admission before the upload: the host planes' bytes are the
        # device batch's (a chars plane is uploaded as it is)
        self.reserve(host.nbytes() + host.row_count)
        dev = self.gateway(device).upload_batch(host)
        with self._lock:
            buf = self._buffers.get(handle.id)
            if buf is None:
                raise KeyError(f"unknown or closed buffer handle {handle}")
            if buf.tier != StorageTier.DEVICE:
                nbytes = dev.nbytes()
                buf.device_batch = dev
                buf.device_nbytes = nbytes
                self.device_bytes += nbytes
                self.device_peak_bytes = max(self.device_peak_bytes,
                                             self.device_bytes)
                # one tier at a time: the host copy and its charge go
                if buf.host_batch is not None:
                    self.host_bytes -= buf.host_nbytes
                    buf.host_batch = None
                    buf.host_nbytes = 0
                buf.tier = StorageTier.DEVICE
                self.spilled["unspills"] += 1
                self.spilled["unspill_bytes"] += nbytes
            return buf.device_batch

    def get_host_batch(self, handle: BufferHandle) -> HostColumnarBatch:
        """The batch on the host: a download of a device-tier buffer (which
        stays where it is), else the host tier's (the disk's read back)."""
        with self._lock:
            buf = self._require(handle)
            if buf.tier == StorageTier.DEVICE:
                batch, device = buf.device_batch, buf.device
            else:
                return self._host_batch_locked(buf)
        return self.gateway(device).download_batch(batch)

    def device_of(self, handle: BufferHandle) -> torch.device:
        """The device the buffer lives on at its device tier."""
        with self._lock:
            return self._require(handle).device

    def tier_of(self, handle: BufferHandle) -> StorageTier:
        with self._lock:
            return self._require(handle).tier

    def set_spillable(self, handle: BufferHandle, spillable: bool) -> None:
        with self._lock:
            self._require(handle).spillable = spillable

    def remove(self, handle: BufferHandle) -> None:
        with self._lock:
            buf = self._buffers.pop(handle.id, None)
            handle.closed = True
            if buf is None:
                return
            if buf.device_batch is not None:
                self.device_bytes -= buf.device_nbytes
                buf.device_batch = None
            if buf.host_batch is not None:
                self.host_bytes -= buf.host_nbytes
                buf.host_batch = None
            if buf.disk_path is not None:
                self.disk_bytes -= buf.disk_nbytes
                self.disk_logical_bytes -= buf.host_nbytes
                try:
                    os.unlink(buf.disk_path)
                except OSError:
                    pass

    # -- spilling -----------------------------------------------------------
    def synchronous_spill(self, target_free_bytes: Optional[int]) -> int:
        """Spills device buffers until ``target_free_bytes`` are free (None:
        every spillable one); returns the bytes freed."""
        with self._lock:
            if target_free_bytes is None:
                needed = self.device_bytes
            else:
                free = self.device_limit - self.device_bytes
                needed = max(0, target_free_bytes - free)
            return self._spill_device_locked(needed)

    def _spill_device_locked(self, needed: int) -> int:
        candidates = sorted(
            (b for b in self._buffers.values()
             if b.tier == StorageTier.DEVICE and b.spillable),
            key=lambda b: (b.handle.priority, b.handle.id))
        freed = 0
        for buf in candidates:
            if freed >= needed:
                break
            host = self.gateway(buf.device).download_batch(buf.device_batch)
            self.device_bytes -= buf.device_nbytes
            freed += buf.device_nbytes
            buf.device_batch = None
            buf.device_nbytes = 0
            buf.host_batch = host
            buf.host_nbytes = host.nbytes()
            self.host_bytes += buf.host_nbytes
            buf.tier = StorageTier.HOST
            self.spill_count += 1
            self.spilled["device_to_host"] += 1
            self.spilled["device_to_host_bytes"] += buf.host_nbytes
        self._maybe_spill_host_locked()
        return freed

    def _maybe_spill_host_locked(self) -> None:
        if self.host_bytes <= self.host_limit:
            return
        candidates = sorted(
            (b for b in self._buffers.values()
             if b.tier == StorageTier.HOST and b.spillable),
            key=lambda b: (b.handle.priority, b.handle.id))
        for buf in candidates:
            if self.host_bytes <= self.host_limit:
                break
            self._spill_host_to_disk_locked(buf)

    def _spill_host_to_disk_locked(self, buf: _Buffer) -> None:
        import pyarrow as pa
        d = self._disk_dir or tempfile.gettempdir()
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, f"spill-{os.getpid()}-{buf.handle.id}.arrow")
        table = buf.host_batch.to_arrow()
        options = pa.ipc.IpcWriteOptions(
            compression=None if self.codec == "none" else self.codec)
        with pa.OSFile(path, "wb") as sink, \
                pa.ipc.new_file(sink, table.schema, options=options) as w:
            w.write_table(table)
        self.host_bytes -= buf.host_nbytes
        buf.host_batch = None
        buf.disk_path = path
        buf.disk_nbytes = os.path.getsize(path)
        self.disk_bytes += buf.disk_nbytes
        self.disk_logical_bytes += buf.host_nbytes
        buf.tier = StorageTier.DISK
        self.spill_count += 1
        self.spilled["host_to_disk"] += 1
        self.spilled["host_to_disk_bytes"] += buf.disk_nbytes

    def _host_batch_locked(self, buf: _Buffer) -> HostColumnarBatch:
        if buf.host_batch is not None:
            return buf.host_batch
        if buf.disk_path is None:
            raise RuntimeError(f"buffer {buf.handle} has no backing storage")
        import pyarrow as pa
        from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
        with pa.memory_map(buf.disk_path, "rb") as source:
            table = pa.ipc.open_file(source).read_all()
        host = batch_from_arrow(table)
        buf.host_batch = host
        self.host_bytes += buf.host_nbytes
        self.disk_bytes -= buf.disk_nbytes
        self.disk_logical_bytes -= buf.host_nbytes
        buf.disk_nbytes = 0
        try:
            os.unlink(buf.disk_path)
        except OSError:
            pass
        buf.disk_path = None
        buf.tier = StorageTier.HOST
        return host

    def _require(self, handle: BufferHandle) -> _Buffer:
        buf = self._buffers.get(handle.id)
        if buf is None:
            raise KeyError(f"unknown or closed buffer handle {handle}")
        return buf

    # -- introspection ------------------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            spillable = sum(b.device_nbytes for b in self._buffers.values()
                            if b.tier == StorageTier.DEVICE and b.spillable)
            return {
                "device_bytes": self.device_bytes,
                "device_limit": self.device_limit,
                "device_peak_bytes": self.device_peak_bytes,
                "spillable_bytes": spillable,
                "host_bytes": self.host_bytes,
                "host_limit": self.host_limit,
                "disk_bytes": self.disk_bytes,
                "disk_logical_bytes": self.disk_logical_bytes,
                "buffers": len(self._buffers),
                "spill_count": self.spill_count,
                **self.spilled,
            }

    def close(self) -> None:
        with self._lock:
            for buf in list(self._buffers.values()):
                self.remove(buf.handle)
