"""Spillable columnar batches (the analog of ``spark_rapids_tpu/memory/
spillable.py``, ``SpillableColumnarBatch`` ``:25``).

A ``SpillableColumnarBatch`` owns a catalog handle; holding one instead
of a ``ColumnarBatch`` lets the catalog move the data between the tiers
between the attempts of a retry frame."""

from __future__ import annotations

from typing import List, Optional

from spark_rapids_tpu_torch.columnar.batch import (ColumnarBatch,
                                                   HostColumnarBatch)
from spark_rapids_tpu_torch.memory.catalog import (BufferCatalog,
                                                   SpillPriority)


def _default_catalog() -> BufferCatalog:
    from spark_rapids_tpu_torch.memory.device_manager import (get_runtime,
                                                              initialize)
    rt = get_runtime()
    if rt is None:
        rt = initialize()
    return rt.catalog


class SpillableColumnarBatch:
    """``get_batch()`` gives the batch on its device (unspilling it where it
    went down a tier), ``close()`` releases it."""

    def __init__(self, handle, catalog: BufferCatalog, row_count: int,
                 sized_nbytes: int, priority: int):
        self._handle = handle
        self.catalog = catalog
        self.row_count = row_count
        self.sized_nbytes = sized_nbytes
        self.priority = priority

    @staticmethod
    def from_device(batch: ColumnarBatch,
                    priority: int = SpillPriority.ACTIVE_BATCHING,
                    catalog: Optional[BufferCatalog] = None
                    ) -> "SpillableColumnarBatch":
        cat = catalog or _default_catalog()
        handle = cat.add_device_batch(batch, priority)
        return SpillableColumnarBatch(handle, cat, batch.row_count,
                                      batch.nbytes(), priority)

    @staticmethod
    def from_host(batch: HostColumnarBatch,
                  priority: int = SpillPriority.HOST_MEMORY,
                  catalog: Optional[BufferCatalog] = None, device=None
                  ) -> "SpillableColumnarBatch":
        """A host batch whose device tier is ``device`` (the catalog's by
        default)."""
        cat = catalog or _default_catalog()
        handle = cat.add_host_batch(batch, priority, device)
        return SpillableColumnarBatch(handle, cat, batch.row_count,
                                      batch.nbytes(), priority)

    def get_batch(self) -> ColumnarBatch:
        return self.catalog.get_device_batch(self._handle)

    def get_host_batch(self) -> HostColumnarBatch:
        return self.catalog.get_host_batch(self._handle)

    def release(self) -> ColumnarBatch:
        """The device batch, unregistered: the caller holds it now."""
        batch = self.get_batch()
        self.close()
        return batch

    def make_unspillable(self) -> None:
        """Pinned while it is being computed on."""
        self.catalog.set_spillable(self._handle, False)

    def make_spillable(self) -> None:
        self.catalog.set_spillable(self._handle, True)

    @property
    def device(self):
        """The device ``get_batch`` puts the batch on."""
        return self.catalog.device_of(self._handle)

    @property
    def tier(self):
        return self.catalog.tier_of(self._handle)

    @property
    def closed(self) -> bool:
        return self._handle.closed

    def close(self) -> None:
        if not self._handle.closed:
            self.catalog.remove(self._handle)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return (f"SpillableColumnarBatch(rows={self.row_count}, "
                f"bytes={self.sized_nbytes}, closed={self.closed})")


def spillable_pieces(batches: List[ColumnarBatch], transfers
                     ) -> List[SpillableColumnarBatch]:
    """The batches registered with the runtime's catalog, each cut into
    row pieces of at most a quarter of the pool's free bytes, so every
    piece can be admitted (the catalog spills earlier pieces to the host
    to make room): an out-of-core path's input.  The list is emptied as
    the batches are registered, so the catalog holds them from then on.
    A piece is a view of its batch's fixed-width planes: the card frees a
    batch once every piece of it has spilled and nothing else holds it."""
    from spark_rapids_tpu_torch.memory.device_manager import \
        free_device_headroom
    from spark_rapids_tpu_torch.ops.batch_ops import row_pieces
    limit = free_device_headroom(4)
    out = []
    batches.reverse()
    while batches:
        b = batches.pop()
        pieces = [b] if not limit else row_pieces(b, limit, transfers)
        del b
        while pieces:
            out.append(SpillableColumnarBatch.from_device(pieces.pop(0)))
    return out
