"""Multi-file reader strategies shared by the file scans (the analog of
``spark_rapids_tpu/io/multifile.py``), host side, and the device scan
that uploads what they read.

Strategies, chosen by ``spark.rapids.sql.format.parquet.reader.type``:

- PERFILE: one partition per file, read lazily;
- COALESCING: consecutive files bin-packed up to ``coalesce_target_bytes``
  into one partition, their batches stitched up to ``batch_rows`` rows or
  ``batch_bytes`` bytes (``_stitch``, ``:274``);
- MULTITHREADED: a partition's files read ahead on a shared thread pool
  (``:81``), yielded in file order;
- AUTO: MULTITHREADED for cloud paths, COALESCING for several local
  files, PERFILE for one.

``enable_scan_cache`` (``:53``) keeps what a scan read, keyed by the
files and their modification times, the columns, the pushed-down
predicate, the partition's file group, the tier (host batches, or device
batches on one device) and the encoding settings (``:208-227``), so a
repeated query over static files finds its uploaded batches resident.
``TorchFileScanExec`` is the device scan (``_TpuFileScanMixin``,
``:303``): it uploads each host batch through the session's
``TransferGateway``, with the session's encoding settings."""

from __future__ import annotations

import concurrent.futures
import glob as _glob
import os
import threading
from typing import Iterator, List, Optional, Sequence

from spark_rapids_tpu_torch import types as T
from spark_rapids_tpu_torch.columnar.batch import HostColumnarBatch
from spark_rapids_tpu_torch.plan.base import ExecContext, LeafExec, Partitions

PERFILE = "PERFILE"
COALESCING = "COALESCING"
MULTITHREADED = "MULTITHREADED"
AUTO = "AUTO"

_CLOUD_SCHEMES = ("s3://", "s3a://", "gs://", "abfs://", "abfss://",
                  "wasb://", "http://", "https://")

SCAN_CACHE_ENABLED = False
_SCAN_CACHE: dict = {}
_SCAN_CACHE_LOCK = threading.Lock()


def enable_scan_cache(on: bool = True) -> None:
    """Turns the scan cache on (or off, dropping what it holds)."""
    global SCAN_CACHE_ENABLED
    SCAN_CACHE_ENABLED = on
    if not on:
        with _SCAN_CACHE_LOCK:
            _SCAN_CACHE.clear()


_POOL: Optional[concurrent.futures.ThreadPoolExecutor] = None
_POOL_SIZE = 0
_POOL_LOCK = threading.Lock()


def reader_pool(num_threads: int) -> concurrent.futures.ThreadPoolExecutor:
    """The shared pool of the MULTITHREADED reader, grown to
    ``num_threads`` (a scan still reading keeps the pool it had)."""
    global _POOL, _POOL_SIZE
    with _POOL_LOCK:
        if _POOL is None or _POOL_SIZE < num_threads:
            _POOL = concurrent.futures.ThreadPoolExecutor(
                max_workers=num_threads,
                thread_name_prefix="torch-multifile-read")
            _POOL_SIZE = num_threads
        return _POOL


def is_cloud_path(path: str) -> bool:
    return any(path.startswith(s) for s in _CLOUD_SCHEMES)


def expand_paths(paths: Sequence[str], ext: str) -> List[str]:
    """Directories and globs as a sorted file list; names starting with
    ``.`` or ``_`` (a ``_DONE`` marker) in a directory are skipped."""
    expanded: List[str] = []
    for p in paths:
        if is_cloud_path(p):
            expanded.append(p)
        elif os.path.isdir(p):
            hits = sorted(_glob.glob(os.path.join(p, "**", f"*{ext}"),
                                     recursive=True))
            expanded.extend(h for h in hits
                            if not os.path.basename(h).startswith((".", "_")))
        elif any(ch in p for ch in "*?["):
            expanded.extend(sorted(_glob.glob(p)))
        else:
            if not os.path.exists(p):
                raise FileNotFoundError(f"input path does not exist: {p}")
            expanded.append(p)
    if not expanded:
        raise FileNotFoundError(f"no input files in {list(paths)}")
    return expanded


def host_batch_nbytes(batch: HostColumnarBatch) -> int:
    from spark_rapids_tpu_torch.columnar.encoding import HostDictionaryColumn
    n = 0
    for c in batch.columns:
        if isinstance(c, HostDictionaryColumn):
            n += c.arrow.nbytes
        else:
            n += c.data.nbytes + (0 if c.validity is None
                                  else c.validity.nbytes) + \
                (0 if c.offsets is None else c.offsets.nbytes)
    return n


def concat_host_batches(batches: Sequence[HostColumnarBatch]
                        ) -> HostColumnarBatch:
    """One host batch of several (Arrow unifies the dictionaries of a
    column that every batch keeps encoded; a column encoded in some
    batches and plain in others is decoded)."""
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.batch import batch_from_arrow
    from spark_rapids_tpu_torch.columnar.encoding import HostDictionaryColumn
    batches = list(batches)
    if len(batches) == 1:
        return batches[0]
    names = batches[0].names
    tables = []
    for b in batches:
        arrays = []
        for j, c in enumerate(b.columns):
            encoded = all(isinstance(x.columns[j], HostDictionaryColumn)
                          for x in batches)
            if encoded:
                arrays.append(c.arrow)
            else:
                arrays.append(host_arrow(c))
        tables.append(pa.table(arrays, names=names))
    return batch_from_arrow(pa.concat_tables(tables).combine_chunks())


def host_arrow(col):
    """The plain Arrow array of a host column."""
    import numpy as np
    import pyarrow as pa
    from spark_rapids_tpu_torch.columnar.encoding import HostDictionaryColumn
    if isinstance(col, HostDictionaryColumn):
        return col.arrow.dictionary_decode()
    if col.offsets is not None:
        typ = pa.string() if col.offsets.dtype == np.int32 \
            else pa.large_string()
        bitmap = None if col.validity is None else \
            pa.array(col.validity).buffers()[1]
        return pa.Array.from_buffers(typ, len(col), [
            bitmap, pa.py_buffer(col.offsets), pa.py_buffer(col.data)])
    mask = None if col.validity is None else ~col.validity
    if isinstance(col.data_type, T.DecimalType):
        # (lo, hi) little-endian 16-byte words: exact, never a float
        d = col.data
        words = np.stack([d, d >> 63], 1) if d.ndim == 1 else d[:, ::-1]
        bitmap = None if col.validity is None else \
            pa.array(col.validity).buffers()[1]
        return pa.Array.from_buffers(
            T.to_arrow(col.data_type), len(col),
            [bitmap, pa.py_buffer(np.ascontiguousarray(words))])
    if isinstance(col.data_type, T.DateType):
        return pa.array(col.data, type=pa.int32(), mask=mask).cast(
            pa.date32())
    return pa.array(col.data, type=T.to_arrow(col.data_type), mask=mask)


class MultiFileScanBase:
    """A file-format scan on the host: path expansion, the reader
    strategy's partitions, stitching and the host tier of the scan cache.
    A format provides ``read_file(path)`` and ``infer_schema()``."""

    format_name = "file"
    file_ext = ""

    def __init__(self, paths: Sequence[str], reader_type: str = AUTO,
                 batch_rows: int = 1 << 20, batch_bytes: int = 512 << 20,
                 coalesce_target_bytes: int = 128 << 20,
                 num_threads: int = 8):
        self.paths = expand_paths(paths, self.file_ext)
        self.reader_type = reader_type.upper()
        if self.reader_type not in (PERFILE, COALESCING, MULTITHREADED,
                                    AUTO):
            raise ValueError(f"unknown reader type {reader_type!r}")
        self.batch_rows = int(batch_rows)
        self.batch_bytes = int(batch_bytes)
        self.coalesce_target_bytes = int(coalesce_target_bytes)
        self.num_threads = int(num_threads)
        self._schema: Optional[T.StructType] = None
        self._partitions: Optional[List[List[str]]] = None

    def read_file(self, path: str) -> Iterator[HostColumnarBatch]:
        raise NotImplementedError

    def infer_schema(self) -> T.StructType:
        raise NotImplementedError

    @property
    def schema(self) -> T.StructType:
        if self._schema is None:
            self._schema = self.infer_schema()
        return self._schema

    def effective_type(self) -> str:
        if self.reader_type != AUTO:
            return self.reader_type
        if any(is_cloud_path(p) for p in self.paths):
            return MULTITHREADED
        return COALESCING if len(self.paths) > 1 else PERFILE

    def _file_size(self, path: str) -> int:
        try:
            return os.path.getsize(path)
        except OSError:
            return self.coalesce_target_bytes

    def plan_partitions(self) -> List[List[str]]:
        """The files of each partition (``_plan_partitions``, ``:175``)."""
        if self._partitions is not None:
            return self._partitions
        if self.effective_type() == PERFILE:
            parts = [[p] for p in self.paths]
        else:
            parts, cur, cur_bytes = [], [], 0
            for p in self.paths:
                sz = self._file_size(p)
                if cur and cur_bytes + sz > self.coalesce_target_bytes:
                    parts.append(cur)
                    cur, cur_bytes = [], 0
                cur.append(p)
                cur_bytes += sz
            if cur:
                parts.append(cur)
        self._partitions = parts
        return parts

    @property
    def num_partitions(self) -> int:
        return len(self.plan_partitions())

    def cache_key(self, pidx: int, tier, encoding) -> tuple:
        files = tuple((p, os.path.getmtime(p) if os.path.exists(p) else 0)
                      for p in self.paths)
        pred = getattr(self, "predicate", None)
        return (self.format_name, files,
                tuple(getattr(self, "columns", None) or ()),
                None if pred is None else pred.sql(),
                tuple(self.plan_partitions()[pidx]), tier, encoding)

    def execute_partition(self, pidx: int, encoding=None
                          ) -> Iterator[HostColumnarBatch]:
        """The host batches of partition ``pidx`` (``encoding``, the
        session's settings, keys the host tier of the scan cache)."""
        if SCAN_CACHE_ENABLED:
            key = self.cache_key(pidx, "host", encoding)
            with _SCAN_CACHE_LOCK:
                cached = _SCAN_CACHE.get(key)
            if cached is None:
                cached = list(self._scan_partition(pidx, encoding))
                with _SCAN_CACHE_LOCK:
                    _SCAN_CACHE[key] = cached
            yield from cached
            return
        yield from self._scan_partition(pidx, encoding)

    def _scan_partition(self, pidx: int, encoding):
        files = self.plan_partitions()[pidx]
        eff = self.effective_type()
        if eff == MULTITHREADED:
            it = self._read_pipelined(files, encoding)
        else:
            it = (b for p in files for b in self.read_file(p, encoding))
        if eff in (COALESCING, MULTITHREADED) and len(files) > 1:
            yield from self._stitch(it)
        else:
            yield from it

    def _read_pipelined(self, files, encoding):
        """Background reads with a bounded lookahead, in file order."""
        pool = reader_pool(self.num_threads)
        ahead = max(1, min(self.num_threads, len(files)))
        futures = {}
        for i in range(min(ahead, len(files))):
            futures[i] = pool.submit(
                lambda p=files[i]: list(self.read_file(p, encoding)))
        for i in range(len(files)):
            batches = futures.pop(i).result()
            j = i + ahead
            if j < len(files):
                futures[j] = pool.submit(
                    lambda p=files[j]: list(self.read_file(p, encoding)))
            yield from batches

    def _stitch(self, batches):
        """Small batches joined up to the row and byte targets
        (COALESCING)."""
        pending: List[HostColumnarBatch] = []
        rows = nbytes = 0
        for b in batches:
            if b.row_count == 0:
                continue
            pending.append(b)
            rows += b.row_count
            nbytes += host_batch_nbytes(b)
            if rows >= self.batch_rows or nbytes >= self.batch_bytes:
                yield concat_host_batches(pending)
                pending, rows, nbytes = [], 0, 0
        if pending:
            yield concat_host_batches(pending)

    def node_desc(self) -> str:
        base = os.path.basename(self.paths[0])
        extra = f"+{len(self.paths) - 1}" if len(self.paths) > 1 else ""
        return (f"{self.format_name.capitalize()}Scan[{base}{extra}]"
                f"({self.effective_type().lower()})")


class TorchFileScanExec(LeafExec):
    """The device scan of a host file scan: each partition's host batches
    uploaded through the gateway with the session's encoding settings
    (``columnar/encoding.py EncodingSettings``); with the scan cache on,
    the uploaded batches stay resident, keyed by device."""

    def __init__(self, scan: MultiFileScanBase, encoding):
        super().__init__()
        self.scan = scan
        self.encoding = encoding

    @property
    def schema(self):
        return self.scan.schema

    @property
    def num_partitions(self):
        return self.scan.num_partitions

    def node_string(self):
        return f"Torch{self.scan.node_desc()}"

    def _upload(self, pidx: int, ctx: ExecContext):
        from spark_rapids_tpu_torch.columnar.batch import ColumnarBatch
        names = self.schema.names
        out = []
        for hb in self.scan.execute_partition(pidx, self.encoding):
            b = ctx.transfers.upload_batch(hb, self.encoding)
            out.append(ColumnarBatch(b.columns, b.row_count, names))
        return out

    def execute(self, ctx: ExecContext) -> Partitions:
        out = []
        for pidx in range(self.num_partitions):
            if SCAN_CACHE_ENABLED:
                key = self.scan.cache_key(pidx, ("device", str(ctx.device)),
                                          self.encoding)
                with _SCAN_CACHE_LOCK:
                    cached = _SCAN_CACHE.get(key)
                if cached is None:
                    cached = self._upload(pidx, ctx)
                    with _SCAN_CACHE_LOCK:
                        _SCAN_CACHE[key] = cached
                out.append(list(cached))
            else:
                out.append(self._upload(pidx, ctx))
        return out
