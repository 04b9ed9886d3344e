"""Session configuration: a small string-valued conf, as ``TpuConf`` takes
(``spark_rapids_tpu/config.py``).  The conf refuses every key it does not
know, so a setting meant for the JAX package is never silently ignored.

The keys it knows, with the JAX package's defaults:

- the four ``spark.rapids.sql.encoding.*`` keys (``config.py:931-968``):
  parquet scans keep string columns' dictionary pages encoded, a filter
  evaluates its conjuncts over one such column in code space, and values
  are decoded (kernel K16) only where an operator needs them;
  ``lateMaterialization`` false decodes right above every scan; a
  dictionary of more than ``maxDictionarySize`` values is uploaded plain;
  ``rle.enabled`` ships fixed-width columns of few runs as runs;
- the file readers' keys ``session.py:210-215 _common`` reads: the
  parquet reader strategy, the rows of one batch and the threads of the
  MULTITHREADED pool;
- the memory runtime's startup keys (``config.py:208-225``, ``:458``,
  ``:971``): the device pool as ``allocFraction`` of the card or, where
  ``spark.rapids.tpu.memory.pool.size`` is not 0, that many bytes; the
  host tier's bytes before the disk tier; the disk tier's directory
  (empty: the system's temporary directory) and its codec (``none`` or
  ``lz4``; the JAX package's ``zlib`` is its shuffle frame's, which the
  port does not have, and is refused by name);
- the out-of-core test keys (``:296-320``), which force the external
  sort, the running window's carry and the chunked bounded window
  whatever the pool holds, and the widest preceding + following ROWS
  span the chunked bounded window carries between chunks.

Sizes take a plain byte count or a ``k``, ``m``, ``g`` or ``t`` suffix
(``128m``), as the JAX package's ``conf_bytes`` does."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

ENCODING_ENABLED = "spark.rapids.sql.encoding.enabled"
ENCODING_LATE_MAT = "spark.rapids.sql.encoding.lateMaterialization"
ENCODING_MAX_DICT_SIZE = "spark.rapids.sql.encoding.maxDictionarySize"
ENCODING_RLE_ENABLED = "spark.rapids.sql.encoding.rle.enabled"
READER_TYPE = "spark.rapids.sql.format.parquet.reader.type"
MAX_READER_BATCH_SIZE_ROWS = "spark.rapids.sql.reader.batchSizeRows"
MULTITHREADED_READ_NUM_THREADS = \
    "spark.rapids.sql.multiThreadedRead.numThreads"
DEVICE_POOL_FRACTION = "spark.rapids.memory.gpu.allocFraction"
DEVICE_POOL_SIZE = "spark.rapids.tpu.memory.pool.size"
HOST_SPILL_STORAGE_SIZE = "spark.rapids.memory.host.spillStorageSize"
SPILL_DIR = "spark.rapids.tpu.spill.dir"
SPILL_CODEC = "spark.rapids.memory.spill.codec"
FORCE_OOC_SORT = "spark.rapids.sql.test.sort.forceOutOfCore"
FORCE_RUNNING_WINDOW = "spark.rapids.sql.test.window.forceRunning"
FORCE_BOUNDED_WINDOW = "spark.rapids.sql.test.window.forceBoundedBatched"
BOUNDED_WINDOW_MAX_SPAN = "spark.rapids.sql.window.batched.bounded.rowLimit"
#: the keys the memory runtime is shaped by once a process (the JAX
#: package's STARTUP keys, ``memory/device_manager.py:86-89``)
STARTUP_KEYS = (DEVICE_POOL_SIZE, DEVICE_POOL_FRACTION,
                HOST_SPILL_STORAGE_SIZE, SPILL_DIR, SPILL_CODEC)
#: the codecs of the disk tier's Arrow IPC files
SPILL_CODECS = ("none", "lz4")
_SIZE_SUFFIX = {"k": 1 << 10, "m": 1 << 20, "g": 1 << 30, "t": 1 << 40}

_DEFAULTS: Dict[str, str] = {
    ENCODING_ENABLED: "true",
    ENCODING_LATE_MAT: "true",
    ENCODING_MAX_DICT_SIZE: str(1 << 16),
    ENCODING_RLE_ENABLED: "false",
    READER_TYPE: "AUTO",
    MAX_READER_BATCH_SIZE_ROWS: str(1 << 20),
    MULTITHREADED_READ_NUM_THREADS: "8",
    DEVICE_POOL_FRACTION: "0.8",
    DEVICE_POOL_SIZE: "0",
    HOST_SPILL_STORAGE_SIZE: str(1 << 30),
    SPILL_DIR: "",
    SPILL_CODEC: "lz4",
    FORCE_OOC_SORT: "false",
    FORCE_RUNNING_WINDOW: "false",
    FORCE_BOUNDED_WINDOW: "false",
    BOUNDED_WINDOW_MAX_SPAN: "4096",
}


def parse_bytes(value: str) -> int:
    """A byte count: digits, or digits and a ``k``/``m``/``g``/``t``
    suffix (``b`` after it allowed)."""
    text = str(value).strip().lower().rstrip("b")
    if text and text[-1] in _SIZE_SUFFIX:
        return int(float(text[:-1]) * _SIZE_SUFFIX[text[-1]])
    return int(text)


class TorchConf:
    """Immutable string-valued settings; unknown keys are refused."""

    def __init__(self, values: Optional[Mapping[str, str]] = None):
        self._values = dict(_DEFAULTS)
        for key, value in (values or {}).items():
            if key not in _DEFAULTS:
                raise KeyError(f"unknown conf key {key!r}; known keys: "
                               f"{sorted(_DEFAULTS)}")
            if isinstance(value, bool):
                value = "true" if value else "false"
            self._values[key] = str(value)
        if self.get_int(ENCODING_MAX_DICT_SIZE) < 1:
            raise ValueError(f"{ENCODING_MAX_DICT_SIZE} must be at least 1")
        codec = self.spill_codec
        if codec == "zlib":
            raise ValueError(
                f"{SPILL_CODEC}=zlib is the JAX package's shuffle frame "
                "codec, which the port does not have; use none or lz4")
        if codec not in SPILL_CODECS:
            raise ValueError(f"{SPILL_CODEC} must be one of {SPILL_CODECS}, "
                             f"got {codec!r}")
        if not 0 < self.get_float(DEVICE_POOL_FRACTION) <= 1:
            raise ValueError(f"{DEVICE_POOL_FRACTION} must lie in (0, 1]")
        if self.get_bytes(DEVICE_POOL_SIZE) < 0 or \
                self.get_bytes(HOST_SPILL_STORAGE_SIZE) < 0:
            raise ValueError("memory sizes must not be negative")

    def get(self, key: str) -> str:
        return self._values[key]

    def get_bool(self, key: str) -> bool:
        value = self._values[key].strip().lower()
        if value not in ("true", "false"):
            raise ValueError(f"{key} is a boolean, got {value!r}")
        return value == "true"

    def get_int(self, key: str) -> int:
        return int(self._values[key])

    def get_float(self, key: str) -> float:
        return float(self._values[key])

    def get_bytes(self, key: str) -> int:
        return parse_bytes(self._values[key])

    @property
    def spill_codec(self) -> str:
        codec = self._values[SPILL_CODEC].strip().lower()
        return "none" if codec == "" else codec
