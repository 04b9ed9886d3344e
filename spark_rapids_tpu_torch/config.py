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
  MULTITHREADED pool."""

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

_DEFAULTS: Dict[str, str] = {
    ENCODING_ENABLED: "true",
    ENCODING_LATE_MAT: "true",
    ENCODING_MAX_DICT_SIZE: str(1 << 16),
    ENCODING_RLE_ENABLED: "false",
    READER_TYPE: "AUTO",
    MAX_READER_BATCH_SIZE_ROWS: str(1 << 20),
    MULTITHREADED_READ_NUM_THREADS: "8",
}


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

    def get(self, key: str) -> str:
        return self._values[key]

    def get_bool(self, key: str) -> bool:
        value = self._values[key].strip().lower()
        if value not in ("true", "false"):
            raise ValueError(f"{key} is a boolean, got {value!r}")
        return value == "true"

    def get_int(self, key: str) -> int:
        return int(self._values[key])
