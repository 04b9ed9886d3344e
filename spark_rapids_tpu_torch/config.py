"""Session configuration: a small string-valued conf, as ``TpuConf`` takes
(``spark_rapids_tpu/config.py``).  This slice of the port reads no key yet;
the conf refuses every key it does not know, so a setting meant for the
JAX package is never silently ignored."""

from __future__ import annotations

from typing import Dict, Mapping, Optional

_DEFAULTS: Dict[str, str] = {}


class TorchConf:
    """Immutable string-valued settings; unknown keys are refused."""

    def __init__(self, values: Optional[Mapping[str, str]] = None):
        self._values = dict(_DEFAULTS)
        for key, value in (values or {}).items():
            if key not in _DEFAULTS:
                raise KeyError(f"unknown conf key {key!r}; known keys: "
                               f"{sorted(_DEFAULTS)}")
            self._values[key] = str(value)

    def get(self, key: str) -> str:
        return self._values[key]
