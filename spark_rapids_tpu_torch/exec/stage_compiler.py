"""The kernel cache (the analog of ``spark_rapids_tpu/exec/stage_compiler.py``).

One entry point, ``get_or_build(kind, key, build)``, fetches a built kernel
or builds it, and counts hits, misses and builds per kind, so that "a
repeated query, or the same query with another literal, builds nothing" is
a fact a test can check (compare ``steady_traces`` in ``bench.py``)."""

from __future__ import annotations

import threading
import time
from typing import Any, Callable, Dict, Hashable


class KernelCache:
    def __init__(self):
        self._lock = threading.Lock()
        self._entries: Dict[Hashable, Any] = {}
        self._hits = 0
        self._misses = 0
        self._builds_by_kind: Dict[str, int] = {}
        self._build_s = 0.0

    def get_or_build(self, kind: str, key: Hashable,
                     build: Callable[[], Any]) -> Any:
        k = (kind, key)
        with self._lock:
            if k in self._entries:
                self._hits += 1
                return self._entries[k]
            self._misses += 1
            # built under the lock: two threads never build one kernel twice
            t0 = time.perf_counter()
            value = build()
            self._build_s += time.perf_counter() - t0
            self._builds_by_kind[kind] = \
                self._builds_by_kind.get(kind, 0) + 1
            self._entries[k] = value
            return value

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"hits": self._hits, "misses": self._misses,
                    "builds": sum(self._builds_by_kind.values()),
                    "builds_by_kind": dict(self._builds_by_kind),
                    "build_s": self._build_s}


#: built kernels live as long as the process, as compiled code does
_CACHE = KernelCache()


def get_or_build(kind: str, key: Hashable, build: Callable[[], Any]) -> Any:
    return _CACHE.get_or_build(kind, key, build)


def stats() -> Dict[str, Any]:
    return _CACHE.stats()
