"""The device a session runs on, and the memory runtime (the analog of
``spark_rapids_tpu/memory/device_manager.py``: ``DeviceManager``,
``initialize``, ``get_runtime``, ``shutdown`` and
``free_device_headroom``, ``:29-123``).

``resolve_device``: ``cuda:0`` by default.  There is no quiet fallback:
without a CUDA device a session is refused unless the caller asked for
``"cpu"``, which the tests do to run every kernel's plain PyTorch
version.

The runtime is one ``DeviceManager`` a process: the buffer catalog over
a device pool of ``spark.rapids.tpu.memory.pool.size`` bytes or, where
that is 0, ``spark.rapids.memory.gpu.allocFraction`` of the card's
memory (``torch.cuda.mem_get_info``; on the CPU a fixed 4 GiB stands for
the card, as the JAX package pretends for its CPU devices).  The first
``TorchSession`` initializes it; a later session with other startup keys
(``config.STARTUP_KEYS``) is warned, as the JAX package warns (one on
another device shares the pool: the CPU sessions a test opens beside a
card's), and ``shutdown()`` lets the next session shape it anew.  The
one exception: a runtime made for the CPU, with nothing in its catalog,
is made anew by the first card session.
``free_device_headroom`` is the one policy point of every out-of-core
decision (the window, the sort, the group-by merge)."""

from __future__ import annotations

import logging
import threading
from typing import Optional, Union

import torch

log = logging.getLogger(__name__)

#: the memory a CPU device stands for (the JAX package's
#: ``_detect_hbm_bytes`` fallback)
CPU_DEVICE_BYTES = 4 << 30

_runtime_lock = threading.Lock()
_runtime: Optional["DeviceManager"] = None


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """``cuda:0`` by default; raises when CUDA is asked for (or implied)
    and absent."""
    dev = torch.device("cuda", 0) if device is None else torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the port's plain PyTorch path on the host")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return dev


def device_memory_bytes(device: torch.device) -> int:
    """The card's total memory (CPU: ``CPU_DEVICE_BYTES``)."""
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return CPU_DEVICE_BYTES


class DeviceManager:
    """The catalog over the device pool of ``conf`` on ``device``."""

    def __init__(self, conf, device: torch.device):
        from spark_rapids_tpu_torch import config as C
        from spark_rapids_tpu_torch.memory.catalog import BufferCatalog
        self.conf = conf
        self.device = device
        pool = conf.get_bytes(C.DEVICE_POOL_SIZE)
        if not pool:
            pool = int(device_memory_bytes(device) *
                       conf.get_float(C.DEVICE_POOL_FRACTION))
        self.catalog = BufferCatalog(
            device_limit_bytes=pool,
            host_limit_bytes=conf.get_bytes(C.HOST_SPILL_STORAGE_SIZE),
            disk_dir=conf.get(C.SPILL_DIR) or None, codec=conf.spill_codec,
            device=device)
        log.info("DeviceManager initialized on %s pool=%dMiB", device,
                 pool >> 20)

    def shutdown(self) -> None:
        self.catalog.close()


def initialize(conf=None, device: Optional[torch.device] = None
               ) -> DeviceManager:
    """The process's runtime, made on the first call (with ``conf`` and
    ``device``, the defaults being the default conf and the CPU).  A
    runtime made for the CPU is made anew by the first call for a card
    while its catalog holds nothing, so a CPU session (or a spillable
    made with no runtime) that came first does not size the card's
    pool."""
    from spark_rapids_tpu_torch import config as C
    global _runtime
    with _runtime_lock:
        if _runtime is not None and device is not None and \
                device.type == "cuda" and _runtime.device.type == "cpu":
            if _runtime.catalog.stats()["buffers"] == 0:
                _runtime.shutdown()
                _runtime = None
            else:
                log.warning(
                    "runtime initialized for the CPU holds buffers; a "
                    "session on %s shares its %dMiB pool. Call shutdown() "
                    "first to shape it for the card.", device,
                    _runtime.catalog.device_limit >> 20)
        if _runtime is None:
            _runtime = DeviceManager(conf or C.TorchConf(),
                                     device or torch.device("cpu"))
        elif conf is not None and conf is not _runtime.conf:
            # device and memory settings shape the runtime once; a second
            # session cannot re-shape the pool
            for key in C.STARTUP_KEYS:
                if conf.get(key) != _runtime.conf.get(key):
                    log.warning(
                        "runtime already initialized; startup conf %s=%r is "
                        "ignored (active value %r). Call shutdown() first to "
                        "re-shape the device runtime.", key, conf.get(key),
                        _runtime.conf.get(key))
        if device is not None and device != _runtime.device:
            log.info("runtime already initialized on %s; a session on %s "
                     "shares its pool. Call shutdown() first to move it.",
                     _runtime.device, device)
        return _runtime


def get_runtime() -> Optional[DeviceManager]:
    return _runtime


def free_device_headroom(divisor: int) -> Optional[int]:
    """Free pool bytes over a safety factor, or None when no runtime is
    initialized (execs driven directly)."""
    rt = _runtime
    if rt is None:
        return None
    free = max(0, rt.catalog.device_limit - rt.catalog.device_bytes)
    return free // divisor


def memory_stats() -> dict:
    """The runtime's counters: the catalog's tiers and spills, its
    copies and syncs, and every thread's retries and split retries."""
    from spark_rapids_tpu_torch.memory import retry as R
    rt = _runtime
    out = {} if rt is None else dict(rt.catalog.stats())
    if rt is not None:
        out["transfers"] = rt.catalog.transfer_stats()
    out["retry"] = R.RETRY_COUNT
    out["splitRetry"] = R.SPLIT_RETRY_COUNT
    return out


def shutdown() -> None:
    global _runtime
    with _runtime_lock:
        if _runtime is not None:
            _runtime.shutdown()
            _runtime = None
