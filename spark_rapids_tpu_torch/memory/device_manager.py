"""Picks the device a session runs on (the analog of
``spark_rapids_tpu/memory/device_manager.py``).

The default is ``cuda:0``.  There is no quiet fallback: without a CUDA
device a session is refused unless the caller asked for ``"cpu"``, which
the tests do to run every kernel's plain PyTorch version."""

from __future__ import annotations

from typing import Optional, Union

import torch


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
