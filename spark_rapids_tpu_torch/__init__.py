"""PyTorch/CUDA port of spark_rapids_tpu.

A second engine beside the JAX package: the same DataFrame recipes, the same
rows, with the device work running on an NVIDIA Hopper card through kernels
written by hand (Triton for the generated fused stage, CUDA C++ under
``csrc/`` for the reductions).  Module paths mirror ``spark_rapids_tpu`` so
the counterpart of each module is found by its path.

This package imports torch, numpy and the standard library only: never
``jax`` and nothing of ``spark_rapids_tpu``.  Entry points run on ``cuda``
unless the caller passes ``device="cpu"``.
"""

from spark_rapids_tpu_torch.session import DataFrame, TorchSession

__all__ = ["DataFrame", "TorchSession"]
