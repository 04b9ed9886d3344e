"""Kernel sources and the code that builds them.

``build`` compiles CUDA C++ from ``csrc/`` with ``nvcc`` and imports
generated Triton modules, both into the git-ignored ``build/`` directory at
the repository root, at first use.  ``fused_agg`` emits kernel 1's Triton
source from an expression chain.  Nothing here imports ``triton`` when it
is imported."""
