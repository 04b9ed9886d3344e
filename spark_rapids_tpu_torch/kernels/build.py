"""Builds kernels into ``build/`` at the repository root (git-ignored).

- CUDA C++: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a
  shared library with a plain C interface, loaded with ``ctypes``; no
  PyTorch headers, so a build takes seconds.
- Triton: ``@triton.jit`` reads a kernel's source through ``inspect``, so a
  generated kernel is written to a file and imported from there.  Triton's
  own cache is pointed into ``build/`` too."""

from __future__ import annotations

import ctypes
import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import ModuleType, SimpleNamespace
from typing import Dict, Sequence

REPO_ROOT = Path(__file__).resolve().parents[2]
CSRC = Path(__file__).resolve().parents[1] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v"]


def build_dir(*parts: str) -> Path:
    path = REPO_ROOT.joinpath("build", *parts)
    path.mkdir(parents=True, exist_ok=True)
    return path


def _write_if_changed(path: Path, text: str) -> None:
    if path.exists() and path.read_text() == text:
        return
    tmp = path.with_suffix(path.suffix + f".{os.getpid()}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


def load_triton_module(name: str, source: str) -> ModuleType:
    """Writes ``source`` to ``build/triton/<name>.py`` and imports it."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(build_dir("triton_cache")))
    path = build_dir("triton") / f"{name}.py"
    _write_if_changed(path, source)
    mod_name = f"spark_rapids_tpu_torch_generated.{name}"
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = module
    spec.loader.exec_module(module)
    return module


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the CUDA kernels")
    return found


def build_shared_library(source_name: str) -> Path:
    """Compiles ``csrc/<source_name>`` to ``build/cuda/lib<stem>-<hash>.so``
    (reused when the source and the headers under ``csrc/`` are unchanged);
    the compiler's register and shared-memory report goes beside it as
    ``.log``."""
    src = CSRC / source_name
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src.read_bytes() + headers +
                          " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    out = build_dir("cuda") / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    proc = subprocess.run([nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
                           str(src)], capture_output=True, text=True)
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src.name} "
                           f"(rc={proc.returncode}):\n{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


#: ctypes argument codes of ``load_cuda``'s signatures: a device or host
#: pointer (``p``), an int64 (``q``), an int32 (``i``)
_ARG = {"p": ctypes.c_void_p, "q": ctypes.c_int64, "i": ctypes.c_int32}


def load_cuda(source_name: str, signatures: Dict[str, str]
              ) -> SimpleNamespace:
    """Builds ``csrc/<source_name>`` (first call) and binds its C entry
    points: ``signatures`` maps each function name to its argument codes
    (``_ARG``); every entry point returns a ``cudaError_t`` as int."""
    lib = ctypes.CDLL(str(build_shared_library(source_name)))
    fns = {}
    for name, codes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = [_ARG[c] for c in codes]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return SimpleNamespace(**fns)


def pointers(tensors: Sequence) -> "ctypes.Array":
    """A host array of device pointers (None is a null pointer)."""
    return (ctypes.c_void_p * max(1, len(tensors)))(
        *[None if t is None else t.data_ptr() for t in tensors])


def int32s(values: Sequence[int]) -> "ctypes.Array":
    return (ctypes.c_int32 * max(1, len(values)))(*values)


def int64s(values: Sequence[int]) -> "ctypes.Array":
    return (ctypes.c_int64 * max(1, len(values)))(*values)


def check_launch(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc}")
