"""Builds kernels into ``build/`` at the repository root (git-ignored).

- CUDA C++: ``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared`` into a
  shared library with a plain C interface, loaded with ``ctypes``; no
  PyTorch headers, so a build takes seconds.
- Triton: ``@triton.jit`` reads a kernel's source through ``inspect``, so a
  generated kernel is written to a file and imported from there.  Triton's
  own cache is pointed into ``build/`` too."""

from __future__ import annotations

import hashlib
import importlib.util
import os
import shutil
import subprocess
import sys
from pathlib import Path
from types import ModuleType

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
    (reused when the source is unchanged); the compiler's register and
    shared-memory report goes beside it as ``.log``."""
    src = CSRC / source_name
    digest = hashlib.sha1(src.read_bytes() +
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
