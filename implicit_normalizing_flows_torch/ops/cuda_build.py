"""Build and load the port's CUDA sources.

Each ``csrc/*.cu`` file has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into a shared library at first use and loaded with
ctypes. The library's name carries a hash of its source, so an edited source
is rebuilt and a stale library is never loaded. The build directory is
``implicit_normalizing_flows_torch/build/`` (listed in ``.gitignore``);
delete it to force a rebuild.

Nothing here runs at import: the CPU tests import every module, and there is
no ``nvcc`` where they run.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:12]}.so"


def build(name: str, report: bool = False) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built;
    returns the library's path. ``report`` compiles anew with
    ``-Xptxas -v`` and prints the compiler's report (registers, shared
    memory, spills)."""
    out = library_path(name)
    if out.exists() and not report:
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if report else []),
           "-o", str(tmp), str(CSRC_DIR / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
    if report:
        print(proc.stderr)
    os.replace(tmp, out)  # atomic: concurrent builders never see a partial file
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
