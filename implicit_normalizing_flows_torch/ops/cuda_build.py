"""Build and load the port's CUDA sources.

Each library's ``csrc/<name>.cu`` file has a plain C interface. It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library at first use,
with the translation units of :data:`LINKED` beside it, and loaded with
ctypes. The library's name carries a hash of its sources and of the shared
headers (``csrc/*.cuh``), so an edited source is rebuilt and a stale library
is never loaded. :func:`build_all` compiles several sources at once, one
``nvcc`` process each. The build directory is
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

# sources compiled as translation units of their own and linked into a
# library beside csrc/<name>.cu (conv3x3_in_tc.cuh says why): the 3x3
# tensor-core forms and the cluster-split reductions broyden_step, tdot,
# chan_sums and line_search
LINKED = {"estimator": ["conv3x3_in_tc", "conv3x3_out_tc", "tdot"],
          "implicit_grad": ["conv3x3_in_tc", "chan_sums"], "block_forward": ["conv3x3_in_tc"],
          "fused_solve": ["conv3x3_in_tc", "conv3x3_out_tc", "broyden_step", "line_search"]}

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def sources(name: str) -> list:
    """The ``.cu`` files of library ``name``."""
    return [CSRC_DIR / f"{n}.cu" for n in [name, *LINKED.get(name, [])]]


def library_path(name: str) -> Path:
    h = hashlib.sha256()
    for src in sources(name):
        h.update(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:12]}.so"


def build_all(names, report: bool = False) -> dict:
    """Compile the sources of each name whose library is not built yet
    (:func:`sources`), all ``nvcc`` processes started together; returns
    ``{name: path}``.
    ``report`` compiles anew with ``-Xptxas -v`` and prints the compiler's
    report (registers, shared memory, spills)."""
    outs = {name: library_path(name) for name in names}
    todo = [n for n in names if report or not outs[n].exists()]
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in todo:
        tmp = outs[name].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if report else []),
               "-o", str(tmp), *(str(s) for s in sources(name))]
        procs[name] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                             stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{err}")
            continue
        if report:
            print(err)
        os.replace(tmp, outs[name])  # atomic: a concurrent build never sees a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return outs


def build(name: str, report: bool = False) -> Path:
    """Compile library ``name`` unless it is already built;
    returns the library's path (see :func:`build_all`)."""
    return build_all([name], report)[name]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built at first use."""
    if name not in _loaded:
        _loaded[name] = ctypes.CDLL(str(build(name)))
    return _loaded[name]
