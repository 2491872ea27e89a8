"""Build the port's CUDA sources into shared libraries at first use.

Each ``csrc/*.cu`` file has a plain C interface. ``load_library`` compiles it
with ``nvcc`` for ``sm_90a`` into ``build/kernels/`` at the root of the
checkout (listed in ``.gitignore``), named by a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. The result is opened with ``ctypes``. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(ROOT, "build", "kernels")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output of each build made by this process (ptxas register and
# shared-memory report), keyed by source path
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def library_path(source: str) -> str:
    with open(source, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(BUILD_DIR, f"lib{stem}-{digest[:16]}.so")


def build(source: str) -> str:
    """Compile ``source`` unless its library is already built; returns the
    library's path. Raises with the compiler's output if ``nvcc`` fails."""
    path = library_path(source)
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", tmp, source],
        capture_output=True, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, path)  # atomic: a concurrent build finds a whole file
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    return path


def load_library(source: str) -> ctypes.CDLL:
    """The built library of ``source``, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source))
            _LIBS[source] = lib
        return lib
