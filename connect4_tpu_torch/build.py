"""Build the port's native sources into shared libraries at first use.

Each source has a plain C interface and is opened with ``ctypes``. Two
toolchains build them:

- ``NVCC``: the CUDA kernels of ``models/csrc/*.cu`` (the tower),
  ``mcts/csrc/*.cu`` (the search's descent, and the spans' marks of
  ``launches``) and ``scripts/csrc/*.cu`` (a measurement's), for
  ``sm_90a``, into ``build/kernels/``;
- ``GXX``: the exact solver ``native/solver.cpp``, for the host's CPU
  (``-march=native``), into ``build/native/``.

Both directories are under ``build/`` at the root of the checkout (listed
in ``.gitignore``); nothing is written into the package. A library is named
by a hash of the source, the flags and, for ``-march=native``, the CPU the
compiler resolves it to, so an edited source is rebuilt, a library built on
another CPU is not loaded, and an unchanged one is loaded as it is. Each
build writes a temporary file of its own process and renames it into place,
so two processes building at once (two ranks, two test workers) each find a
whole file. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict, NamedTuple, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# --split-compile=0 optimises a source's kernels in parallel on every core
# (the tower's source has fifteen instantiations: seven of the fused kernel,
# eight of the layer kernel)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
)
GXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-pthread")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
# compiler output of each build made by this process (for nvcc, the ptxas
# register and shared-memory report), keyed by source path
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _gxx() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the exact solver is built with g++")
    return found


@functools.lru_cache(maxsize=None)
def _native_arch() -> str:
    """What ``-march=native`` means on this host, as g++ resolves it."""
    out = subprocess.run(
        [_gxx(), "-march=native", "-Q", "--help=target"], capture_output=True, text=True, check=True,
    ).stdout
    return " ".join(line.split()[-1] for line in out.splitlines() if line.strip().startswith("-march="))


class Toolchain(NamedTuple):
    name: str
    compiler: Callable[[], str]  # the compiler's path, found when a build runs
    flags: Tuple[str, ...]
    build_dir: str
    host_key: Callable[[], str]  # what else the library depends on


NVCC = Toolchain("nvcc", _nvcc, NVCC_FLAGS, os.path.join(ROOT, "build", "kernels"), lambda: "")
GXX = Toolchain("g++", _gxx, GXX_FLAGS, os.path.join(ROOT, "build", "native"), _native_arch)


def library_path(source: str, toolchain: Toolchain = NVCC) -> str:
    with open(source, "rb") as fh:
        key = fh.read() + " ".join(toolchain.flags + (toolchain.host_key(),)).encode()
    stem = os.path.splitext(os.path.basename(source))[0]
    return os.path.join(toolchain.build_dir, f"lib{stem}-{hashlib.sha256(key).hexdigest()[:16]}.so")


def build(source: str, toolchain: Toolchain = NVCC) -> str:
    """Compile ``source`` unless its library is already built; returns the
    library's path. Raises with the compiler's output if the build fails."""
    path = library_path(source, toolchain)
    if os.path.exists(path):
        return path
    os.makedirs(toolchain.build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            [toolchain.compiler(), *toolchain.flags, "-o", tmp, source],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"{toolchain.name} failed on {source}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, path)  # atomic: a concurrent build finds a whole file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    BUILD_LOGS[source] = proc.stdout + proc.stderr
    return path


def load_library(source: str, toolchain: Toolchain = NVCC) -> ctypes.CDLL:
    """The built library of ``source``, building it first if needed."""
    with _LOCK:
        lib = _LIBS.get(source)
        if lib is None:
            lib = ctypes.CDLL(build(source, toolchain))
            _LIBS[source] = lib
        return lib
