"""Build the package's hand-written CUDA kernels and load them with ctypes.

Each kernel is one ``csrc/<name>.cu`` file with a plain C entry point (it may
include the shared ``csrc/*.cuh`` headers). At first use it is compiled with
nvcc for Hopper (``sm_90a``) into ``ttt_video_dit_torch/build/`` (a
directory git ignores), under a name that carries a hash of the source and
the headers, so an edited source is rebuilt and an unchanged one is loaded
as built. Nothing is compiled when a module is
imported: CPU-only hosts never call :func:`load`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)

# name -> {"seconds": build time (0.0 when loaded as built), "ptxas": nvcc's stderr}
build_info: dict[str, dict] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH to build the CUDA kernels")
    return found


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` if needed and return the loaded library."""
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    digest = h.hexdigest()[:16]
    lib_path = BUILD_DIR / f"{name}-{digest}.so"
    t0 = time.perf_counter()
    ptxas = ""
    if not lib_path.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {src.name}:\n{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, lib_path)
        ptxas = proc.stderr
    build_info[name] = {"seconds": time.perf_counter() - t0, "ptxas": ptxas}
    lib = ctypes.CDLL(str(lib_path))
    lib.error_string.argtypes = [ctypes.c_int]
    lib.error_string.restype = ctypes.c_char_p
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code (its
    ``cudaGetLastError()`` after the launch)."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} ({lib.error_string(err).decode()})")
