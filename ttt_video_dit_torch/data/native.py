"""The native reader: a ctypes binding of ``_native/npy_loader.cpp`` (port of
ttt_video_dit_tpu/data/native.py; the C++ source is a byte copy of the JAX
package's, held to it by a test).

It reads ``.npy`` files, the first ``.npy`` member of a ``.npz`` (stored or
deflated), a ``torch.save``d ``.pt`` holding one tensor (bf16 widened to
float32) and dict-of-tensor ``.pt`` checkpoints, and runs a pool of C++
threads that read files off the GIL (``PrefetchPool``). At first use it is
compiled with the system ``g++`` (``-O2 -shared -fPIC -std=c++17 -pthread
... -lz``) into ``ttt_video_dit_torch/build/`` under a name that carries a
hash of the source, so an edited source is rebuilt. Nothing is compiled
when the module is imported.

The reader is optional: without ``g++`` or zlib's header ``available()`` is
False, :func:`build_error` says why, and the loader (``data/dataset.py``)
reads in Python, yielding the same batches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import weakref
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "_native" / "npy_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build"

_DTYPES = {0: np.float32, 1: np.float16, 2: np.float64, 3: np.int8, 4: np.int16, 5: np.int32, 6: np.int64,
           7: np.uint8}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False
_error = ""


def _build() -> Path:
    """The built library, compiled now if this source has not been built yet."""
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    so = BUILD_DIR / f"npy_loader-{digest}.so"
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-pthread", str(SOURCE), "-o", str(tmp), "-lz"]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=120)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ exited {proc.returncode}: {proc.stderr[-2000:]}")
    os.replace(tmp, so)
    return so


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried, _error
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:
            _error = f"{type(e).__name__}: {e}"
            return None
        lib.nl_pool_create.restype = ctypes.c_void_p
        lib.nl_pool_create.argtypes = [ctypes.c_int]
        lib.nl_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.nl_submit.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p]
        out_args = [ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int32),
                    ctypes.POINTER(ctypes.c_int32)]
        lib.nl_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64, *out_args]
        lib.nl_wait.restype = ctypes.c_int
        lib.nl_load.argtypes = [ctypes.c_char_p, *out_args]
        lib.nl_load.restype = ctypes.c_int
        lib.nl_free.argtypes = [ctypes.c_void_p]
        lib.nl_pt_dict_open.restype = ctypes.c_void_p
        lib.nl_pt_dict_open.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32)]
        lib.nl_pt_dict_name.restype = ctypes.c_char_p
        lib.nl_pt_dict_name.argtypes = [ctypes.c_void_p, ctypes.c_int32]
        lib.nl_pt_dict_get.argtypes = [ctypes.c_void_p, ctypes.c_int32, *out_args]
        lib.nl_pt_dict_get.restype = ctypes.c_int
        lib.nl_pt_dict_close.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    """Whether the reader built and loaded (it is built on the first call)."""
    return _load() is not None


def build_error() -> str:
    """Why the reader is unavailable ("" when it is available or untried)."""
    _load()
    return _error


def _require() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native reader unavailable ({_error})")
    return lib


def _out():
    return ctypes.c_void_p(), (ctypes.c_int64 * 8)(), ctypes.c_int32(), ctypes.c_int32()


def _to_array(lib, data, shape, ndim, dtype) -> np.ndarray:
    """The C buffer as an ndarray without a copy; a finalizer frees it when
    the last view dies (a copy here made pooled reads slower than
    ``np.load`` on page-cached files, the JAX package measured)."""
    dt = _DTYPES[dtype.value]
    shp = tuple(shape[i] for i in range(ndim.value))
    n = int(np.prod(shp)) if shp else 1
    buf = (ctypes.c_char * max(n * np.dtype(dt).itemsize, 1)).from_address(data.value)
    weakref.finalize(buf, lib.nl_free, ctypes.c_void_p(data.value))
    return np.frombuffer(buf, dtype=dt, count=n).reshape(shp)


def load_npy(path: str) -> np.ndarray:
    """One array: a bare ``.npy``; the first ``.npy`` member of a ``.npz``
    (the key ``np.load`` lists first); or a ``.pt`` zip holding one plain CPU
    tensor (bf16 widened to float32). Raises IOError where the file needs the
    Python path (zip64, other dtypes, dict or list pickles, legacy ``.pt``),
    RuntimeError when the reader is unavailable."""
    lib = _require()
    data, shape, ndim, dtype = _out()
    rc = lib.nl_load(path.encode(), ctypes.byref(data), shape, ctypes.byref(ndim), ctypes.byref(dtype))
    if rc != 0:
        raise IOError(f"native npy load failed ({rc}): {path}")
    return _to_array(lib, data, shape, ndim, dtype)


def load_pt_dict(path: str) -> dict:
    """A dict-of-tensor ``.pt`` checkpoint as ``{dotted name: ndarray}``:
    nested dicts flattened with ``.`` (a root ``{"state_dict": {...}}`` gives
    ``state_dict.<key>``), non-tensor values dropped, bf16 widened to float32
    (bit-equal to ``torch.load(...).float()``). Raises IOError where the file
    needs ``torch.load``."""
    lib = _require()
    count, err = ctypes.c_int32(), ctypes.c_int32()
    h = lib.nl_pt_dict_open(path.encode(), ctypes.byref(count), ctypes.byref(err))
    if not h:
        raise IOError(f"native .pt dict open failed ({err.value}): {path}")
    out = {}
    try:
        for i in range(count.value):
            name = lib.nl_pt_dict_name(h, i)
            data, shape, ndim, dtype = _out()
            rc = lib.nl_pt_dict_get(h, i, ctypes.byref(data), shape, ctypes.byref(ndim), ctypes.byref(dtype))
            if rc != 0:
                raise IOError(f"native .pt dict tensor {name!r} failed ({rc}): {path}")
            out[name.decode()] = _to_array(lib, data, shape, ndim, dtype)
    finally:
        lib.nl_pt_dict_close(h)
    return out


class PrefetchPool:
    """C++ threads that read files: ``submit(id, path)`` (or ``fetch(path)``,
    which returns a fresh id) queues a read, ``wait(id)`` blocks for its
    array, ``discard(id)`` waits and drops it (errors ignored)."""

    def __init__(self, num_threads: int = 4):
        self._lib = _require()
        self._pool = ctypes.c_void_p(self._lib.nl_pool_create(num_threads))
        self._next_id = 0

    def submit(self, job_id: int, path: str) -> None:
        self._lib.nl_submit(self._pool, job_id, path.encode())

    def fetch(self, path: str) -> int:
        job_id = self._next_id
        self._next_id += 1
        self.submit(job_id, path)
        return job_id

    def discard(self, job_id: int) -> None:
        try:
            self.wait(job_id)
        except IOError:
            pass

    def wait(self, job_id: int) -> np.ndarray:
        data, shape, ndim, dtype = _out()
        rc = self._lib.nl_wait(self._pool, job_id, ctypes.byref(data), shape, ctypes.byref(ndim), ctypes.byref(dtype))
        if rc != 0:
            raise IOError(f"native npy load failed ({rc}) for job {job_id}")
        return _to_array(self._lib, data, shape, ndim, dtype)

    def close(self) -> None:
        if self._pool:
            self._lib.nl_pool_destroy(self._pool)
            self._pool = None

    def __del__(self):  # best effort
        try:
            self.close()
        except Exception:  # noqa: BLE001
            pass
