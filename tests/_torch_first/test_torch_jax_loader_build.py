"""Builds the JAX package's native loader once per checkout, before
tests/test_native_loader.py is collected.

That file skips its whole module unless ``ttt_video_dit_tpu.data.native.available()``
is true when it is imported. Under xdist every worker imports it at about
the same moment; where the cached ``npy_loader.so`` is older than its source
(a fresh checkout), every worker compiles into the same ``npy_loader.so.tmp``,
one worker's ``os.replace`` moves the file away under another, and that
worker skips all 34 of its tests. This directory sorts before every test
file, so each worker imports this module first: it takes an exclusive
``flock`` on a lock file beside the loader's cache directory, then calls
``available()``. The first worker compiles; the others wait, find the
``.so`` up to date and load it. The port's reader does not race (a
per-process temporary file and a source hash, ttt_video_dit_torch/data/native.py).
"""

import fcntl
import os
import shutil
import subprocess

from ttt_video_dit_tpu.data import native as jax_native


def _build_under_lock() -> bool:
    cache = os.path.dirname(jax_native._cache_dir())
    os.makedirs(cache, exist_ok=True)
    with open(os.path.join(cache, "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            return jax_native.available()
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


AVAILABLE = _build_under_lock()


def _toolchain() -> bool:
    """g++ on PATH, and it finds zlib.h."""
    gxx = shutil.which("g++")
    if gxx is None:
        return False
    probe = subprocess.run([gxx, "-fsyntax-only", "-x", "c++", "-"], input="#include <zlib.h>\n",
                           capture_output=True, text=True, timeout=60)
    return probe.returncode == 0


def test_the_jax_loader_builds_where_the_toolchain_is():
    """With g++ and zlib.h the JAX loader is available in this worker, so
    tests/test_native_loader.py runs rather than skipping as a module."""
    assert AVAILABLE or not _toolchain()
    assert jax_native.available() == AVAILABLE
