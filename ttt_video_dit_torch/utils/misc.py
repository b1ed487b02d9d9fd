"""Misc training utilities (port of ttt_video_dit_tpu/utils/misc.py).

- ``set_random_seed``: seeds Python's, numpy's and torch's global generators
  (the train step's own draws come from a generator per step,
  training/train_step.py:step_generator).
- ``TimedContext``: wall-clock timing context.
- ``GarbageCollection``: automatic GC off, a manual collection every
  ``gc_freq`` steps (keeps collection pauses out of the step loop).
- ``get_num_params``.
- ``torch_profiler``: a ``torch.profiler`` trace (CPU and CUDA activities)
  written as a Chrome trace into a directory; the training entry wraps steps
  10-13 in it when ``--job.profile_dir`` is given.
"""

from __future__ import annotations

import contextlib
import gc
import os
import random
import time
from typing import Optional

import numpy as np
import torch


def set_random_seed(seed: int) -> None:
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


class TimedContext:
    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.duration = time.perf_counter() - self._start
        return False


class GarbageCollection:
    def __init__(self, gc_freq: int = 50):
        self.gc_freq = max(gc_freq, 1)
        gc.disable()
        gc.collect(1)

    def run(self, step: int) -> None:
        if step % self.gc_freq == 0:
            gc.collect(1)

    def close(self) -> None:
        """Turn automatic collection back on (the entry may run more than once in a process)."""
        gc.enable()


def get_num_params(module: torch.nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


@contextlib.contextmanager
def torch_profiler(log_dir: Optional[str]):
    """Profile the block (CPU and, when present, CUDA activities) and write
    ``<log_dir>/trace.json`` (open it in Perfetto or chrome://tracing) when a
    directory is given; a no-op otherwise."""
    if not log_dir:
        yield None
        return
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
