"""Checkpoints (port of ttt_video_dit_tpu/training/checkpoint.py), in the
port's own format, since the JAX package's Orbax directories cannot be read
without JAX.

- :class:`Checkpointer`: training checkpoints, one directory a step under
  ``<dump_folder>/checkpoint/``: ``model.safetensors`` (the module's state
  dict, float32 masters), ``optimizer.safetensors`` (the grouped AdamW's
  moments as ``mu/<flax path>`` and ``nu/<flax path>``), ``sampler.json``
  (the data sampler's state), ``metadata.json`` (step, optimizer count, the
  wandb run id), and whatever the caller adds (the stats history). A step is
  written into a temporary directory and renamed into place, so a directory
  named by a step is always complete; ``latest_step`` skips anything else.
  Tensors are written and read one at a time, each copied straight into its
  parameter or moment on the device.
- ``save_pretrained`` / ``load_pretrained``: params only, one directory
  holding ``model.safetensors`` (the stage-to-stage curriculum handoff and
  converted pretrained weights). A JAX run's params carry across through
  ``convert.flax_to_state_dict`` (a ``scan_layers`` tree is unstacked there),
  then ``save_pretrained``.

Under FSDP2 and tensor parallelism (parallel/sharding.py) a save gathers
each full tensor on every rank (a collective) and only the main process
writes, in the same format; every rank waits at a barrier before going on.
A restore reads the same files on every rank, each taking its own shards,
so a checkpoint written at one world size resumes at another.
"""

from __future__ import annotations

import json
import os
import shutil
import time
from typing import Any, Callable, Dict, Optional

import torch

from ttt_video_dit_torch.parallel.mesh import barrier, is_main_process
from ttt_video_dit_torch.utils import safetensors

WEIGHTS_NAME = "model.safetensors"
OPTIMIZER_NAME = "optimizer.safetensors"
SAMPLER_NAME = "sampler.json"
METADATA_NAME = "metadata.json"  # written last


def dir_bytes(path: str) -> int:
    """The bytes of the files in ``path``."""
    return sum(os.path.getsize(os.path.join(path, f)) for f in os.listdir(path))


class Checkpointer:
    """Save and restore model, optimizer, data sampler and run metadata."""

    def __init__(self, directory: str):
        self.directory = os.path.abspath(directory)

    def step_dir(self, step: int) -> str:
        return os.path.join(self.directory, str(step))

    def save(self, step: int, model: torch.nn.Module, optimizer, sampler_state: Dict[str, Any],
             metadata: Dict[str, Any], extra: Optional[Callable[[str], None]] = None) -> dict:
        """Write step ``step``; ``extra(path)`` may add files before the
        directory is published. A directory of the same step is replaced.
        Every rank calls it; the main process writes. Returns {"seconds",
        "bytes"}."""
        t0 = time.perf_counter()
        opt = optimizer.state_dict()
        weights, moments = model.state_dict(), {f"{k}/{path}": t for k in ("mu", "nu") for path, t in opt[k].items()}
        if not is_main_process():
            safetensors.gather_only(weights)
            safetensors.gather_only(moments)
            barrier()
            return {"seconds": time.perf_counter() - t0, "bytes": dir_bytes(self.step_dir(step))}
        os.makedirs(self.directory, exist_ok=True)
        tmp = os.path.join(self.directory, f".tmp-{step}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(tmp)
        safetensors.save_file(weights, os.path.join(tmp, WEIGHTS_NAME))
        safetensors.save_file(moments, os.path.join(tmp, OPTIMIZER_NAME))
        with open(os.path.join(tmp, SAMPLER_NAME), "w", encoding="utf-8") as f:
            json.dump(sampler_state, f)
        if extra is not None:
            extra(tmp)
        with open(os.path.join(tmp, METADATA_NAME), "w", encoding="utf-8") as f:
            json.dump({"step": step, "optimizer_count": opt["count"], **metadata}, f)
        nbytes = dir_bytes(tmp)
        final = self.step_dir(step)
        old = None
        if os.path.exists(final):
            old = os.path.join(self.directory, f".old-{step}-{os.getpid()}")
            os.replace(final, old)
        os.replace(tmp, final)
        if old is not None:
            shutil.rmtree(old)
        barrier()
        return {"seconds": time.perf_counter() - t0, "bytes": nbytes}

    def wait(self) -> None:
        """Saves are synchronous; kept for the JAX Checkpointer's API."""

    def latest_step(self) -> Optional[int]:
        """The highest step with a complete directory, or None."""
        if not os.path.isdir(self.directory):
            return None
        steps = [int(name) for name in os.listdir(self.directory)
                 if name.isdigit() and os.path.exists(os.path.join(self.directory, name, METADATA_NAME))]
        return max(steps, default=None)

    @torch.no_grad()
    def restore(self, step: int, model: torch.nn.Module, optimizer) -> tuple[int, Dict[str, Any], Dict[str, Any]]:
        """Load step ``step`` (-1: the latest) into ``model`` and ``optimizer``
        in place. Returns (step, sampler state, metadata)."""
        if step == -1:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoint found under {self.directory}")
        path = self.step_dir(step)
        if not os.path.exists(os.path.join(path, METADATA_NAME)):
            raise FileNotFoundError(f"no complete checkpoint of step {step} under {self.directory}")
        safetensors.load_into(model, os.path.join(path, WEIGHTS_NAME))
        with open(os.path.join(path, SAMPLER_NAME), encoding="utf-8") as f:
            sampler_state = json.load(f)
        with open(os.path.join(path, METADATA_NAME), encoding="utf-8") as f:
            metadata = json.load(f)
        moments = os.path.join(path, OPTIMIZER_NAME)
        optimizer.load_state_dict({"count": metadata["optimizer_count"], "mu": safetensors.LazyFile(moments, "mu/"),
                                   "nu": safetensors.LazyFile(moments, "nu/")})
        return step, sampler_state, metadata


def save_pretrained(path: str, model: torch.nn.Module) -> str:
    """Write ``model``'s state dict to ``path/model.safetensors``; returns the
    file. Every rank calls it; the main process writes the full tensors."""
    out = os.path.join(path, WEIGHTS_NAME)
    if is_main_process():
        os.makedirs(path, exist_ok=True)
        safetensors.save_file(model.state_dict(), out)
    else:
        safetensors.gather_only(model.state_dict())
    barrier()
    return out


def load_pretrained(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a :func:`save_pretrained` directory (or any safetensors file or
    shard directory under the module's names) into ``model`` in place,
    strictly: every key present, none extra, each at its shape; values are
    cast to the parameters' dtypes and devices, one tensor at a time."""
    safetensors.load_into(model, path)
    return model
