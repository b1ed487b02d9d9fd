"""Params-only checkpoints: the stage-to-stage curriculum handoff and
converted pretrained weights (port of the params-only part of
ttt_video_dit_tpu/training/checkpoint.py: ``save_pretrained`` /
``load_pretrained``).

The port's own format, since the JAX package's Orbax directory cannot be
read without JAX: one directory holding ``model.safetensors``, the module's
state dict (float32 masters) in the safetensors layout
(``utils/safetensors.py``). A JAX run's params carry across through
``convert.flax_to_state_dict`` (a ``scan_layers`` tree is unstacked there),
then ``save_pretrained``.
"""

from __future__ import annotations

import os

import torch

from ttt_video_dit_torch.utils import safetensors

WEIGHTS_NAME = "model.safetensors"


def save_pretrained(path: str, model: torch.nn.Module) -> str:
    """Write ``model``'s state dict to ``path/model.safetensors``; returns the file."""
    os.makedirs(path, exist_ok=True)
    out = os.path.join(path, WEIGHTS_NAME)
    safetensors.save_file(model.state_dict(), out)
    return out


def load_pretrained(path: str, model: torch.nn.Module) -> torch.nn.Module:
    """Load a :func:`save_pretrained` directory (or any safetensors file or
    shard directory under the module's names) into ``model`` in place,
    strictly: every key present, none extra, each at its shape; values are
    cast to the parameters' dtypes and devices, one tensor at a time."""
    safetensors.load_into(model, path)
    return model
