"""flax parameters -> this package's ``state_dict``.

The flax tree (a nested dict of arrays, with or without the outer "params"
collection) maps one to one onto the port's module names:

- ``layers_<i>`` becomes ``layers.<i>``;
- a ``scan_layers`` tree (``scan_layers/scan/layer/...``, each leaf stacked
  on dim 0 over the layers, the layout of the JAX package's
  dit.py:stack_layer_params) is unstacked into ``layers.<i>``, so a model
  built with ``scan_layers = true`` (the training TOMLs) carries across to
  the port's unrolled layers;
- Dense ``kernel`` [in, out] becomes ``weight`` [out, in];
- Conv ``kernel`` HWIO becomes ``weight`` OIHW;
- LayerNorm ``scale`` becomes ``weight``;
- everything else (biases, TTT ``W1/b1/W2/b2``, ``ttt_norm_*``,
  ``learnable_ttt_lr_*``, ``gating_alpha``) carries over as it is.
"""

from __future__ import annotations

import re

import numpy as np
import torch


def _flatten(tree, prefix=()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, dict) or hasattr(value, "items"):
            yield from _flatten(value, path)
        else:
            yield path, value


_SCAN = ("scan_layers", "scan", "layer")


def _unstack_layers(items):
    """(path, value) pairs with every ``scan_layers/scan/layer`` leaf split
    into one ``layers_<i>`` leaf per layer (the inverse of stack_layer_params)."""
    for path, value in items:
        at = next((j for j in range(len(path) - 2) if path[j : j + 3] == _SCAN), None)
        if at is None:
            yield path, value
            continue
        stacked = np.asarray(value)
        for i in range(stacked.shape[0]):
            yield path[:at] + (f"layers_{i}",) + path[at + 3 :], stacked[i]


def flax_to_state_dict(params) -> dict[str, torch.Tensor]:
    """Convert flax params (nested mapping of numpy-convertible arrays) to a
    float32 state dict for the port's module of the same structure."""
    if set(params) == {"params"}:
        params = params["params"]
    out = {}
    for path, value in _unstack_layers(_flatten(params)):
        arr = np.array(value, dtype=np.float32)  # a writable copy
        *mods, leaf = (re.sub(r"^layers_(\d+)$", r"layers.\1", p) for p in path)
        if leaf == "kernel":
            if arr.ndim == 2:
                arr = arr.T
            elif arr.ndim == 4:
                arr = arr.transpose(3, 2, 0, 1)
            else:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*mods, leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def load_flax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load flax params into ``module`` (strict: every key must match)."""
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module
