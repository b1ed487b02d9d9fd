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
- Conv ``kernel`` HWIO becomes ``weight`` OIHW, and a 3-D conv's
  [kt, kh, kw, I, O] becomes [O, I, kt, kh, kw];
- LayerNorm and GroupNorm ``scale`` becomes ``weight``;
- everything else (biases, TTT ``W1/b1/W2/b2``, ``ttt_norm_*``,
  ``learnable_ttt_lr_*``, ``gating_alpha``) carries over as it is.

``flax_vae_to_state_dict`` also renames the JAX VAE's flattened module names
to the reference's torch names that the port's VAE carries
(``down_0_block_1`` -> ``down.0.block.1``, ``mid_block_1`` -> ``mid.block_1``,
``up_3_upsample`` -> ``up.3.upsample``): the inverse of the JAX package's
``autoencoder.py:_map_torch_key``.
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


# flax kernel layout -> torch weight layout, by rank: Dense, Conv2d, Conv3d.
_KERNEL_AXES = {2: (1, 0), 4: (3, 2, 0, 1), 5: (4, 3, 0, 1, 2)}


def _to_state_dict(items, rename) -> dict[str, torch.Tensor]:
    out = {}
    for path, value in items:
        arr = np.array(value, dtype=np.float32)  # a writable copy
        *mods, leaf = path
        if leaf == "kernel":
            if arr.ndim not in _KERNEL_AXES:
                raise ValueError(f"unexpected kernel rank {arr.ndim} at {'/'.join(path)}")
            arr = arr.transpose(_KERNEL_AXES[arr.ndim])
            leaf = "weight"
        elif leaf == "scale":
            leaf = "weight"
        out[".".join([*(rename(m) for m in mods), leaf])] = torch.from_numpy(np.ascontiguousarray(arr))
    return out


def _params(tree):
    return tree["params"] if set(tree) == {"params"} else tree


def flax_to_state_dict(params) -> dict[str, torch.Tensor]:
    """Convert flax params (nested mapping of numpy-convertible arrays) to a
    float32 state dict for the port's module of the same structure."""
    return _to_state_dict(_unstack_layers(_flatten(_params(params))),
                          lambda m: re.sub(r"^layers_(\d+)$", r"layers.\1", m))


def _vae_module_name(name: str) -> str:
    name = re.sub(r"^(down|up)_(\d+)_block_(\d+)$", r"\1.\2.block.\3", name)
    name = re.sub(r"^(down|up)_(\d+)_(downsample|upsample)$", r"\1.\2.\3", name)
    return re.sub(r"^mid_(block_\d+)$", r"mid.\1", name)


def flax_vae_to_state_dict(params) -> dict[str, torch.Tensor]:
    """Convert the JAX VAE's flax params (an ``Encoder3D`` or ``Decoder3D``
    tree) to a float32 state dict under the reference's torch names, which the
    port's ``Encoder3D``/``Decoder3D`` load strictly."""
    return _to_state_dict(_flatten(_params(params)), _vae_module_name)


def load_flax_params(module: torch.nn.Module, params) -> torch.nn.Module:
    """Load flax params into ``module`` (strict: every key must match)."""
    module.load_state_dict(flax_to_state_dict(params), strict=True)
    return module
