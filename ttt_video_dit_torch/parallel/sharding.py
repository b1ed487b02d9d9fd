"""Parameter placement over the (replica, fsdp, tensor) mesh (port of
ttt_video_dit_tpu/parallel/sharding.py:33-108).

The tensor axis follows the JAX package's ``PARAM_RULES``, on the port's
flax-mirrored parameter paths (``training/optimizer.py:flax_path``) and its
torch layouts (a ``Linear`` weight is [out, in], a flax kernel [in, out]):

- ``attention/(q|k|v)`` and ``ssm/(wq|wk|wv)``: column-parallel, the weight
  sharded on its output (head) dim; their biases stay replicated, as in
  the JAX rules, and each rank adds its chunk (``Linear.forward``);
- ``attention/o`` and ``ssm/wo``: row-parallel, the weight sharded on its
  input (head) dim; the partial sums are all-reduced, then the replicated
  bias is added;
- ``ssm/(W1|W2|b1|b2)``, ``ssm/ttt_norm_*`` and ``ssm/learnable_ttt_lr_*``:
  sharded on the head axis (dim 0);
- everything else (the MLP, adaLN, norms, gates, embeddings) is replicated
  over ``tensor``.

Sequence parallelism comes with the tensor axis (no flag of its own, as the
JAX package's constraints apply whenever its mesh has a tensor axis): the
stream between the head-local blocks is token-sharded over ``tensor``
(models/dit/dit.py, parallel/sharded.py), so each layer-group checkpoint
saves 1/tp of the stream, what ``[remat] shard_transformer_inputs`` asks
of the JAX package. Every replicated parameter then sees a token shard (the
MLP, adaLN, LayerNorms, gates, final layer, patch and time embeddings) or a
head shard (the q/k norms, the post-norm, the q/k/v/o and wq/wk/wv/wo
biases) and gets a partial gradient on each tensor rank:
:func:`sum_replicated_grads` sums them over the group before the clip and
the step (FSDP2 reduces over the data axes only).

An axis that does not divide its dim is dropped, as ``_spec_for`` drops it.
On a tensor axis of one rank the Shard placement is kept (a no-op), so one
card runs the code of N cards; the JAX package drops size-1 axes instead.
A model whose head count the axis does not divide is refused: a head split
across ranks would break the head-local kernels.

The data axes: FSDP2 ``fully_shard`` wraps each ``TransformerLayer``, then
the root, over ``mesh["replica", "fsdp"]`` (HSDP: replicated over
``replica``, sharded over ``fsdp``), as the reference does. FSDP2 shards dim
0 of each parameter, where the JAX rules pick a dim per parameter: the
layouts differ, what a rank computes does not. The all-gathers stay float32
and training casts each gathered, tensor-local weight itself (K7 under
``scan_layers``), so the numbers equal the one-card path's. Tensor
parallelism is applied first, then FSDP2; the per-layer
``torch.utils.checkpoint`` (models/dit/dit.py) runs each layer's FSDP
pre-forward hook inside the checkpointed region, so a recompute gathers
again. Sampling applies the tensor axis only (no FSDP): the weights are
cast once and every data rank holds them.
"""

from __future__ import annotations

import re

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.fsdp import fully_shard
from torch.distributed.tensor import Shard, distribute_tensor

from ttt_video_dit_torch.parallel.mesh import FSDP, REPLICA, TENSOR
from ttt_video_dit_torch.parallel.sharded import TensorParallel, local
from ttt_video_dit_torch.training.optimizer import flax_path

# (regex over the flax-mirrored path, the torch dim sharded over ``tensor``).
TENSOR_RULES = (
    (r"attention/(q|k|v)/weight$", 0),  # column-parallel: out = heads
    (r"attention/o/weight$", 1),  # row-parallel: in = heads
    (r"ssm/(wq|wk|wv)/weight$", 0),
    (r"ssm/wo/weight$", 1),
    (r"ssm/(W1|W2|b1|b2)$", 0),
    (r"ssm/ttt_norm_(weight|bias)$", 0),
    (r"ssm/learnable_ttt_lr_(weight|bias)$", 0),
)
LINEAR_STYLES = {0: "colwise", 1: "rowwise"}


def tensor_dim(path: str, shape, tp: int) -> int | None:
    """The dim of the parameter at flax-mirrored ``path`` sharded over a
    tensor axis of ``tp`` ranks, or None (replicated, or dropped because the
    axis does not divide it)."""
    for pattern, dim in TENSOR_RULES:
        if re.search(pattern, path):
            return dim if shape[dim] % tp == 0 else None
    return None


def apply_tensor_parallel(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """Shard ``model``'s head-structured parameters over ``mesh["tensor"]``
    in place (DTensors, each rank slicing its own shard of the full
    parameter it holds), give the DiT, its sequence-modeling blocks, the
    attention, TTT and their Linears the tensor group, and record the
    replicated parameters' names for :func:`sum_replicated_grads`."""
    from ttt_video_dit_torch.models.dit.dit import DiffusionTransformer, SegmentLocalAttention, SeqModelingBlock
    from ttt_video_dit_torch.models.ttt.layer import Linear, TTTLayer

    tp_mesh = mesh[TENSOR]
    tp = tp_mesh.size()
    H = model.config.num_heads
    if H % tp:
        raise ValueError(f"--parallelism.tp_sharding {tp} does not divide the {H} heads (--model.num_heads)")
    group = TensorParallel(tp_mesh)
    replicated = []
    for name, module in model.named_modules():
        if isinstance(module, (DiffusionTransformer, SeqModelingBlock, SegmentLocalAttention, TTTLayer)):
            module.tp = group
        for pname, p in list(module.named_parameters(recurse=False)):
            full_name = f"{name}.{pname}" if name else pname
            dim = tensor_dim(flax_path(full_name), p.shape, tp)
            if dim is None:
                replicated.append(full_name)
                continue
            sharded = distribute_tensor(p.detach(), tp_mesh, [Shard(dim)], src_data_rank=None)
            module.register_parameter(pname, nn.Parameter(sharded, requires_grad=p.requires_grad))
            if isinstance(module, Linear) and pname == "weight":
                module.tp, module.style = group, LINEAR_STYLES[dim]
    model.tensor_parallel, model.tensor_replicated = group, frozenset(replicated)
    return model


@torch.no_grad()
def sum_replicated_grads(model: nn.Module) -> None:
    """Sum the gradient of every parameter the tensor rules replicate over
    the tensor group, in place (one all-reduce each), so that every tensor
    rank holds the whole gradient; a rank with none (a row-parallel bias off
    rank 0) adds zeros. A no-op without tensor parallelism."""
    tp = getattr(model, "tensor_parallel", None)
    if tp is None or tp.size == 1:
        return
    for name, p in model.named_parameters():
        if name in model.tensor_replicated and p.requires_grad:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            dist.all_reduce(local(p.grad), group=tp.group)


def apply_fsdp(model: nn.Module, mesh: DeviceMesh) -> nn.Module:
    """FSDP2 over ``mesh["replica", "fsdp"]``: each TransformerLayer, then the root."""
    data_mesh = mesh[REPLICA, FSDP]
    for layer in model.dit.layers:
        fully_shard(layer, mesh=data_mesh)
    fully_shard(model, mesh=data_mesh)
    return model


def parallelize(model: nn.Module, mesh: DeviceMesh, fsdp: bool = True) -> nn.Module:
    """Tensor parallelism, then (training) FSDP2."""
    apply_tensor_parallel(model, mesh)
    return apply_fsdp(model, mesh) if fsdp else model
