"""Local shards for the kernels, and the collectives of head tensor
parallelism (the counterpart of ttt_video_dit_tpu/ops/pallas/sharded.py).

``pl.pallas_call`` has no GSPMD rule, so the JAX package runs each TTT
kernel under ``shard_map`` on the local batch and heads. Here the same
problem has two forms: the ctypes wrappers read ``data_ptr()``, which means
nothing on a DTensor, and the ``torch.library`` custom ops (K1-train,
K5-train, K3-lse) have no DTensor sharding strategy. So a module turns its
head-sharded DTensor parameters into local tensors with :func:`local`
(autograd-aware ``to_local``) before any kernel or custom op, and the
kernels run on the local heads with no collective; a DTensor that reaches a
wrapper raises (:func:`refuse_dtensors`).

:class:`TensorParallel` holds a module's tensor group and the four
autograd-aware collectives around the head-local work (Megatron's f and g,
and a split and a gather along the feature dimension); on a group of one
each is the identity. Whatever a rank computes outside the head-local work
is replicated over the group, so every replicated parameter gets the same
gradient on every rank of it.
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, distribute_tensor


def local_head_count(H: int, tp: int) -> int:
    """Heads per rank under a tensor axis of ``tp`` ranks: H / tp when the
    axis divides H, else H (the axis is dropped, as the JAX package's
    ``local_head_count`` drops it)."""
    return H // tp if tp > 1 and H % tp == 0 else H


def local(t):
    """A DTensor's local shard (autograd-aware); any other tensor as it is."""
    return t.to_local() if isinstance(t, DTensor) else t


def full(t):
    """A DTensor's full tensor (a collective on every rank of its mesh); any other tensor as it is."""
    return t.full_tensor() if isinstance(t, DTensor) else t


def refuse_dtensors(where: str, *tensors) -> None:
    """Raise TypeError if any of ``tensors`` is a DTensor: a kernel wrapper
    takes local tensors only (:func:`local`)."""
    for t in tensors:
        if isinstance(t, DTensor):
            raise TypeError(f"{where} got a DTensor {tuple(t.shape)} {t.placements}: the kernels take local "
                            f"tensors; pass its local shard (parallel/sharded.py:local)")


@torch.no_grad()
def copy_full_(dst, src) -> None:
    """Copy the full tensor ``src`` into ``dst`` in place: into a plain
    tensor whole, into a DTensor its own shard (sliced on this rank; no
    collective). ``src`` is cast to ``dst``'s dtype and device."""
    if isinstance(dst, DTensor):
        src = src.to(device=dst.device, dtype=dst.dtype)
        src = distribute_tensor(src, dst.device_mesh, dst.placements, src_data_rank=None).to_local()
        dst = dst.to_local()
    dst.copy_(src)


def square_sum(tensors) -> torch.Tensor:
    """The sum of squares of every tensor, in float32, over the full tensors.
    A DTensor adds its local shard's sum divided by the count of ranks that
    hold the same shard (the world over its distinct shards), and one
    all-reduce over the world sums the ranks; without a DTensor the sum is
    local, summed in the order given. Parameters and their gradients are
    never partial (FSDP2 reduce-scatters them)."""
    shares, sharded = [], False
    for t in tensors:
        if isinstance(t, DTensor):
            if any(p.is_partial() for p in t.placements):
                raise ValueError(f"square_sum takes no partial DTensor, got {t.placements}")
            shards = math.prod(t.device_mesh.size(i) for i, p in enumerate(t.placements) if not p.is_replicate())
            s = t.to_local().float()
            shares.append(((s * s).sum(), shards))
            sharded = True
        else:
            shares.append(((t.float() * t.float()).sum(), 1))
    if not sharded:
        return sum(s for s, _ in shares)
    world = dist.get_world_size()
    total = sum(s * (shards / world) for s, shards in shares)
    dist.all_reduce(total)
    return total


class _Copy(torch.autograd.Function):
    """Identity forward; the backward all-reduces the gradient over the group
    (a replicated input feeding head-local work)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Reduce(torch.autograd.Function):
    """All-reduce forward (partial sums over heads); identity backward."""

    @staticmethod
    def forward(ctx, x, group):
        y = x.contiguous().clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Split(torch.autograd.Function):
    """This rank's chunk along ``dim``; the backward all-gathers the chunks'
    gradients (a replicated tensor consumed by head-local work)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return x.chunk(size, dim)[rank].contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = [torch.empty_like(g) for _ in range(ctx.size)]
        dist.all_gather(parts, g.contiguous(), group=ctx.group)
        return torch.cat(parts, dim=ctx.dim), None, None, None, None


class _Gather(torch.autograd.Function):
    """The chunks of every rank concatenated along ``dim``; the backward takes
    this rank's chunk (the gathered tensor feeds replicated work)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.size, ctx.rank = dim, size, rank
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(size)]
        dist.all_gather(parts, x, group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, ctx.dim)[ctx.rank].contiguous(), None, None, None, None


class TensorParallel:
    """A module's tensor group: its size, this rank's index in it, and the
    collectives of head tensor parallelism. ``mesh``: the 1-D ``tensor``
    submesh, or None for no tensor parallelism (a group of one)."""

    def __init__(self, mesh=None):
        self.group = None if mesh is None else mesh.get_group()
        self.size = 1 if mesh is None else mesh.size()
        self.rank = 0 if mesh is None else mesh.get_local_rank()

    def local_heads(self, H: int) -> int:
        return local_head_count(H, self.size)

    def copy(self, x):
        """Identity; the gradient is all-reduced over the group."""
        return x if self.size == 1 else _Copy.apply(x, self.group)

    def reduce(self, x):
        """The sum over the group; the gradient passes through."""
        return x if self.size == 1 else _Reduce.apply(x, self.group)

    def split(self, x, dim: int):
        """This rank's chunk along ``dim``; the gradients are gathered."""
        return x if self.size == 1 else _Split.apply(x, dim, self.group, self.size, self.rank)

    def gather(self, x, dim: int):
        """Every rank's chunk along ``dim``, concatenated; the gradient is split."""
        return x if self.size == 1 else _Gather.apply(x, dim, self.group, self.size, self.rank)


NO_TENSOR_PARALLEL = TensorParallel()
