"""Local shards for the kernels, and the collectives of sequence and head
tensor parallelism (the counterpart of ttt_video_dit_tpu/ops/pallas/sharded.py).

``pl.pallas_call`` has no GSPMD rule, so the JAX package runs each TTT
kernel under ``shard_map`` on the local batch and heads. Here the same
problem has two forms: the ctypes wrappers read ``data_ptr()``, which means
nothing on a DTensor, and the ``torch.library`` custom ops (K1-train,
K5-train, K3-lse) have no DTensor sharding strategy. So a module turns its
head-sharded DTensor parameters into local tensors with :func:`local`
(autograd-aware ``to_local``) before any kernel or custom op, and the
kernels run on the local heads with no collective; a DTensor that reaches a
wrapper raises (:func:`refuse_dtensors`).

:class:`TensorParallel` holds a module's tensor group and the collectives of
sequence parallelism (the counterpart of the JAX package's ``shard_boundary``
and ``maybe_shard`` constraints, parallel/mesh.py:92-143, which GSPMD turns
into the same collectives). Between the head-local blocks the [B, L, D]
stream is token-sharded over the group: each rank holds its rows of the
joined [text; video] stream (:meth:`TensorParallel.shard`), and the adaLN
modulation, the LayerNorms, the gates, the residual adds and the MLP run on
them with the replicated parameters. The head-local work gathers the tokens
(:meth:`~TensorParallel.all_gather`; its backward reduce-scatters) and hands
back its partial sums over heads by a reduce-scatter over tokens
(:meth:`~TensorParallel.reduce_scatter`; its backward all-gathers). So every
replicated parameter sees only this rank's tokens or heads and gets a
partial gradient, which training sums over the group before the clip
(parallel/sharding.py:sum_replicated_grads). On a group of one each
collective is the identity and the code is the one-device code.
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


def _all_gather(x, dim: int, group, size: int):
    """Every rank's ``x`` concatenated along ``dim``, contiguous: one
    all-gather into [size, *x.shape], then a copy that puts each rank's
    chunk in its place along ``dim`` (none when the axes before ``dim`` are
    of length 1, as the token axis of one batch row)."""
    dim %= x.ndim
    parts = x.new_empty((size,) + x.shape)
    dist.all_gather_into_tensor(parts.view(-1), x.contiguous().view(-1), group=group)  # flat: any backend's layout
    return parts.movedim(0, dim).reshape(x.shape[:dim] + (size * x.shape[dim],) + x.shape[dim + 1 :])


def _reduce_scatter(x, dim: int, group, size: int):
    """This rank's chunk along ``dim`` of the sum of every rank's ``x``,
    contiguous: one reduce-scatter of ``x`` with its ``size`` chunks laid out
    first (a copy, but none when the axes before ``dim`` are of length 1)."""
    dim %= x.ndim
    n = x.shape[dim] // size
    chunks = x.reshape(x.shape[:dim] + (size, n) + x.shape[dim + 1 :]).movedim(dim, 0).contiguous()
    out = x.new_empty(x.shape[:dim] + (n,) + x.shape[dim + 1 :])
    dist.reduce_scatter_tensor(out.view(-1), chunks.view(-1), group=group)
    return out


class _AllGather(torch.autograd.Function):
    """The chunks of every rank concatenated along ``dim``; the backward
    reduce-scatters the gradient (the gathered tensor feeds head-local work,
    so each rank's gradient of it is a partial sum)."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, ctx.dim, ctx.group, ctx.size), None, None, None


class _ReduceScatter(torch.autograd.Function):
    """This rank's chunk along ``dim`` of the sum over the group (partial sums
    over heads); the backward all-gathers the chunks' gradients."""

    @staticmethod
    def forward(ctx, x, dim, group, size):
        ctx.dim, ctx.group, ctx.size = dim, group, size
        return _reduce_scatter(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group, ctx.size), None, None, None


class _Gather(torch.autograd.Function):
    """The chunks of every rank concatenated along ``dim``; the backward takes
    this rank's chunk (the gathered tensor feeds replicated work: the loss)."""

    @staticmethod
    def forward(ctx, x, dim, group, size, rank):
        ctx.dim, ctx.size, ctx.rank = dim, size, rank
        return _all_gather(x, dim, group, size)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.size, ctx.dim)[ctx.rank].contiguous(), None, None, None, None


def _pad_to(x, dim: int, n: int):
    """``x`` with zeros appended along ``dim`` up to length ``n``."""
    dim %= x.ndim
    extra = n - x.shape[dim]
    if not extra:
        return x
    return torch.cat([x, x.new_zeros(x.shape[:dim] + (extra,) + x.shape[dim + 1 :])], dim=dim)


class TensorParallel:
    """A module's tensor group: its size, this rank's index in it, and the
    collectives of sequence and head tensor parallelism. ``mesh``: the 1-D
    ``tensor`` submesh, or None for no tensor parallelism (a group of one,
    where every method returns its input).

    A token axis of length L is split into ``rows(L)`` = ceil(L / size) rows
    a rank, rank r holding rows [r * rows, (r + 1) * rows): a length the
    group does not divide is padded with zero rows at the end, which the
    gathers drop again (:meth:`shard`, :meth:`all_gather`), where the JAX
    package's ``shard_boundary`` falls back to the feature axis."""

    def __init__(self, mesh=None):
        self.group = None if mesh is None else mesh.get_group()
        self.size = 1 if mesh is None else mesh.size()
        self.rank = 0 if mesh is None else mesh.get_local_rank()

    def local_heads(self, H: int) -> int:
        return local_head_count(H, self.size)

    def rows(self, L: int) -> int:
        """The rows of a length-``L`` axis each rank holds."""
        return -(-L // self.size)

    def shard(self, x, dim: int = 1):
        """This rank's rows of ``x`` along ``dim`` (zero-padded to ``size *
        rows``), in storage of their own. A plain slice: the gradient is zero
        outside the rank's rows, so a replicated parameter upstream gets a
        partial gradient, summed over the group with the others
        (parallel/sharding.py:sum_replicated_grads)."""
        if self.size == 1:
            return x
        n = self.rows(x.shape[dim])
        return _pad_to(x, dim, n * self.size).narrow(dim, self.rank * n, n).clone()

    def all_gather(self, x, length: int, dim: int = 1):
        """Every rank's rows along ``dim``, concatenated and cut to ``length``;
        the gradient is reduce-scattered (the inverse of :meth:`shard`, for
        head-local work)."""
        if self.size == 1:
            return x
        return _AllGather.apply(x, dim, self.group, self.size).narrow(dim, 0, length)

    def reduce_scatter(self, x, dim: int = 1):
        """This rank's rows along ``dim`` of the sum over the group of ``x``
        (each rank's partial sums over its heads, zero-padded to ``size *
        rows``); the gradient is all-gathered."""
        if self.size == 1:
            return x
        x = _pad_to(x, dim, self.rows(x.shape[dim]) * self.size)
        return _ReduceScatter.apply(x, dim, self.group, self.size)

    def gather(self, x, dim: int):
        """Every rank's chunk along ``dim``, concatenated; the gradient is this
        rank's chunk of it (the gathered tensor feeds replicated work)."""
        return x if self.size == 1 else _Gather.apply(x, dim, self.group, self.size, self.rank)


NO_TENSOR_PARALLEL = TensorParallel()
