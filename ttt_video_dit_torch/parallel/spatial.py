"""The VAE split over H across the ranks of a process group: the port's form
of the JAX package's ``VideoAutoencoder(mesh=...)``
(ttt_video_dit_tpu/models/vae/autoencoder.py:53-83), where GSPMD shards
pixel and latent tiles over H across every device and inserts the halo
exchanges and GroupNorm all-reduces. Here they are written out:

- **Split**: latent rows as evenly as possible, the first ``h mod N`` ranks
  one more; a rank's pixel rows are ``factor`` (8 for the CogVideoX VAE) x
  its latent rows, so every level of the encoder and decoder splits at the
  same places, and no rank sees a row of another's at any level.
- **Halo rows** (:meth:`SpatialShard.halo`): before each spatial conv a rank
  takes the rows its window needs from the ranks above and below; the
  outermost ranks take zero rows, as the conv's own zero padding gives.
- **GroupNorm** (:meth:`SpatialShard.group_norm`): each group's sum and sum
  of squares in float32, all-reduced, then mean and E[x^2] - E[x]^2 (the
  fast variance of flax's GroupNorm).

What needs no exchange: 1x1 convs, the temporal conv cache (time is not
split), the decoder's nearest resize of zq (the splits line up), the
temporal resampling. Inference only (no backward). The collectives are
``torch.distributed``'s: NCCL on the card, gloo on the CPU.

``VideoAutoencoder(group=...)`` makes a :class:`SpatialShard` for a group of
two or more ranks and activates it around each encode and decode
(:func:`sharded`); ``models/vae/enc_dec.py`` asks :func:`current` at each
spatial conv and norm, and runs its unsharded code when there is none.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
import torch.distributed as dist
import torch.nn.functional as Fn

_ACTIVE: contextvars.ContextVar["SpatialShard | None"] = contextvars.ContextVar("vae_spatial_shard", default=None)


def split_rows(h: int, n: int) -> list[tuple[int, int]]:
    """(start, stop) of each of ``n`` ranks' rows of ``h``: as even as can be,
    the first ``h mod n`` ranks one more. Raises ValueError when a rank
    would get none."""
    if h < n:
        raise ValueError(f"{h} latent rows cannot be split over {n} ranks (each rank needs one)")
    base, extra = divmod(h, n)
    starts = [r * base + min(r, extra) for r in range(n + 1)]
    return list(zip(starts[:-1], starts[1:]))


class SpatialShard:
    """This rank's place in an H split over ``group`` (two or more ranks)."""

    def __init__(self, group: dist.ProcessGroup):
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self._peers = [dist.get_global_rank(group, r) for r in range(self.size)]

    # -- the split ------------------------------------------------------------
    def check_same_shape(self, x: torch.Tensor) -> None:
        """Raise ValueError, naming every rank's shape, unless all ranks hold an input of one shape."""
        mine = torch.full((9,), -1, dtype=torch.int64)
        mine[0] = x.dim()
        mine[1 : 1 + x.dim()] = torch.tensor(x.shape)
        shapes = [torch.empty(9, dtype=torch.int64, device=x.device) for _ in range(self.size)]
        dist.all_gather(shapes, mine.to(x.device), group=self.group)
        shapes = [tuple(s[1 : 1 + s[0]].tolist()) for s in (t.cpu() for t in shapes)]
        if len(set(shapes)) != 1:
            raise ValueError("the ranks of the VAE's group hold inputs of different shapes: "
                             + ", ".join(f"rank {r} {list(s)}" for r, s in enumerate(shapes)))

    def gather_rows(self, x: torch.Tensor, counts: list[int]) -> torch.Tensor:
        """Every rank's rows of x (H the second-to-last axis; rank r holds
        ``counts[r]``), concatenated in rank order."""
        most = max(counts)
        padded = Fn.pad(x, (0, 0, 0, most - x.shape[-2])).contiguous()
        parts = [torch.empty_like(padded) for _ in range(self.size)]
        dist.all_gather(parts, padded, group=self.group)
        return torch.cat([p[..., :c, :] for p, c in zip(parts, counts)], dim=-2)

    # -- the halo -------------------------------------------------------------
    def halo(self, x: torch.Tensor, top: int, bottom: int) -> torch.Tensor:
        """x (H the second-to-last axis) with the last ``top`` rows of the rank
        above on top and the first ``bottom`` rows of the rank below under it;
        zero rows at the edges of the whole."""
        ops, recv = [], {}
        if top:
            recv["top"] = x.new_zeros(*x.shape[:-2], top, x.shape[-1])
        if bottom:
            recv["bottom"] = x.new_zeros(*x.shape[:-2], bottom, x.shape[-1])
        if top and self.rank > 0:
            ops.append(dist.P2POp(dist.irecv, recv["top"], self._peers[self.rank - 1], self.group))
        if bottom and self.rank < self.size - 1:
            ops.append(dist.P2POp(dist.irecv, recv["bottom"], self._peers[self.rank + 1], self.group))
        if top and self.rank < self.size - 1:  # my last rows are the top halo of the rank below
            ops.append(dist.P2POp(dist.isend, x[..., -top:, :].contiguous(), self._peers[self.rank + 1], self.group))
        if bottom and self.rank > 0:  # my first rows are the bottom halo of the rank above
            ops.append(dist.P2POp(dist.isend, x[..., :bottom, :].contiguous(), self._peers[self.rank - 1], self.group))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return torch.cat([t for t in (recv.get("top"), x, recv.get("bottom")) if t is not None], dim=-2)

    # -- the norm -------------------------------------------------------------
    def group_norm(self, norm: torch.nn.GroupNorm, x: torch.Tensor) -> torch.Tensor:
        """``norm`` over the whole H: each group's sum and sum of squares in
        float32 over this rank's rows, all-reduced over the group, then
        mean and E[x^2] - E[x]^2, applied as one scale and shift a channel."""
        B, C = x.shape[:2]
        G = norm.num_groups
        xg = x.reshape(B, G, -1).float()
        var, mean = torch.var_mean(xg, dim=-1, correction=0)
        n = float(xg.shape[-1])
        moments = torch.stack([mean * n, (var + mean * mean) * n, torch.full_like(mean, n)])
        dist.all_reduce(moments, group=self.group)
        total, squares, count = moments
        mean = total / count
        rstd = torch.rsqrt(squares / count - mean * mean + norm.eps)
        scale = rstd.repeat_interleave(C // G, dim=1)  # [B, C]
        shift = -mean.repeat_interleave(C // G, dim=1) * scale
        if norm.affine:
            scale, shift = scale * norm.weight, shift * norm.weight + norm.bias
        shape = (B, C) + (1,) * (x.dim() - 2)
        return torch.addcmul(shift.reshape(shape), x, scale.reshape(shape)).to(x.dtype)


def current() -> SpatialShard | None:
    """The H split of the encode or decode running in this context, if any."""
    return _ACTIVE.get()


@contextlib.contextmanager
def sharded(shard: SpatialShard | None):
    """Run the VAE's modules split as ``shard`` says (unsplit for None)."""
    token = _ACTIVE.set(shard)
    try:
        yield
    finally:
        _ACTIVE.reset(token)
