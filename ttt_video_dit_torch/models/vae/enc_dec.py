"""3D causal VAE encoder and decoder of CogVideoX (port of
ttt_video_dit_tpu/models/vae/enc_dec.py).

ResNet-style 3D halves with causal temporal convolutions (a frame sees only
past frames), 4x temporal and 8x spatial compression, GroupNorm(32) in the
encoder and zq-modulated norms in the decoder, and first-frame-special
temporal resampling. The layout is NCTHW, PyTorch's and cuDNN's. The
submodules carry the reference's torch names (``down.<l>.block.<b>``,
``down.<l>.downsample``, ``mid.block_1``, ``up.<l>.upsample``,
``norm1.norm_layer``, ``conv_in.conv``, ...), so the reference's checkpoint
loads with a plain ``load_state_dict(strict=True)``.

The conv cache: each :class:`CausalConv3d` with a temporal kernel pads its
input with kt - 1 frames, copies of the first frame for the first temporal
window of a video, else the last kt - 1 input frames of the previous window.
The caller owns that state: ``Encoder3D``/``Decoder3D`` take a ``cache``
dict (empty for a video's first window) and leave each conv's tail in it
for the next window; a new video starts from a new dict, so nothing carries
from one video into the next.

Split over H across ranks (``parallel/spatial.py``): inside
``spatial.sharded(shard)`` each spatial conv takes its halo rows from the
neighbouring ranks first (zero rows at the edges of the whole) and each
GroupNorm all-reduces its moments; outside it (one device) every module
runs its plain code.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from ttt_video_dit_torch.config.model_config import VaeModelConfig
from ttt_video_dit_torch.parallel import spatial

# The reference's SafeConv3d splits a conv whose input exceeds 2 GB into
# temporal parts: cuDNN refuses or mis-indexes larger tensors. Splitting a
# causal conv with its (kt - 1)-frame halo is exact.
CONV_CHUNK_BYTES = 2**31


def _conv_time_chunks(t_out: int, nbytes: int, limit: int):
    """Split t_out output frames into equal-ish chunks so each chunk's input
    stays under ``limit`` bytes. Returns (start, stop) output ranges; one
    full-range chunk means "don't split"."""
    if nbytes <= limit or t_out <= 1:
        return [(0, t_out)]
    n = min(-(-nbytes // limit), t_out)
    step = -(-t_out // n)
    return [(s, min(s + step, t_out)) for s in range(0, t_out, step)]


def _group_norm(channels: int) -> nn.GroupNorm:
    return nn.GroupNorm(32, channels, eps=1e-6)


def _norm(norm: nn.GroupNorm, x):
    """``norm(x)``, its moments over every rank's rows when H is split."""
    shard = spatial.current()
    return norm(x) if shard is None else shard.group_norm(norm, x)


def _split_conv(conv, x):
    """(the conv to apply, its input): ``conv`` and ``x`` on one device;
    with H split, x with its halo rows and ``conv``'s weights with no H
    padding (the halo takes its place)."""
    shard = spatial.current()
    ph = conv.padding[-2]
    if shard is None or not ph:
        return conv, x
    fn = Fn.conv3d if isinstance(conv, nn.Conv3d) else Fn.conv2d
    padding = (*conv.padding[:-2], 0, conv.padding[-1])
    split = functools.partial(fn, weight=conv.weight, bias=conv.bias, stride=conv.stride, padding=padding)
    return split, shard.halo(x, ph, ph)


class CausalConv3d(nn.Module):
    """3D conv, causal in time (reference: ContextParallelCausalConv3d)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=(3, 3, 3)):
        super().__init__()
        kt, kh, kw = kernel_size
        self.kt = kt
        self.conv = nn.Conv3d(in_channels, out_channels, kernel_size, padding=(0, kh // 2, kw // 2))

    def forward(self, x, cache: dict):
        kt = self.kt
        if kt > 1:
            prev = cache.get(self)
            pad = x[:, :, :1].expand(-1, -1, kt - 1, -1, -1) if prev is None else prev
            x = torch.cat([pad, x], dim=2)
            cache[self] = x[:, :, -(kt - 1):].clone()  # a copy: a view would keep the window alive
        conv, x = _split_conv(self.conv, x)
        t_out = x.shape[2] - (kt - 1)
        chunks = _conv_time_chunks(t_out, x.numel() * x.element_size(), CONV_CHUNK_BYTES)
        if len(chunks) == 1:
            return conv(x)
        # Output range [s, e) reads input frames [s, e + kt - 1).
        return torch.cat([conv(x[:, :, s : e + kt - 1]) for s, e in chunks], dim=2)


def _nearest_resize(x, size):
    """Nearest-neighbour resize of [B, C, T, H, W] to ``size`` (T', H', W')
    with half-pixel centres, as ``jax.image.resize(method="nearest")``."""
    return Fn.interpolate(x, size=tuple(size), mode="nearest-exact")


class SpatialNorm3D(nn.Module):
    """GroupNorm modulated by a nearest-resized projection of the latent zq
    (reference: cp_enc_dec.py:447-506)."""

    def __init__(self, f_channels: int, zq_channels: int):
        super().__init__()
        self.norm_layer = _group_norm(f_channels)
        self.conv_y = CausalConv3d(zq_channels, f_channels, (1, 1, 1))
        self.conv_b = CausalConv3d(zq_channels, f_channels, (1, 1, 1))

    def forward(self, f, zq, cache: dict):
        T, H, W = f.shape[2:]
        if T > 1 and T % 2 == 1:
            # The first frame resized alone (temporal causality of the upsampling).
            zq = torch.cat([_nearest_resize(zq[:, :, :1], (1, H, W)), _nearest_resize(zq[:, :, 1:], (T - 1, H, W))],
                           dim=2)
        else:
            zq = _nearest_resize(zq, (T, H, W))
        return _norm(self.norm_layer, f) * self.conv_y(zq, cache) + self.conv_b(zq, cache)


def _repeat2(x, dims):
    for d in dims:
        x = x.repeat_interleave(2, dim=d)
    return x


def _per_frame(conv: nn.Conv2d, x):
    """A 2-D conv applied to every frame of [B, C, T, H, W] (with its halo rows when H is split)."""
    conv, x = _split_conv(conv, x)
    B, C, T, H, W = x.shape
    y = conv(x.transpose(1, 2).reshape(B * T, C, H, W))
    return y.reshape(B, T, *y.shape[1:]).transpose(1, 2)


class Upsample3D(nn.Module):
    """2x spatial (and optionally causal 2x temporal) nearest upsampling, then
    a 3x3 conv per frame (reference: cp_enc_dec.py:527-564)."""

    def __init__(self, in_channels: int, out_channels: int, compress_time: bool = False):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(in_channels, out_channels, 3, padding=1)

    def forward(self, x):
        T = x.shape[2]
        if self.compress_time and T > 1:
            if T % 2 == 1:
                # The first frame upsamples spatially only; the rest 2x in time too.
                x = torch.cat([_repeat2(x[:, :, :1], (3, 4)), _repeat2(x[:, :, 1:], (2, 3, 4))], dim=2)
            else:
                x = _repeat2(x, (2, 3, 4))
        else:
            x = _repeat2(x, (3, 4))
        return _per_frame(self.conv, x)


class DownSample3D(nn.Module):
    """Stride-2 conv per frame after a (0, 1) spatial pad (and optionally a
    causal 2x temporal average first) (reference: cp_enc_dec.py:567-607)."""

    def __init__(self, in_channels: int, out_channels: int, compress_time: bool = False):
        super().__init__()
        self.compress_time = compress_time
        self.conv = nn.Conv2d(in_channels, out_channels, 3, stride=2, padding=0)

    def forward(self, x):
        B, C, T, H, W = x.shape
        if self.compress_time and T > 1:
            if T % 2 == 1:
                first, rest = x[:, :, :1], x[:, :, 1:]
                if rest.shape[2] > 0:
                    rest = rest.reshape(B, C, (T - 1) // 2, 2, H, W).mean(dim=3)
                x = torch.cat([first, rest], dim=2)
            else:
                x = x.reshape(B, C, T // 2, 2, H, W).mean(dim=3)
        shard = spatial.current()
        if shard is not None:  # the next rank's first row in place of the bottom pad (a zero row at the end)
            return _per_frame(self.conv, Fn.pad(shard.halo(x, 0, 1), (0, 1)))
        return _per_frame(self.conv, Fn.pad(x, (0, 1, 0, 1)))


class ResnetBlock3D(nn.Module):
    """norm -> swish -> causal conv, twice, with a residual (a 1x1x1 conv
    where the width changes) (reference: cp_enc_dec.py:610-711)."""

    def __init__(self, in_channels: int, out_channels: int, zq_channels: int | None = None):
        super().__init__()
        if zq_channels is None:
            self.norm1, self.norm2 = _group_norm(in_channels), _group_norm(out_channels)
        else:  # decoder blocks: zq-modulated norms
            self.norm1 = SpatialNorm3D(in_channels, zq_channels)
            self.norm2 = SpatialNorm3D(out_channels, zq_channels)
        self.conv1 = CausalConv3d(in_channels, out_channels)
        self.conv2 = CausalConv3d(out_channels, out_channels)
        if in_channels != out_channels:
            self.nin_shortcut = nn.Conv3d(in_channels, out_channels, 1)

    def _norm(self, norm, h, zq, cache):
        return norm(h, zq, cache) if isinstance(norm, SpatialNorm3D) else _norm(norm, h)

    def forward(self, x, cache: dict, zq=None):
        h = self.conv1(Fn.silu(self._norm(self.norm1, x, zq, cache)), cache)
        h = self.conv2(Fn.silu(self._norm(self.norm2, h, zq, cache)), cache)
        if hasattr(self, "nin_shortcut"):
            x = self.nin_shortcut(x)
        return x + h


class _Level(nn.Module):
    """One resolution level: ``block`` and an optional ``downsample``/``upsample``."""

    def __init__(self, blocks, resample_name: str | None = None, resample=None):
        super().__init__()
        self.block = nn.ModuleList(blocks)
        if resample_name is not None:
            setattr(self, resample_name, resample)


class _Mid(nn.Module):
    def __init__(self, channels: int, zq_channels: int | None = None):
        super().__init__()
        self.block_1 = ResnetBlock3D(channels, channels, zq_channels)
        self.block_2 = ResnetBlock3D(channels, channels, zq_channels)


class Encoder3D(nn.Module):
    """Causal 3D encoder: pixels [B, 3, T, H, W] -> posterior parameters
    [B, 2 z, 1 + (T - 1) / 4, H / 8, W / 8] (reference: ContextParallelEncoder3D)."""

    def __init__(self, config: VaeModelConfig, temporal_compress_times: int = 4):
        super().__init__()
        cfg = config
        temporal_level = int(np.log2(temporal_compress_times))
        self.spatial_factor = 2 ** (len(cfg.ch_mult) - 1)  # pixel rows per latent row
        self.conv_in = CausalConv3d(cfg.in_channels, cfg.ch)
        self.down = nn.ModuleList()
        block_in = cfg.ch
        for i_level, mult in enumerate(cfg.ch_mult):
            block_out = cfg.ch * mult
            blocks = [ResnetBlock3D(block_in if b == 0 else block_out, block_out) for b in range(cfg.num_res_blocks)]
            last = i_level == len(cfg.ch_mult) - 1
            self.down.append(_Level(blocks, None if last else "downsample",
                                    None if last else DownSample3D(block_out, block_out, i_level < temporal_level)))
            block_in = block_out
        self.mid = _Mid(block_in)
        self.norm_out = _group_norm(block_in)
        self.conv_out = CausalConv3d(block_in, 2 * cfg.z_channels if cfg.double_z else cfg.z_channels)

    def forward(self, x, cache: dict):
        h = self.conv_in(x, cache)
        for level in self.down:
            for block in level.block:
                h = block(h, cache)
            if hasattr(level, "downsample"):
                h = level.downsample(h)
        h = self.mid.block_2(self.mid.block_1(h, cache), cache)
        return self.conv_out(Fn.silu(_norm(self.norm_out, h)), cache)


class Decoder3D(nn.Module):
    """Causal 3D decoder: latents [B, z, t, h, w] -> pixels
    [B, 3, 1 + 4 (t - 1), 8 h, 8 w] (reference: ContextParallelDecoder3D)."""

    def __init__(self, config: VaeModelConfig, temporal_compress_times: int = 4):
        super().__init__()
        cfg = config
        n = len(cfg.ch_mult)
        temporal_level = int(np.log2(temporal_compress_times))
        z = cfg.z_channels
        self.spatial_factor = 2 ** (n - 1)  # pixel rows per latent row
        block_in = cfg.ch * cfg.ch_mult[-1]
        self.conv_in = CausalConv3d(z, block_in)
        self.mid = _Mid(block_in, z)
        levels = [None] * n
        for i_level in reversed(range(n)):
            block_out = cfg.ch * cfg.ch_mult[i_level]
            blocks = [ResnetBlock3D(block_in if b == 0 else block_out, block_out, z)
                      for b in range(cfg.num_res_blocks + 1)]
            up = None if i_level == 0 else Upsample3D(block_out, block_out, i_level >= n - temporal_level)
            levels[i_level] = _Level(blocks, None if up is None else "upsample", up)
            block_in = block_out
        self.up = nn.ModuleList(levels)
        self.norm_out = SpatialNorm3D(block_in, z)
        self.conv_out = CausalConv3d(block_in, cfg.out_ch)

    def forward(self, z, cache: dict):
        zq = z
        h = self.conv_in(z, cache)
        h = self.mid.block_2(self.mid.block_1(h, cache, zq), cache, zq)
        for level in reversed(self.up):
            for block in level.block:
                h = block(h, cache, zq)
            if hasattr(level, "upsample"):
                h = level.upsample(h)
        return self.conv_out(Fn.silu(self.norm_out(h, zq, cache)), cache)
