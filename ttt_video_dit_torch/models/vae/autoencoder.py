"""VAE inference wrapper: temporal-tiled encode and decode with the conv
cache carried between windows, the diagonal-Gaussian sample, and loading the
reference's torch checkpoint (port of
ttt_video_dit_tpu/models/vae/autoencoder.py).

Encode runs windows of ``window`` + 1 frames then ``window`` frames (48 by
default), decode windows of 2 latent frames, the first with the extra causal
frame; each window threads the caches of the previous one (see
``enc_dec.py``), and every call starts a video with an empty cache.

Split over H across ranks (the JAX wrapper's ``mesh=``): given a process
``group`` of two or more ranks, every rank passes the whole input, encodes
or decodes its rows (latent rows split as evenly as can be, the first
``h mod N`` ranks one more; ``parallel/spatial.py`` exchanges the halo rows
and the GroupNorm moments), and all-gathers the output rows, so each rank
returns the whole output. A group of one, or none, runs the one-device code.
The ranks must pass inputs of one shape (a ValueError names the shapes).

Numerics: float32. On a CUDA device the convolutions run with cuDNN's TF32
off (the JAX VAE computes in float32), so the card differs from the CPU only
by summation order.
"""

from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist
from torch import nn

from ttt_video_dit_torch.config.model_config import VaeModelConfig
from ttt_video_dit_torch.models.vae.enc_dec import Decoder3D, Encoder3D
from ttt_video_dit_torch.parallel import spatial


@contextlib.contextmanager
def _no_tf32():
    """cuDNN's float32 convolutions without TF32 inside, the caller's setting restored after."""
    before = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = before


def _windows(T: int, window: int):
    """(start, stop) of each temporal window: [0, window + 1), then ``window`` frames each."""
    return [(0, window + 1) if i == 0 else (window * i + 1, window * (i + 1) + 1) for i in range(max(T // window, 1))]


class VideoAutoencoder(nn.Module):
    """The encoder and/or decoder of the CogVideoX VAE (a half given no
    config is absent), split over H across ``group`` when it holds two or
    more ranks."""

    def __init__(self, encoder_config: VaeModelConfig | None = None, decoder_config: VaeModelConfig | None = None,
                 scale_factor: float = 1.0, temporal_compress_times: int = 4,
                 group: dist.ProcessGroup | None = None):
        super().__init__()
        self.encoder = None if encoder_config is None else Encoder3D(encoder_config, temporal_compress_times)
        self.decoder = None if decoder_config is None else Decoder3D(decoder_config, temporal_compress_times)
        self.scale_factor = scale_factor
        self.shard = None if group is None or dist.get_world_size(group) == 1 else spatial.SpatialShard(group)

    def _split(self, run, x, factor_in: int, factor_out: int) -> torch.Tensor:
        """``run(x)``; split over H, ``run`` of this rank's rows of x (``factor_in``
        rows a latent row) with every rank's output rows (``factor_out`` a
        latent row) gathered."""
        shard = self.shard
        if shard is None:
            return run(x)
        shard.check_same_shape(x)
        if x.shape[-2] % factor_in:
            raise ValueError(f"{x.shape[-2]} rows are not a multiple of the VAE's spatial factor {factor_in}")
        spans = spatial.split_rows(x.shape[-2] // factor_in, shard.size)
        start, stop = spans[shard.rank]
        with spatial.sharded(shard):
            y = run(x[..., start * factor_in : stop * factor_in, :])
        return shard.gather_rows(y, [(e - s) * factor_out for s, e in spans])

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    # ------------------------------------------------------- tiled encode
    @torch.inference_mode()
    def encode_first_stage(self, x, unregularized: bool = True, window: int = 48,
                           generator: torch.Generator | None = None, noise=None,
                           multiply_by_scale_factor: bool = False) -> torch.Tensor:
        """x: [B, C, T, H, W] pixels in [-1, 1] with T = n * window + 1 (or 1).

        Returns the posterior parameters [B, 2 z, T_lat, h, w] when
        ``unregularized``, else a diagonal-Gaussian sample [B, z, T_lat, h, w]:
        mean + exp(logvar / 2) * noise with logvar clipped to [-30, 20];
        ``noise`` (the mean's shape) replaces the draw from ``generator``.
        ``multiply_by_scale_factor`` scales the result."""
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        T = x.shape[2]
        if not (T == 1 or T % window == 1):
            raise AssertionError(f"encode expects T = n*{window} + 1 frames (got {T}); "
                                 "precompute targets FPS*seconds+1 frames per episode")
        cache: dict = {}

        def run(x):
            return torch.cat([self.encoder(x[:, :, s:e], cache) for s, e in _windows(T, window)], dim=2)

        with _no_tf32():
            out = self._split(run, x, self.encoder.spatial_factor, 1)
        if not unregularized:
            mean, logvar = out.chunk(2, dim=1)
            std = torch.exp(0.5 * logvar.clamp(-30.0, 20.0))
            if noise is None:
                if generator is None:
                    raise ValueError("a regularized encode samples: pass generator= or noise=")
                noise = torch.randn(mean.shape, generator=generator, device=mean.device)
            out = mean + std * torch.as_tensor(noise, dtype=mean.dtype, device=mean.device)
        return out * self.scale_factor if multiply_by_scale_factor else out

    # ------------------------------------------------------- tiled decode
    @torch.inference_mode()
    def decode_first_stage(self, z, window: int = 2) -> torch.Tensor:
        """z: [B, C, T_lat, h, w] scaled latents -> pixels [B, 3, T, H, W]."""
        z = torch.as_tensor(z, dtype=torch.float32, device=self.device) / self.scale_factor
        cache: dict = {}

        def run(z):
            return torch.cat([self.decoder(z[:, :, s:e], cache) for s, e in _windows(z.shape[2], window)], dim=2)

        with _no_tf32():
            return self._split(run, z, 1, self.decoder.spatial_factor)

    def decode(self, latents) -> torch.Tensor:
        """Sampling's decode: [T, C, h, w] latents -> [T_out, H, W, 3] float
        frames (nominally in [-1, 1]) on the VAE's device."""
        z = torch.as_tensor(latents, device=self.device)[None].transpose(1, 2)
        return self.decode_first_stage(z)[0].permute(1, 2, 3, 0)

    # ------------------------------------------------------------ loading
    @classmethod
    def from_torch_checkpoint(cls, path: str, scale_factor: float = 1.0, device: torch.device | str = "cpu",
                              halves=("encoder", "decoder"), group: dist.ProcessGroup | None = None):
        """The reference's checkpoint (a state dict, or a dict holding one
        under ``state_dict``, with ``encoder.*`` / ``decoder.*`` keys): each
        half of ``halves`` is built at the widths its tensors have (the
        CogVideoX VAE 1.0 config for the published checkpoint) and loaded
        strictly, in float32 on ``device``; ``group`` splits it over H."""
        sd = torch.load(path, map_location="cpu", weights_only=True)
        if "state_dict" in sd:
            sd = sd["state_dict"]
        parts = {h: {k[len(h) + 1:]: v for k, v in sd.items() if k.startswith(h + ".")} for h in halves}
        configs = [_config_of(h, parts[h]) if h in parts else None for h in ("encoder", "decoder")]
        with torch.device("meta"):  # every parameter is loaded
            vae = cls(*configs, scale_factor=scale_factor, group=group)
        vae.to_empty(device=device)
        for half, part in parts.items():
            getattr(vae, half).load_state_dict({k: v.float() for k, v in part.items()}, strict=True)
        return vae.eval()

    @classmethod
    def load_decoder(cls, path: str, scale_factor: float = 1.0, device: torch.device | str = "cpu",
                     group: dist.ProcessGroup | None = None):
        """The decoder half only (sampling needs no encoder)."""
        return cls.from_torch_checkpoint(path, scale_factor, device, halves=("decoder",), group=group)


def _config_of(half: str, sd: dict) -> VaeModelConfig:
    """The ``VaeModelConfig`` whose encoder or decoder has the tensors of ``sd``
    (the reference's torch names, without the half's prefix)."""
    if not sd:
        raise KeyError(f"the checkpoint has no {half}.* tensors")
    levels = "up" if half == "decoder" else "down"
    n = 1 + max(int(k.split(".")[1]) for k in sd if k.startswith(levels + "."))
    blocks = 1 + max(int(k.split(".")[3]) for k in sd if k.startswith(f"{levels}.0.block."))
    conv_in, conv_out = sd["conv_in.conv.weight"].shape, sd["conv_out.conv.weight"].shape
    ch = conv_out[1] if half == "decoder" else conv_in[0]
    ch_mult = tuple(sd[f"{levels}.{i}.block.0.conv2.conv.weight"].shape[0] // ch for i in range(n))
    if half == "decoder":
        return VaeModelConfig(ch=ch, ch_mult=ch_mult, num_res_blocks=blocks - 1, z_channels=conv_in[1],
                              out_ch=conv_out[0], gather_norm=False, temporal_tiling_window=2)
    return VaeModelConfig(ch=ch, ch_mult=ch_mult, num_res_blocks=blocks, z_channels=conv_out[0] // 2,
                          in_channels=conv_in[1])
