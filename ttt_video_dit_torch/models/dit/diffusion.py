"""CogVideoX diffusion wrapper around the DiT (port of
ttt_video_dit_tpu/models/dit/diffusion.py): the weighted v-prediction
training loss (``forward``) and one denoiser evaluation for sampling
(``denoise``)."""

from __future__ import annotations

import torch
from torch import nn

from ttt_video_dit_torch.config.model_config import ModelConfig
from ttt_video_dit_torch.models.dit.dit import DiffusionTransformer, compute_dtype
from ttt_video_dit_torch.models.dit.schedule import training_sigma_table, video_scaling


class CogVideoX(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.dit = DiffusionTransformer(config)

    def forward(self, vid, text, sigma_bounds, generator: torch.Generator | None = None, idx=None, noise=None):
        """Per-sample training loss [B].

        vid [B, T, C, H, W] latents; text [B, scenes, S, text_dim];
        sigma_bounds ([B], [B]) int stratified index bounds. The sigma index is
        lo + u % max(hi - lo, 1) with u uniform in [0, 2^30) and the noise is
        standard normal, both drawn from ``generator``; ``idx`` [B] and
        ``noise`` (vid's shape) replace the draws (the tests feed the JAX
        package's)."""
        cfg = self.config
        B, dev = vid.shape[0], vid.device
        lo, hi = (torch.as_tensor(x, device=dev).long() for x in sigma_bounds)
        if idx is None:
            u = torch.randint(0, 1 << 30, (B,), generator=generator, device=dev)
            idx = lo + u % torch.clamp(hi - lo, min=1)
        idx = torch.as_tensor(idx, device=dev).long()
        if noise is None:
            noise = torch.randn(vid.shape, generator=generator, device=dev)
        table = torch.from_numpy(training_sigma_table(cfg.sigma_interval).copy()).to(dev)
        a = table[idx].reshape(B, *([1] * (vid.ndim - 1)))

        vid_f = vid.float()
        noised = vid_f * a + noise.float() * torch.sqrt(1.0 - a**2)
        c_skip, c_out, c_in, c_noise = video_scaling(a, idx)
        model_output = self.dit((noised * c_in).to(compute_dtype(cfg)), text, c_noise)
        denoised = model_output.float() * c_out + noised * c_skip
        w = 1.0 / (1.0 - a**2)
        return (w * (denoised - vid_f) ** 2).reshape(B, -1).mean(dim=1)

    def denoise(self, noised, alpha_cumprod_sqrt, text, timesteps):
        """One denoiser evaluation for sampling: v-prediction scalings around
        the DiT. noised [B,T,C,H,W]; alpha_cumprod_sqrt [B]; timesteps [B]
        (c_noise). Returns the denoised latents in float32."""
        a = alpha_cumprod_sqrt.float().reshape(-1, *([1] * (noised.ndim - 1)))
        c_skip, c_out, c_in, _ = video_scaling(a, timesteps)
        model_output = self.dit((noised * c_in).to(compute_dtype(self.config)), text, timesteps)
        return model_output.float() * c_out + noised.float() * c_skip
