"""CogVideoX diffusion wrapper around the DiT (port of
ttt_video_dit_tpu/models/dit/diffusion.py, the sampling half: ``denoise``).
The training loss comes with the training port."""

from __future__ import annotations

from torch import nn

from ttt_video_dit_torch.models.dit.dit import DiffusionTransformer, compute_dtype
from ttt_video_dit_torch.models.dit.schedule import video_scaling
from ttt_video_dit_tpu.config.model_config import ModelConfig


class CogVideoX(nn.Module):
    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        self.dit = DiffusionTransformer(config)

    def denoise(self, noised, alpha_cumprod_sqrt, text, timesteps):
        """One denoiser evaluation for sampling: v-prediction scalings around
        the DiT. noised [B,T,C,H,W]; alpha_cumprod_sqrt [B]; timesteps [B]
        (c_noise). Returns the denoised latents in float32."""
        a = alpha_cumprod_sqrt.float().reshape(-1, *([1] * (noised.ndim - 1)))
        c_skip, c_out, c_in, _ = video_scaling(a, timesteps)
        model_output = self.dit((noised * c_in).to(compute_dtype(self.config)), text, timesteps)
        return model_output.float() * c_out + noised.float() * c_skip
