"""Diffusion noise schedule, v-prediction scalings, the stratified training
sigma buckets and the timestep embedding (port of
ttt_video_dit_tpu/models/dit/schedule.py).

Tables are computed host-side in float64 numpy (matching the reference's
torch numerics) and returned as float32 numpy arrays.
"""

from __future__ import annotations

import functools
import math
from dataclasses import dataclass

import numpy as np
import torch


def make_beta_schedule(n_timestep: int, linear_start: float = 1e-4, linear_end: float = 2e-2) -> np.ndarray:
    """Linear-in-sqrt beta schedule (float64)."""
    return np.linspace(linear_start**0.5, linear_end**0.5, n_timestep, dtype=np.float64) ** 2


def generate_roughly_equally_spaced_steps(num_substeps: int, max_step: int) -> np.ndarray:
    return np.linspace(max_step - 1, 0, num_substeps, endpoint=False).astype(int)[::-1]


class ZeroSNRDDPMDiscretization:
    """DDPM alphas-cumprod discretization rescaled for zero terminal SNR.
    ``__call__`` returns sqrt(alpha_cumprod) values ("sigmas" in the
    reference's naming) as float32 numpy arrays."""

    def __init__(self, linear_start: float = 0.00085, linear_end: float = 0.0120, num_timesteps: int = 1000,
                 shift_scale: float = 1.0):
        self.num_timesteps = num_timesteps
        betas = make_beta_schedule(num_timesteps, linear_start, linear_end)
        alphas_cumprod = np.cumprod(1.0 - betas, axis=0)
        self.alphas_cumprod = alphas_cumprod / (shift_scale + (1 - shift_scale) * alphas_cumprod)

    def get_sigmas(self, n: int):
        """(sqrt(alpha_cumprod) for ``n`` steps, high noise first; their timesteps)."""
        if n < self.num_timesteps:
            timesteps = generate_roughly_equally_spaced_steps(n, self.num_timesteps)
            alphas_cumprod = self.alphas_cumprod[timesteps]
        elif n == self.num_timesteps:
            timesteps = np.arange(self.num_timesteps)
            alphas_cumprod = self.alphas_cumprod
        else:
            raise ValueError(f"n={n} > num_timesteps={self.num_timesteps}")

        a_sqrt = np.sqrt(alphas_cumprod.astype(np.float32))
        a0, aT = a_sqrt[0].copy(), a_sqrt[-1].copy()
        # Zero-terminal-SNR rescale: sqrt(alpha_cumprod)[T] -> 0, [0] fixed.
        a_sqrt = (a_sqrt - aT) * (a0 / (a0 - aT))
        return a_sqrt[::-1].copy(), timesteps

    def __call__(self, n: int, flip: bool = False, return_idx: bool = False):
        sigmas, idx = self.get_sigmas(n)
        if flip:
            sigmas = sigmas[::-1].copy()
        return (sigmas, idx) if return_idx else sigmas


def video_scaling(alpha_cumprod_sqrt, idx):
    """CogVideoX v-prediction coefficients: (c_skip, c_out, c_in, c_noise)."""
    c_skip = alpha_cumprod_sqrt
    c_out = -torch.sqrt(1.0 - alpha_cumprod_sqrt**2)
    c_in = torch.ones_like(alpha_cumprod_sqrt)
    return c_skip, c_out, c_in, idx


@functools.lru_cache(maxsize=4)
def training_sigma_table(sigma_interval: int = 1000) -> np.ndarray:
    """sqrt(alpha_cumprod) indexed by training sigma index (0 nearly clean,
    ``sigma_interval - 1`` pure noise). Read-only: shared by every caller."""
    table = ZeroSNRDDPMDiscretization()(sigma_interval, flip=True)
    table.setflags(write=False)
    return table


@dataclass(frozen=True)
class StratifiedSigmaBuckets:
    """Rank-stratified uniform sigma-index bucketing: each effective rank gets
    a contiguous slice of [0, sigma_interval), so a global batch covers the
    noise levels uniformly; precomputed per sample."""

    sigma_interval: int
    group_num: int
    group_width: int

    @classmethod
    def create(cls, sigma_interval: int, effective_world_size: int) -> "StratifiedSigmaBuckets":
        i = 1
        while True:
            if effective_world_size % i != 0 or sigma_interval % (effective_world_size // i) != 0:
                i += 1
            else:
                group_num = effective_world_size // i
                break
        return cls(sigma_interval, group_num, effective_world_size // group_num)

    def sample_bounds(self, global_batch_size: int, effective_world_size: int):
        """Per-sample (start, end) index bounds, shape [B] each (int32 numpy)."""
        per_rank = max(global_batch_size // effective_world_size, 1)
        interval = self.sigma_interval // self.group_num
        ranks = np.arange(global_batch_size) // per_rank
        group_index = (ranks % effective_world_size) // self.group_width
        start = (group_index * interval).astype(np.int32)
        return start, (start + interval).astype(np.int32)


def timestep_embedding(timesteps, dim: int, max_period: int = 10000, dtype=torch.float32):
    """Sinusoidal timestep embedding, cos-then-sin order."""
    half = dim // 2
    freqs = torch.exp(-math.log(max_period) * torch.arange(half, dtype=torch.float32, device=timesteps.device) / half)
    args = timesteps.float()[:, None] * freqs[None]
    embedding = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        embedding = torch.cat([embedding, torch.zeros_like(embedding[:, :1])], dim=-1)
    return embedding.to(dtype)
