"""Example batches for a model configuration (port of the batch helpers of
ttt_video_dit_tpu/training/setup.py; the mesh and sharding set-up there has
no counterpart on one card)."""

from __future__ import annotations

import numpy as np
import torch

from ttt_video_dit_torch.config.model_config import ModelConfig


def example_batch_shapes(cfg: ModelConfig, batch_size: int, text_length: int = 498):
    """Shapes of one training batch. Video latents are [B, T, C, h, w] with
    h, w the latent pixels (cfg.latent_height/width are the token grid)."""
    T = cfg.compressed_num_frames
    h = cfg.latent_height * cfg.patch_size
    w = cfg.latent_width * cfg.patch_size
    return dict(
        vid=(batch_size, T, cfg.in_channels, h, w),
        text=(batch_size, cfg.num_chunks, text_length, cfg.text_dim),
    )


def make_example_batch(cfg: ModelConfig, batch_size: int, text_length: int = 498, seed: int = 0,
                       device: torch.device | str = "cpu"):
    shapes = example_batch_shapes(cfg, batch_size, text_length)
    rng = np.random.default_rng(seed)
    as_t = lambda x: torch.from_numpy(x).to(device)
    return dict(
        vid=as_t(rng.standard_normal(shapes["vid"]).astype(np.float32)),
        text=as_t(rng.standard_normal(shapes["text"]).astype(np.float32)),
        sigma_lo=torch.zeros((batch_size,), dtype=torch.int32, device=device),
        sigma_hi=torch.full((batch_size,), cfg.sigma_interval, dtype=torch.int32, device=device),
    )
