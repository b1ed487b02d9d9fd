"""Sampling stack: storyboard prompts, dynamic CFG and the VP-SDE DPM++(2M)
sampler over the Zero-SNR discretization (port of
ttt_video_dit_tpu/models/dit/sampler.py, per-step loop path).

Randomness comes from an explicit ``torch.Generator``, or from an injected
noise source (a callable ``shape -> tensor``), which the sampler calls once
for the initial latent and then once per noised step, in step order.
"""

from __future__ import annotations

import json
import math
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ttt_video_dit_torch.models.dit.schedule import ZeroSNRDDPMDiscretization, training_sigma_table

SCENE_END_TOKEN = "<end_scene>"
SCENE_START_TOKEN = "<start_scene>"


@dataclass
class SceneDescription:
    """One scene of a multi-scene storyboard."""

    text: str
    requires_scene_transition: bool = False
    neg_text: Optional[str] = None


def load_storyboards(path: str) -> List[Tuple[List[str], List[Optional[str]]]]:
    """Parse a .json/.jsonl storyboard file into per-video (scene_texts,
    scene_neg_texts), inserting <start_scene>/<end_scene> transition tokens."""
    if path.endswith(".jsonl"):
        with open(path, "r", encoding="utf-8") as f:
            videos = [json.loads(line) for line in f if line.strip()]
    elif path.endswith(".json"):
        with open(path, "r", encoding="utf-8") as f:
            videos = json.load(f)
    else:
        raise ValueError("Invalid prompt file format. Expected .jsonl or .json")

    out = []
    for video in videos:
        scenes = [SceneDescription(**obj) for obj in video]
        if scenes:
            scenes[0].requires_scene_transition = False
        for i, scene in enumerate(scenes):
            if scene.requires_scene_transition:
                scenes[i - 1].text += SCENE_END_TOKEN
                scene.text = SCENE_START_TOKEN + scene.text
        out.append(([s.text for s in scenes], [s.neg_text for s in scenes]))
    return out


class DynamicCFG:
    """Cosine-ramped classifier-free guidance scale."""

    def __init__(self, scale: float, exp: float, num_steps: int):
        self.scale = scale
        self.exp = exp
        self.num_steps = num_steps

    def scale_at(self, step_index: int) -> float:
        return 1.0 + self.scale * (1.0 - math.cos(math.pi * (step_index / self.num_steps) ** self.exp)) / 2.0

    def combine(self, denoised_doubled, scale: float):
        """Split the CFG-doubled batch (unconditional first) and guide."""
        x_u, x_c = denoised_doubled.chunk(2, dim=0)
        return x_u + scale * (x_c - x_u)


NoiseSource = Callable[[Tuple[int, ...]], torch.Tensor]


class DPMPP2MSampler:
    """VP-SDE DPM++(2M) ancestral sampler over the Zero-SNR discretization.

    ``denoise_fn(x, a_sqrt, timestep) -> denoised`` evaluates the CFG-doubled
    denoiser (see :func:`make_cfg_denoise_fn`)."""

    def __init__(self, num_steps: int = 50, guider: Optional[DynamicCFG] = None, shift_scale: float = 1.0,
                 num_idx: int = 1000):
        self.num_steps = num_steps
        self.guider = guider or DynamicCFG(scale=6, exp=5, num_steps=num_steps)
        self.discretization = ZeroSNRDDPMDiscretization(shift_scale=shift_scale, num_timesteps=num_idx)

    @staticmethod
    def _lamb(a_sqrt):
        # Clip both Zero-SNR endpoints (a_sqrt == 1 divides by zero, 0 takes log(0)).
        a = np.clip(a_sqrt**2, 1e-24, 1.0 - 1e-12)
        return np.log(np.sqrt(a / (1.0 - a)))

    def _mults(self, a, a_next, a_prev):
        h = self._lamb(a_next) - self._lamb(a)
        mult1 = np.sqrt((1 - a_next**2) / (1 - a**2)) * np.exp(-h)
        mult2 = np.expm1(-2 * h) * a_next
        if a_prev is None:
            return h, (mult1, mult2)
        r = (self._lamb(a) - self._lamb(a_prev)) / h
        return h, (mult1, mult2, 1 + 1 / (2 * r), 1 / (2 * r))

    def step_tables(self):
        """Per-step constants of the whole trajectory as float32 columns
        (a, t, scale, last, first, m0, m1, m2, m3, mn), and the step count."""
        a_sqrt, timesteps = self.discretization(self.num_steps, return_idx=True)
        a_sqrt = np.concatenate([a_sqrt, np.ones((1,), a_sqrt.dtype)])
        timesteps = np.concatenate([[-1], np.asarray(timesteps)])
        n = len(a_sqrt) - 1

        rows = []
        for i in range(n):
            idx = self.num_steps - i
            timestep = float(timesteps[-(i + 1)])
            a, a_next = float(a_sqrt[i]), float(a_sqrt[i + 1])
            a_prev = None if i == 0 else float(a_sqrt[i - 1])
            scale = self.guider.scale_at(self.num_steps - int(timestep))
            if idx == 1:
                rows.append((a, timestep, scale, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0))
                continue
            h, mult = self._mults(a, a_next, a_prev)
            mult_noise = math.sqrt(1 - a_next**2) * math.sqrt(max(1 - math.exp(-2 * h), 0.0))
            first = 1.0 if (i == 0 or a_next < 1e-14) else 0.0
            m2, m3 = (0.0, 0.0) if i == 0 else (float(mult[2]), float(mult[3]))
            rows.append((a, timestep, scale, 0.0, first, float(mult[0]), float(mult[1]), m2, m3, mult_noise))

        cols = np.asarray(rows, np.float32).T
        names = ("a", "t", "scale", "last", "first", "m0", "m1", "m2", "m3", "mn")
        return {k: np.ascontiguousarray(v) for k, v in zip(names, cols)}, n

    def __call__(self, denoise_fn, shape, *, generator: Optional[torch.Generator] = None,
                 noise: Optional[NoiseSource] = None, device=None):
        """Run the sampling loop; returns float32 latents of ``shape`` (B, T, C, H, W).
        Exactly one of ``generator`` and ``noise`` is given."""
        if (generator is None) == (noise is None):
            raise ValueError("pass exactly one of generator= and noise=")
        if noise is None:
            noise = lambda shp: torch.randn(shp, generator=generator, device=generator.device, dtype=torch.float32)
        steps, n = self.step_tables()
        x = noise(tuple(shape)).to(device=device, dtype=torch.float32)
        old_denoised = torch.zeros_like(x)
        for i in range(n):
            denoised2 = denoise_fn(x, float(steps["a"][i]), float(steps["t"][i]))
            denoised = self.guider.combine(denoised2, float(steps["scale"][i])).float()
            if steps["last"][i]:
                x = denoised
            else:
                eps = noise(tuple(shape)).to(device=x.device, dtype=torch.float32)
                if steps["first"][i]:
                    d_eff = denoised
                else:
                    d_eff = float(steps["m2"][i]) * denoised - float(steps["m3"][i]) * old_denoised
                x = float(steps["m0"][i]) * x - float(steps["m1"][i]) * d_eff + float(steps["mn"][i]) * eps
            old_denoised = denoised
        return x


def make_cfg_denoise_fn(model, text_emb, neg_emb, sigma_interval: int = 1000, quantize_c_noise: bool = False):
    """The CFG-doubled denoiser evaluation. text_emb/neg_emb: [B, scenes, S, E]
    tensors on the model's device. sigma is quantized to the nearest table
    index; the conditioning timestep is that index when ``quantize_c_noise``,
    else the raw timestep."""
    device = text_emb.device
    table = torch.from_numpy(np.array(training_sigma_table(sigma_interval))).to(device)
    cond = torch.cat([neg_emb, text_emb], dim=0)

    def denoise_fn(x, a_sqrt: float, timestep: float):
        B = x.shape[0]
        x2 = torch.cat([x, x], dim=0)
        a = torch.full((2 * B,), a_sqrt, dtype=torch.float32, device=device)
        idx = torch.argmin(torch.abs(a[:, None] - table[None, :]), dim=1)
        a_q = table[idx]
        t = idx.float() if quantize_c_noise else torch.full((2 * B,), timestep, dtype=torch.float32, device=device)
        return model.denoise(x2, a_q, cond, t)

    return denoise_fn
