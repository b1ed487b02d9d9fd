"""Sampling entry point: storyboard JSON -> video latents (port of sample.py,
smoke mode).

Parses the same flags and TOML files as the JAX entry (``JobConfig(eval_mode=True)``),
runs the DPM++(2M) sampler with dynamic CFG through ``CogVideoX.denoise`` and
the DiT, and saves each video's latents as ``<output_dir>/video_0_<i>_latents.npy``.
Smoke mode only: random text embeddings stand in for T5, the DiT weights are
random (from a seed), and there is no VAE decode. Loading T5, VAE or DiT
weights is not ported yet and is refused.

The device is CUDA. Without a GPU the entry raises, unless ``--job.platform cpu``
asks for the CPU explicitly.

Usage (configs/eval/ttt-linear/3s.toml for the TTT-linear variant):
    python -m ttt_video_dit_torch.sample --job.config_file configs/eval/ttt-mlp/3s.toml \\
        --eval.input_file inputs/example.json --eval.num_denoising_steps 3 --guider.num_steps 3
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from ttt_video_dit_torch.config.job_config import JobConfig
from ttt_video_dit_torch.config.model_config import ModelConfig


def resolve_device(platform: str | None) -> torch.device:
    """``--job.platform``: unset/"cuda"/"gpu" -> the current CUDA device (raises
    without one); "cpu" -> the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "", "cuda", "gpu"):
        raise ValueError(f"unsupported --job.platform {platform!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass --job.platform cpu to sample on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def model_config(job_config: JobConfig) -> ModelConfig:
    """The model preset of ``--model.size``/``--model.video_length`` with the job's overrides."""
    return ModelConfig.get_preset(job_config.model.size, job_config.model.video_length, job_config)


def build_model(config: ModelConfig, device: torch.device, seed: int = 0):
    """CogVideoX with random weights from ``seed``, matmul weights cast once
    to the compute dtype."""
    from ttt_video_dit_torch.models.dit.diffusion import CogVideoX
    from ttt_video_dit_torch.models.dit.dit import cast_matmul_weights_, compute_dtype, init_params_

    with torch.device(device):
        model = CogVideoX(config)
    init_params_(model, torch.Generator(device).manual_seed(seed))
    cast_matmul_weights_(model, compute_dtype(config))
    return model.eval()


def main(job_config: JobConfig) -> dict:
    """Sample every storyboard of ``--eval.input_file``. Returns a summary:
    the device, per-eval seconds, and the saved latent paths."""
    from ttt_video_dit_torch.models.dit import sampler as S

    eval_cfg = job_config.eval
    for flag, value in (("--eval.t5_model_dir", eval_cfg.t5_model_dir),
                        ("--eval.vae_checkpoint_path", eval_cfg.vae_checkpoint_path),
                        ("--checkpoint.init_state_dir", job_config.checkpoint.init_state_dir)):
        if value:
            raise NotImplementedError(f"{flag} is not ported yet: the PyTorch entry samples in smoke mode only")
    if not eval_cfg.input_file:
        raise ValueError("--eval.input_file (storyboard json/jsonl) required")

    device = resolve_device(job_config.job.platform)
    cfg = model_config(job_config)
    print(f"device {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}); "
          f"model d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, "
          f"dtype {cfg.dtype}, TTT mini-batch {cfg.mini_batch_size}", flush=True)
    print("WARNING: no T5 encoder, random text embeddings; random DiT weights; no VAE (smoke mode)", flush=True)

    t0 = time.perf_counter()
    model = build_model(cfg, device)
    setup_seconds = time.perf_counter() - t0
    print(f"model set-up {setup_seconds:.1f} s", flush=True)

    storyboards = S.load_storyboards(eval_cfg.input_file)
    T = eval_cfg.sampling_num_frames
    shape = (1, T, eval_cfg.latent_channels, eval_cfg.image_height // 8, eval_cfg.image_width // 8)
    sampler = S.DPMPP2MSampler(
        num_steps=eval_cfg.num_denoising_steps,
        guider=S.DynamicCFG(job_config.guider.scale, job_config.guider.exp, job_config.guider.num_steps),
        shift_scale=job_config.discretization.shift_scale,
        num_idx=job_config.denoiser.num_idx,
    )
    os.makedirs(eval_cfg.output_dir, exist_ok=True)

    eval_seconds, paths = [], []
    for vi, (texts, _neg_texts) in enumerate(storyboards):
        rng_np = np.random.default_rng(vi)
        pos = rng_np.standard_normal((1, len(texts), eval_cfg.txt_maxlen, cfg.text_dim)).astype(np.float32)
        pos = torch.from_numpy(pos).to(device)
        denoise = S.make_cfg_denoise_fn(model, pos, torch.zeros_like(pos), sigma_interval=job_config.denoiser.num_idx,
                                        quantize_c_noise=job_config.denoiser.quantize_c_noise)

        def timed_denoise(x, a_sqrt, timestep):
            t = time.perf_counter()
            out = denoise(x, a_sqrt, timestep)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            eval_seconds.append(time.perf_counter() - t)
            print(f"[{vi}] denoise eval {len(eval_seconds)}: {eval_seconds[-1]:.3f} s", flush=True)
            return out

        print(f"[{vi}] sampling {T} latent frames, {eval_cfg.num_denoising_steps} steps...", flush=True)
        generator = torch.Generator(device).manual_seed(job_config.job.seed + vi)
        with torch.inference_mode():
            latents = sampler(timed_denoise, shape, generator=generator, device=device)
        latents = latents[0].cpu().numpy() / cfg.scale_factor  # [T, C, H, W]
        path = os.path.join(eval_cfg.output_dir, f"video_0_{vi}_latents.npy")
        np.save(path, latents)
        paths.append(path)
        print(f"[{vi}] saved latents to {path} (no VAE)", flush=True)
    return {"device": str(device), "setup_seconds": setup_seconds, "eval_seconds": eval_seconds,
            "latents": paths, "model_config": cfg}


def parse_args(argv=None) -> JobConfig:
    config = JobConfig(eval_mode=True)
    config.parse_args(argv)
    return config


if __name__ == "__main__":
    main(parse_args())
