"""Training entry point (port of train.py, synthetic data on one card).

Parses the same flags and TOML files as the JAX entry (``JobConfig``),
builds CogVideoX on the device with random float32 weights from
``--job.seed``, and takes ``--training.steps`` steps on synthetic latents and
text embeddings (as the JAX entry does without ``--training.jsonl_paths``):
stratified sigma bounds, text dropout, the v-prediction loss, gradient
accumulation, global-norm clipping and the grouped AdamW. It logs loss, grad
norm, seconds per step and MFU (against the H100's dense bf16 peak).

The layers are unrolled and each runs under ``torch.utils.checkpoint``
(remat policy "none": the backward re-runs the layer's forward and
kernels). On the card the TTT scans run K5 (training) and K6 for
``ttt_linear``, K1 (training) and K2 for ``ttt_mlp``; attention runs K3
(with the log-sum-exp) and K4; under the TOMLs' ``scan_layers = true`` the
layer stack's 2-D weights are cast to bf16 through K7 at each forward, as
the JAX package's scanned stack casts them.

``--checkpoint.init_state_dir`` starts from the weights of a
``save_pretrained`` directory (the stage-to-stage handoff of the curriculum,
or converted pretrained weights) in place of the random ones.

The device is CUDA. Without a GPU the entry raises, unless ``--job.platform cpu``
asks for the CPU explicitly. Not ported yet, and refused with
NotImplementedError: real data (``--training.jsonl_paths``), checkpoint
resume (``--checkpoint.resume``), and more than one device
(``--parallelism.*`` sizes other than 1).

Usage (one H100, the 3 s stage cut to 4 layers; configs/train/ttt-linear/3s.toml
for the TTT-linear variant):
    python -m ttt_video_dit_torch.train --job.config_file configs/train/ttt-mlp/3s.toml \\
        --model.num_layers 4 --training.steps 3 --training.global_batch_size 1 \\
        --parallelism.dp_replicate 1 --parallelism.dp_sharding 1
"""

from __future__ import annotations

import time

import numpy as np
import torch

from ttt_video_dit_torch.config.job_config import JobConfig
from ttt_video_dit_torch.config.model_config import ModelConfig
from ttt_video_dit_torch.sample import resolve_device


def model_config(job_config: JobConfig) -> ModelConfig:
    """The model preset with the job's overrides (the port unrolls the
    layers whatever ``scan_layers`` says; it sets the K7 cast, see above)."""
    return ModelConfig.get_preset(job_config.model.size, job_config.model.video_length, job_config)


def refuse_unported(job_config: JobConfig) -> None:
    """Raise NotImplementedError, naming the flag, for what is not ported yet."""
    refused = [
        ("--training.jsonl_paths", job_config.training.jsonl_paths, "the real-data loader"),
        ("--checkpoint.resume", job_config.checkpoint.resume, "checkpoint resume"),
    ]
    for flag, value, what in refused:
        if value:
            raise NotImplementedError(f"{flag}: {what} is not ported yet (the PyTorch trainer runs on synthetic data)")
    par = job_config.parallelism
    for flag, size in (("--parallelism.dp_replicate", par.dp_replicate), ("--parallelism.dp_sharding", par.dp_sharding),
                       ("--parallelism.tp_sharding", par.tp_sharding)):
        if size != 1:
            raise NotImplementedError(f"{flag} {size}: multi-GPU training is not ported yet; set it to 1")


def synthetic_text_length(cfg: ModelConfig) -> int:
    """A text length near the reference default (498) that keeps the sequence
    divisible by the TTT mini-batch."""
    vid_tokens = cfg.compressed_num_frames * cfg.tokens_per_frame
    tl = 498
    while (cfg.num_chunks * tl + vid_tokens) % cfg.mini_batch_size != 0:
        tl += 1
    return tl


def build_model(cfg: ModelConfig, device: torch.device, seed: int, init_state_dir: str | None = None):
    """CogVideoX with the float32 weights of ``init_state_dir`` (a
    ``save_pretrained`` directory), else random ones from ``seed`` (the
    masters; the matmuls cast them to the compute dtype at each call), in
    training mode."""
    from ttt_video_dit_torch.models.dit.diffusion import CogVideoX
    from ttt_video_dit_torch.models.dit.dit import init_params_
    from ttt_video_dit_torch.training.checkpoint import load_pretrained

    with torch.device(device):
        model = CogVideoX(cfg)
    if init_state_dir:
        load_pretrained(init_state_dir, model)
    else:
        init_params_(model, torch.Generator(device).manual_seed(seed))
    return model.train()


def main(job_config: JobConfig) -> dict:
    """Train for ``--training.steps`` steps. Returns a summary: the device,
    per-step loss, grad norm and seconds, MFU (on the card), peak memory, and
    the trained model (its last step's gradients kept) and optimizer."""
    from ttt_video_dit_torch.data.dataset import SyntheticDataModule
    from ttt_video_dit_torch.models.dit.schedule import StratifiedSigmaBuckets
    from ttt_video_dit_torch.training.optimizer import build_optimizer_from_config
    from ttt_video_dit_torch.training.train_step import train_step
    from ttt_video_dit_torch.utils.metrics import device_peak_flops, train_step_flops

    refuse_unported(job_config)
    device = resolve_device(job_config.job.platform)
    cfg = model_config(job_config)
    tr = job_config.training
    adapter = cfg.adapter_method
    print(f"device {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}); "
          f"model d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, dtype {cfg.dtype}, "
          f"TTT mini-batch {cfg.mini_batch_size}, checkpoint group {cfg.scan_checkpoint_group_size}, "
          f"adapter {adapter}; layers unrolled, per-layer recompute"
          f"{', layer weights cast through K7' if cfg.scan_layers else ''}", flush=True)
    if job_config.checkpoint.interval:
        print(f"WARNING: --checkpoint.interval {job_config.checkpoint.interval}: checkpoint saving is not ported; "
              "no checkpoint is written", flush=True)

    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device, job_config.job.seed, job_config.checkpoint.init_state_dir)
    optimizer = build_optimizer_from_config(model, job_config, adapter)
    num_params = sum(p.numel() for p in model.parameters())
    setup_seconds = time.perf_counter() - t0
    print(f"model set-up {setup_seconds:.1f} s, {num_params / 1e6:.1f} M parameters "
          f"({sum(p.numel() for _, p in optimizer.params) / 1e6:.1f} M trainable)", flush=True)

    tl = synthetic_text_length(cfg)
    T, p = cfg.compressed_num_frames, cfg.patch_size
    data = SyntheticDataModule(vid_shape=(T, cfg.in_channels, cfg.latent_height * p, cfg.latent_width * p),
                               text_shape=(cfg.num_chunks, tl, cfg.text_dim), seed=job_config.job.seed)
    print(f"synthetic data: text_length={tl}, seq={cfg.num_chunks * tl + T * cfg.tokens_per_frame}", flush=True)
    global_bs = tr.global_batch_size
    sigma_lo, sigma_hi = StratifiedSigmaBuckets.create(cfg.sigma_interval, 1).sample_bounds(global_bs, 1)
    generator = torch.Generator(device).manual_seed(job_config.job.seed + 1)
    flops = train_step_flops(cfg, global_bs, tl)

    losses, grad_norms, step_seconds, mfus = [], [], [], []
    batches = data.batches(global_bs)
    for step in range(1, tr.steps + 1):
        host = next(batches)
        batch = {"vid": torch.from_numpy(host["vid"]).to(device), "text": torch.from_numpy(host["text"]).to(device),
                 "sigma_lo": torch.from_numpy(sigma_lo).to(device), "sigma_hi": torch.from_numpy(sigma_hi).to(device)}
        t = time.perf_counter()
        metrics = train_step(model, optimizer, batch, grad_accum_steps=tr.grad_accum_steps,
                             text_dropout_prob=tr.text_dropout_prob, generator=generator)
        loss, grad_norm = float(metrics["loss"]), float(metrics["grad_norm"])  # host reads fence the step
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        step_seconds.append(time.perf_counter() - t)
        losses.append(loss)
        grad_norms.append(grad_norm)
        mfu = flops / (step_seconds[-1] * device_peak_flops()) if device.type == "cuda" else None
        mfus.append(mfu)
        lrs = optimizer.learning_rates(optimizer.count - 1)
        print(f"step {step}/{tr.steps} loss {loss:.4f} grad_norm {grad_norm:.4f} s/it {step_seconds[-1]:.3f} "
              f"mfu {'n/a (cpu)' if mfu is None else f'{mfu * 100:.2f}%'} lr {lrs['other_wd']:.3g}/{lrs['ttt_wd']:.3g}",
              flush=True)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if not all(np.isfinite(losses)) or not all(np.isfinite(grad_norms)):
        raise FloatingPointError(f"non-finite loss or grad norm: losses {losses}, grad norms {grad_norms}")
    print("training complete", flush=True)
    return {"device": str(device), "setup_seconds": setup_seconds, "losses": losses, "grad_norms": grad_norms,
            "step_seconds": step_seconds, "mfu": mfus, "peak_memory_bytes": peak, "step_flops": flops,
            "num_params": num_params, "text_length": tl, "model_config": cfg, "model": model, "optimizer": optimizer}


def parse_args(argv=None) -> JobConfig:
    config = JobConfig()
    config.parse_args(argv)
    return config


if __name__ == "__main__":
    main(parse_args())
