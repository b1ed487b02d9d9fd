"""One full training step of a tiny model over an n-rank mesh (port of
``__graft_entry__.dryrun_multichip`` at the repo root).

The mesh is the JAX dry run's factorisation (``_dryrun_body``): tensor 2
when n is even, replica 2 when it divides what is left, fsdp the rest. It runs
n NCCL ranks on n cards through the kernels (the tiny model widened to the
kernels' head dim 64 and training mini-batch 64, in bf16), and raises
RuntimeError when fewer cards are visible; asked with ``cpu=True``, it runs
n gloo ranks on the CPU through the plain versions (where the JAX package
re-runs itself on n virtual CPU devices). Either way it launches
``torchrun --standalone --nproc_per_node n -m ttt_video_dit_torch.dryrun n
[--cpu]``, and each rank runs
:func:`_dryrun_body`: the model from a seed, the tensor plan and FSDP2, the
grouped AdamW and one step of the global batch, unrolled and again with the
layer weights cast through K7 (``scan_layers``), each printing its loss.

Usage:
    python -c "from ttt_video_dit_torch.dryrun import dryrun_multichip; dryrun_multichip(4)"  # 4 cards
    python -c "from ttt_video_dit_torch.dryrun import dryrun_multichip; dryrun_multichip(4, cpu=True)"
"""

from __future__ import annotations

import dataclasses
import math
import os
import subprocess
import sys

import numpy as np
import torch

from ttt_video_dit_torch.config.model_config import ModelConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def factorisation(n: int) -> tuple[int, int, int]:
    """(replica, fsdp, tensor) for n ranks, as the JAX dry run picks them."""
    tp = 2 if n % 2 == 0 else 1
    rep = 2 if n % (tp * 2) == 0 and n // tp >= 2 else 1
    return rep, n // (tp * rep), tp


def tiny_config(kernels: bool) -> ModelConfig:
    """``__graft_entry__._flagship_config(tiny=True)``: d128, 8 heads, 2
    layers, 37 frames (3 scenes), CS 8, K 4, float32, plain versions; with
    ``kernels``, 8 heads of 64 (d512), CS 64, bf16, the kernels."""
    cfg = ModelConfig(model_dim=128, num_heads=8, num_layers=2, ssm_layer="ttt_mlp", mini_batch_size=8,
                      latent_height=4, latent_width=4, compressed_num_frames=37, text_dim=64, time_embed_dim=64,
                      scan_checkpoint_group_size=4, use_kernel=False, dtype="float32")
    if kernels:
        cfg = dataclasses.replace(cfg, model_dim=512, mini_batch_size=64, use_kernel=True, dtype="bfloat16")
    return cfg


def _dryrun_body(n: int, cpu: bool) -> None:
    from ttt_video_dit_torch.models.dit.diffusion import CogVideoX
    from ttt_video_dit_torch.models.dit.dit import init_params_
    from ttt_video_dit_torch.models.dit.schedule import StratifiedSigmaBuckets
    from ttt_video_dit_torch.parallel import mesh as pmesh
    from ttt_video_dit_torch.parallel.sharding import parallelize
    from ttt_video_dit_torch.sample import resolve_device
    from ttt_video_dit_torch.training.optimizer import build_optimizer
    from ttt_video_dit_torch.training.train_step import global_draws, rank_draws, step_generator, train_step

    device = resolve_device("cpu" if cpu else None)
    if not pmesh.init_distributed(device):
        raise RuntimeError("_dryrun_body runs under torchrun (dryrun_multichip launches it)")
    try:
        sizes = factorisation(n)
        mesh = pmesh.build_mesh(*sizes, device_type=device.type)
        dp_rank, dp_size = pmesh.data_rank(mesh), pmesh.data_size(mesh)
        cfg = tiny_config(kernels=not cpu)
        B, scenes, TL = max(2, dp_size), 3, 16
        rng = np.random.default_rng(0)
        vid = torch.from_numpy(rng.standard_normal((B, cfg.compressed_num_frames, cfg.in_channels, 8, 8))
                               .astype(np.float32))
        text = torch.from_numpy(rng.standard_normal((B, scenes, TL, cfg.text_dim)).astype(np.float32))
        lo, hi = StratifiedSigmaBuckets.create(cfg.sigma_interval, dp_size).sample_bounds(B, dp_size)
        rows = slice(dp_rank * B // dp_size, (dp_rank + 1) * B // dp_size)
        batch = {"vid": vid[rows].to(device), "text": text[rows].to(device),
                 "sigma_lo": torch.from_numpy(lo[rows]).to(device), "sigma_hi": torch.from_numpy(hi[rows]).to(device)}
        for tag, config in (("unrolled", cfg), ("scan_layers", dataclasses.replace(cfg, scan_layers=True))):
            with torch.device(device):
                model = CogVideoX(config)
            init_params_(model, torch.Generator(device).manual_seed(0))
            parallelize(model.train(), mesh)
            optimizer = build_optimizer(model, lr=1e-4, lr_ssm=1e-4, lr_end=0.0, warmup_steps=10, total_steps=100)
            draws = global_draws(step_generator(7, 0, device), B, vid.shape[1:], 0.1, lo, hi, device)
            metrics = train_step(model, optimizer, batch, text_dropout_prob=0.1,
                                 draws=rank_draws(draws, dp_rank, dp_size, 1))
            loss = float(pmesh.world_mean(metrics["loss"]))
            if not math.isfinite(loss):
                raise FloatingPointError(f"non-finite loss {loss} ({tag})")
            pmesh.say(f"dryrun_multichip(n={n}, {tag}): mesh replica x fsdp x tensor = "
                      f"{' x '.join(map(str, sizes))} on {device.type} ({'kernels' if cfg.use_kernel else 'plain'}), "
                      f"loss={loss:.4f} OK", flush=True)
    except BaseException:
        torch.distributed.destroy_process_group()
        raise
    pmesh.end_distributed()


def dryrun_multichip(n_devices: int, cpu: bool = False) -> str:
    """Run :func:`_dryrun_body` on ``n_devices`` ranks: NCCL on as many
    cards, or with ``cpu`` gloo on the CPU. Returns rank 0's output (also
    printed); raises RuntimeError, before launching anything, when ``cpu``
    is false and fewer cards are visible, and if a rank fails."""
    if not cpu:
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < n_devices:
            raise RuntimeError(f"dryrun_multichip({n_devices}) needs {n_devices} cards and sees {cards}; "
                               f"pass cpu=True to run {n_devices} gloo ranks on the CPU")
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
    if cpu:
        env["OMP_NUM_THREADS"] = "1"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(n_devices), "-m",
           "ttt_video_dit_torch.dryrun", str(n_devices)] + (["--cpu"] if cpu else [])
    proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True)
    print(proc.stdout, end="", flush=True)
    if proc.returncode:
        raise RuntimeError(f"dryrun_multichip({n_devices}) exited {proc.returncode}:\n{proc.stderr[-4000:]}")
    return proc.stdout


if __name__ == "__main__":
    _dryrun_body(int(sys.argv[1]), cpu="--cpu" in sys.argv[2:])
