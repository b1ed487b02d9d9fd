"""Training entry point (port of train.py).

Parses the same flags and TOML files as the JAX entry (``JobConfig``) and
follows its order: the logger (a text log and the stats history under
``<dump_folder>/logs``), CogVideoX on the device with random float32
weights from ``--job.seed`` (or those of ``--checkpoint.init_state_dir``, a
``save_pretrained`` directory: the curriculum's stage-to-stage handoff),
the grouped AdamW, the data, a resume, then ``--training.steps`` steps:
stratified sigma bounds, text dropout, the v-prediction loss, gradient
accumulation, global-norm clipping. Each step's random draws for the global
batch come from a generator seeded by (seed, step). It logs loss, grad
norm, data seconds, seconds per step and MFU (against the H100's dense bf16
peak).

Data: with ``--training.jsonl_paths`` (and ``--training.dataset_path``, the
root of relative paths) the precomputed-latent loader
(``data/dataset.py:DataModule``: posteriors sampled at load, a prefetch
thread, an exact-resume sampler, reads through the native reader where it
builds: the log says once whether it is in use), the text length from the
files; otherwise synthetic latents and text embeddings.

Checkpoints (``training/checkpoint.py:Checkpointer``) go to
``<dump_folder>/checkpoint/<step>/``: every ``--checkpoint.interval`` steps,
once before ``--checkpoint.timeout_minutes`` runs out, and at the end when
the interval does not divide the last step. ``--checkpoint.resume``
restores model, optimizer, data sampler and stats from
``--checkpoint.resume_step`` (-1: the latest) and carries on at the next
step, drawing what an uninterrupted run draws. ``--job.profile_dir``
writes a ``torch.profiler`` trace of steps 10-12.

The layers are unrolled and each runs under ``torch.utils.checkpoint`` with
the TOML's remat policy (``save_seq`` in the 3 s TOMLs: the TTT scans' and
attention's kernel outputs are kept, so the recompute is dense work only;
``none`` in the longer stages). On the card the TTT scans run K5 (training)
and K6 for ``ttt_linear``, K1 (training) and K2 for ``ttt_mlp``; attention
runs K3 (with the log-sum-exp) and K4; under the TOMLs'
``scan_layers = true`` the layer stack's 2-D weights are cast to bf16
through K7 once a layer forward, as the JAX package's scanned stack casts
them.

The device is CUDA. Without a GPU the entry raises, unless ``--job.platform cpu``
asks for the CPU explicitly.

Multi-GPU: under ``torchrun --nproc_per_node N`` each rank takes
``cuda:LOCAL_RANK`` and NCCL (gloo with ``--job.platform cpu``), and the
``[parallelism]`` sizes build the (replica, fsdp, tensor) mesh
(parallel/mesh.py): ``dp_replicate x dp_sharding x tp_sharding`` must be N,
with ``dp_sharding = -1`` inferred. Every rank builds the full float32
model from the seed (or loads it), then shards it: head tensor parallelism
over ``tensor`` (attention and TTT on H / tp local heads, every kernel on
its rank's heads), then FSDP2 per layer over (replica, fsdp), HSDP when
replica > 1 (parallel/sharding.py); between the head-local blocks the
stream is token-sharded over ``tensor`` (sequence parallelism, logged once
with the rows a rank holds), and the replicated parameters' partial
gradients are summed over ``tensor`` before the clip. Each data rank (rank // tp) loads its
contiguous shard of the global batch and takes its slice of the global
batch's sigma bounds (stratified over the data ranks) and draws; the loss
logged is the mean over the data ranks and MFU counts the world's FLOPs
against the world's peak. Only rank 0 writes logs and checkpoints. Without
torchrun the entry runs in one process, and the sizes must multiply to 1:
sizes that do not multiply to the world size raise ValueError, naming the
flags.

Usage (one H100, the 3 s stage cut to 4 layers; configs/train/ttt-linear/3s.toml
for the TTT-linear variant):
    python -m ttt_video_dit_torch.train --job.config_file configs/train/ttt-mlp/3s.toml \\
        --model.num_layers 4 --training.steps 3 --training.global_batch_size 1 \\
        --parallelism.dp_replicate 1 --parallelism.dp_sharding 1 \\
        [--training.dataset_path DATA --training.jsonl_paths DATA/meta.jsonl] \\
        [--checkpoint.interval 500] [--checkpoint.resume]
N cards (here 4: 2 data ranks x 2 tensor ranks):
    torchrun --standalone --nproc_per_node 4 -m ttt_video_dit_torch.train \\
        --job.config_file configs/train/ttt-mlp/3s.toml --training.global_batch_size 2 \\
        --parallelism.dp_replicate 1 --parallelism.dp_sharding -1 --parallelism.tp_sharding 2
"""

from __future__ import annotations

import contextlib
import math
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ttt_video_dit_torch.config.job_config import JobConfig
from ttt_video_dit_torch.config.model_config import ModelConfig
from ttt_video_dit_torch.parallel import mesh as pmesh
from ttt_video_dit_torch.parallel.mesh import say
from ttt_video_dit_torch.sample import resolve_device


def model_config(job_config: JobConfig) -> ModelConfig:
    """The model preset with the job's overrides (the port unrolls the
    layers whatever ``scan_layers`` says; it sets the K7 cast, see above)."""
    return ModelConfig.get_preset(job_config.model.size, job_config.model.video_length, job_config)


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


def build_data(job_config: JobConfig, cfg: ModelConfig, process_index: int = 0, process_count: int = 1):
    """(data module, text length or None when the files set it): the
    precomputed-latent loader with ``--training.jsonl_paths``, else synthetic
    data with :func:`synthetic_text_length`; either yields data rank
    ``process_index`` of ``process_count``'s shard of each global batch."""
    from ttt_video_dit_torch.data.dataset import DataModule, SyntheticDataModule

    tr = job_config.training
    shard = {"process_index": process_index, "process_count": process_count}
    if tr.jsonl_paths:
        return DataModule(tr.dataset_path, cfg.scale_factor, tr.jsonl_paths, seed=job_config.job.seed, **shard), None
    tl = synthetic_text_length(cfg)
    T, p = cfg.compressed_num_frames, cfg.patch_size
    data = SyntheticDataModule(vid_shape=(T, cfg.in_channels, cfg.latent_height * p, cfg.latent_width * p),
                               text_shape=(cfg.num_chunks, tl, cfg.text_dim), seed=job_config.job.seed, **shard)
    return data, tl


def main(job_config: JobConfig) -> dict:
    """Train to ``--training.steps``. Returns a summary: the device, the mesh
    sizes, the first step, per-step loss, grad norm, seconds, data seconds
    (the wait for the next batch) and MFU (on the card), the loader's seconds
    per batch and whether it read through the native reader (the real-data
    loader; None for synthetic data), each checkpoint's step, seconds and
    bytes, the restore's, peak memory, the data sampler's final state, and
    the trained model (its last step's gradients kept) and optimizer. Under
    torchrun every rank returns its own, and the process group is left at
    the end."""
    device = resolve_device(job_config.job.platform)
    par = job_config.parallelism
    distributed = pmesh.init_distributed(device)
    try:
        sizes = pmesh.mesh_shape(par.dp_replicate, par.dp_sharding, par.tp_sharding, pmesh.world_size())
        mesh = pmesh.build_mesh(*sizes, device_type=device.type) if distributed else None
        summary = _train(job_config, device, mesh, sizes)
    except BaseException:
        if distributed:  # no barrier: the other ranks may wait in a collective; torchrun stops them
            dist.destroy_process_group()
        raise
    if distributed:
        pmesh.end_distributed()
    return summary


def _train(job_config: JobConfig, device: torch.device, mesh, sizes) -> dict:
    from ttt_video_dit_torch.models.dit.schedule import StratifiedSigmaBuckets
    from ttt_video_dit_torch.parallel.sharding import parallelize
    from ttt_video_dit_torch.training.checkpoint import Checkpointer, dir_bytes
    from ttt_video_dit_torch.training.iterator import TrainingIterator
    from ttt_video_dit_torch.training.optimizer import build_optimizer_from_config
    from ttt_video_dit_torch.training.train_step import global_draws, rank_draws, step_generator, train_step
    from ttt_video_dit_torch.utils.logging import MultiLogger
    from ttt_video_dit_torch.utils.metrics import device_peak_flops, train_step_flops
    from ttt_video_dit_torch.utils.misc import (GarbageCollection, TimedContext, get_num_params, set_random_seed,
                                                 torch_profiler)

    job, tr, ck = job_config.job, job_config.training, job_config.checkpoint
    world, dp_rank, dp_size = math.prod(sizes), pmesh.data_rank(mesh), pmesh.data_size(mesh)
    logger = MultiLogger(os.path.join(job.dump_folder, "logs"), exp_name=job.exp_name,
                         enable_wandb=not job_config.wandb.disable, wandb_project=job_config.wandb.project,
                         wandb_entity=job_config.wandb.entity)
    cfg = model_config(job_config)
    adapter = cfg.adapter_method
    mesh_note = "" if mesh is None else (f" x {world} ranks, mesh replica x fsdp x tensor = "
                                         f"{' x '.join(map(str, sizes))} (FSDP2, heads over tensor)")
    say(f"device {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}){mesh_note}; "
        f"model d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, dtype {cfg.dtype}, "
        f"TTT mini-batch {cfg.mini_batch_size}, checkpoint group {cfg.scan_checkpoint_group_size}, "
        f"adapter {adapter}; layers unrolled, per-layer recompute, remat policy {cfg.remat_policy!r}"
        f"{', layer weights cast through K7' if cfg.scan_layers else ''}", flush=True)
    global_bs = tr.global_batch_size
    # The global batch's bounds, stratified over the data ranks; each rank feeds its slice.
    sigma_lo, sigma_hi = StratifiedSigmaBuckets.create(cfg.sigma_interval, dp_size).sample_bounds(global_bs, dp_size)
    data, tl = build_data(job_config, cfg, dp_rank, dp_size)
    local_bs = global_bs // dp_size
    rows = slice(dp_rank * local_bs, (dp_rank + 1) * local_bs)
    native_reader = getattr(data, "native_reader", None)
    if tl is None:
        from ttt_video_dit_torch.data import native

        reader = "native reader in use" if native_reader else f"native reader unavailable ({native.build_error()})"
        logger.write(f"data: {len(data.dataset)} samples from {tr.jsonl_paths}; {reader}")
    else:
        logger.write(f"synthetic data: text_length={tl}, "
                     f"seq={cfg.num_chunks * tl + cfg.compressed_num_frames * cfg.tokens_per_frame}")

    t0 = time.perf_counter()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    model = build_model(cfg, device, job.seed, None if ck.resume else ck.init_state_dir)
    if mesh is not None:  # every rank built the full model; each keeps its shards
        parallelize(model, mesh)
    optimizer = build_optimizer_from_config(model, job_config, adapter)
    num_params = get_num_params(model)
    setup_seconds = time.perf_counter() - t0
    say(f"model set-up {setup_seconds:.1f} s, {num_params / 1e6:.1f} M parameters "
        f"({sum(p.numel() for _, p in optimizer.params) / 1e6:.1f} M trainable)", flush=True)

    checkpointer = Checkpointer(os.path.join(job.dump_folder, "checkpoint"))
    start_step, restored = 0, None
    if ck.resume:
        t = time.perf_counter()
        start_step, sampler_state, metadata = checkpointer.restore(ck.resume_step, model, optimizer)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        path = checkpointer.step_dir(start_step)
        restored = {"step": start_step, "seconds": time.perf_counter() - t, "bytes": dir_bytes(path)}
        data.sampler.load_state_dict(sampler_state)
        logger.wandb_run_id = metadata.get("wandb_id")
        logger.load_stats(path)
        logger.write(f"resumed from step {start_step} ({restored['bytes'] / 2**30:.2f} GiB in "
                     f"{restored['seconds']:.2f} s)")
    elif ck.init_state_dir:
        logger.write(f"loaded pretrained weights from {ck.init_state_dir}")
    logger.init_log(job_config, cfg, num_params, device)

    saved = []

    def on_checkpoint(step: int, timeout: bool) -> None:
        info = checkpointer.save(step, model, optimizer, data.sampler.state_dict(), {"wandb_id": logger.wandb_run_id},
                                 extra=logger.snapshot_stats)
        saved.append({"step": step, "timeout": timeout, **info})
        logger.write(f"checkpoint saved at step {step}{' (timeout-aware)' if timeout else ''}: "
                     f"{info['bytes'] / 2**30:.2f} GiB in {info['seconds']:.2f} s")

    train_iter = TrainingIterator(start_step, tr.steps, checkpoint_interval=ck.interval,
                                  timeout_minutes=ck.timeout_minutes, on_checkpoint=on_checkpoint)
    set_random_seed(job.seed)
    gc_handler = GarbageCollection(gc_freq=tr.gc_freq)
    profile = contextlib.ExitStack()
    batches = data.batches(global_bs)
    flops = None if tl is None else train_step_flops(cfg, global_bs, tl)
    losses, grad_norms, step_seconds, data_seconds, mfus = [], [], [], [], []
    try:
        for step in train_iter:
            gc_handler.run(step)
            if job.profile_dir and step == 10:
                profile.enter_context(torch_profiler(job.profile_dir))
            elif job.profile_dir and step == 13:
                profile.close()
                logger.write(f"profiler trace written to {job.profile_dir}")
            with TimedContext() as data_timer:
                host = next(batches)
                batch = {"vid": torch.from_numpy(host["vid"]).to(device),
                         "text": torch.from_numpy(host["text"]).to(device),
                         "sigma_lo": torch.from_numpy(sigma_lo[rows]).to(device),
                         "sigma_hi": torch.from_numpy(sigma_hi[rows]).to(device)}
            data_seconds.append(data_timer.duration)
            if flops is None:
                tl = host["text"].shape[2]
                flops = train_step_flops(cfg, global_bs, tl)
            if step == start_step + 1 and sizes[2] > 1:
                L = cfg.num_chunks * tl + cfg.compressed_num_frames * cfg.tokens_per_frame
                tp = model.tensor_parallel
                logger.write(f"sequence parallel: the stream token-sharded over tensor: {tp.rows(L)} of {L} tokens "
                             f"a rank{'' if L % tp.size == 0 else f' (the last rank {tp.rows(L) * tp.size - L} padded)'}")
            t = time.perf_counter()
            count = optimizer.count
            draws = global_draws(step_generator(job.seed, count, device), global_bs, batch["vid"].shape[1:],
                                 tr.text_dropout_prob, sigma_lo, sigma_hi, device)
            metrics = train_step(model, optimizer, batch, grad_accum_steps=tr.grad_accum_steps,
                                 text_dropout_prob=tr.text_dropout_prob,
                                 draws=rank_draws(draws, dp_rank, dp_size, tr.grad_accum_steps))
            del draws
            # The mean over the data ranks (a tensor group's ranks hold the same loss); host reads fence the step.
            loss, grad_norm = float(pmesh.world_mean(metrics["loss"])), float(metrics["grad_norm"])
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            step_seconds.append(time.perf_counter() - t)
            losses.append(loss)
            grad_norms.append(grad_norm)
            mfu = flops / (step_seconds[-1] * world * device_peak_flops()) if device.type == "cuda" else None
            mfus.append(mfu)
            lrs = optimizer.learning_rates(count)
            logger.log_stats(step, {"train/loss": loss, "gradient_norm": grad_norm, "dataloader_time": data_seconds[-1],
                                    "step_time_ema_s": train_iter.ema_step_seconds or 0.0, "mfu": mfu,
                                    **{f"learning_rate/{k}": v for k, v in lrs.items()}})
            say(f"step {step}/{tr.steps} loss {loss:.4f} grad_norm {grad_norm:.4f} s/it {step_seconds[-1]:.3f} "
                f"data {data_seconds[-1]:.3f} s mfu {'n/a (cpu)' if mfu is None else f'{mfu * 100:.2f}%'} "
                f"lr {lrs['other_wd']:.3g}/{lrs['ttt_wd']:.3g}", flush=True)
    finally:
        profile.close()
        batches.close()
        gc_handler.close()
    checkpointer.wait()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None
    if not all(np.isfinite(losses)) or not all(np.isfinite(grad_norms)):
        raise FloatingPointError(f"non-finite loss or grad norm: losses {losses}, grad norms {grad_norms}")
    logger.alert("Training complete", f"{job.exp_name} finished {tr.steps} steps")
    logger.write("training complete")
    logger.close()
    return {"device": str(device), "mesh": sizes, "setup_seconds": setup_seconds, "start_step": start_step, "losses": losses,
            "grad_norms": grad_norms, "step_seconds": step_seconds, "data_seconds": data_seconds,
            "load_seconds": list(getattr(data, "load_seconds", [])), "native_reader": native_reader,
            "checkpoints": saved, "restore": restored,
            "mfu": mfus, "peak_memory_bytes": peak, "step_flops": flops, "num_params": num_params, "text_length": tl,
            "sampler_state": data.sampler.state_dict(), "model_config": cfg, "model": model, "optimizer": optimizer}


def parse_args(argv=None) -> JobConfig:
    config = JobConfig()
    config.parse_args(argv)
    return config


if __name__ == "__main__":
    main(parse_args())
