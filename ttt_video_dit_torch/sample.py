"""Sampling entry point: storyboard JSON -> video frames (port of sample.py).

Parses the same flags and TOML files as the JAX entry (``JobConfig(eval_mode=True)``)
and runs its stages, one after the other, each freeing its model before the
next one loads (so the peak is the largest stage's, not their sum):

1. T5-encode every storyboard's positive and negative prompts
   (``--eval.t5_model_dir``; ``models/t5.py``, in ``--eval.dtype``);
2. load the DiT (``--checkpoint.init_state_dir``: a ``save_pretrained``
   directory, e.g. from ``models/dit/from_hf.py``), cast its matmul weights
   once, and run the DPM++(2M) sampler with dynamic CFG through
   ``CogVideoX.denoise``; each video's latents are saved as
   ``<output_dir>/video_0_<i>_latents.npy``;
3. VAE-decode the latents (``--eval.vae_checkpoint_path``; the reference's
   torch checkpoint, ``models/vae``), clip to [-1, 1], map to uint8 and write
   ``video_0_<i>.mp4`` where ``imageio`` can, else ``video_0_<i>.npz``.

Without a flag, its stage runs in smoke mode with the JAX entry's warning:
random text embeddings for T5, random DiT weights from a seed, no decode.

The device is CUDA. Without a GPU the entry raises, unless ``--job.platform cpu``
asks for the CPU explicitly.

Multi-GPU (the counterpart of the JAX entry's ``build_eval_mesh``): under
``torchrun --nproc_per_node N`` each rank takes ``cuda:LOCAL_RANK`` and
NCCL (gloo with ``--job.platform cpu``). When the world holds the TOML's
``dp_replicate x dp_sharding x tp_sharding`` ranks (``dp_sharding = -1``
counts as 1), the mesh is (replica, N / (replica x tensor), tensor): the
DiT's heads are split over ``tensor`` (attention and TTT on H / tp heads,
every kernel on its rank's heads; no FSDP, the weights are cast once), and
the storyboards are dealt over the data ranks as
``storyboards[data_rank::data_ranks]``. Each rank T5-encodes its own; the
ranks of each tensor group decode the VAE together, split over H
(``VideoAutoencoder(group=...)``, ``parallel/spatial.py``), and the first of
them writes ``video_<data_rank>_<i>`` (latents, frames). With fewer ranks than the TOML asks for,
the JAX entry's warning is printed and every rank samples unsharded. Only
rank 0 prints.

Usage (configs/eval/ttt-linear/3s.toml for the TTT-linear variant):
    python -m ttt_video_dit_torch.sample --job.config_file configs/eval/ttt-mlp/3s.toml \\
        --eval.input_file inputs/example.json --eval.t5_model_dir T5_DIR \\
        --checkpoint.init_state_dir DIT_DIR --eval.vae_checkpoint_path VAE.pt
Two cards, the 63 s TOML's tp_sharding = 2:
    torchrun --standalone --nproc_per_node 2 -m ttt_video_dit_torch.sample \\
        --job.config_file configs/eval/ttt-mlp/63s.toml --eval.input_file STORYBOARD_21.json ...
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch
import torch.distributed as dist

from ttt_video_dit_torch.config.job_config import JobConfig
from ttt_video_dit_torch.config.model_config import ModelConfig
from ttt_video_dit_torch.parallel import mesh as pmesh
from ttt_video_dit_torch.parallel.mesh import say


def resolve_device(platform: str | None, flag: str = "--job.platform") -> torch.device:
    """``--job.platform`` (or the tool's ``flag``): unset/"cuda"/"gpu" -> the
    CUDA device (raises without one): under torchrun ``cuda:LOCAL_RANK``,
    else the current one; "cpu" -> the CPU."""
    if platform == "cpu":
        return torch.device("cpu")
    if platform not in (None, "", "cuda", "gpu"):
        raise ValueError(f"unsupported {flag} {platform!r} (cuda or cpu)")
    if not torch.cuda.is_available():
        raise RuntimeError(f"no CUDA device available; pass {flag} cpu to run on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", torch.cuda.current_device())))


def model_config(job_config: JobConfig) -> ModelConfig:
    """The model preset of ``--model.size``/``--model.video_length`` with the job's overrides."""
    return ModelConfig.get_preset(job_config.model.size, job_config.model.video_length, job_config)


def warn_parallelism(job_config: JobConfig) -> bool:
    """When ``[parallelism]`` asks for more ranks than the world holds (the
    30 s and 63 s eval TOMLs set tp_sharding = 2), print the JAX entry's
    warning with the device count (the world's ranks under torchrun, else
    the cards visible); the entry then samples unsharded. Returns whether it
    warned."""
    par = job_config.parallelism
    want = max(par.dp_replicate, 1) * max(par.dp_sharding, 1) * max(par.tp_sharding, 1)
    if pmesh.world_size() >= want:
        return False
    visible = pmesh.world_size() if dist.is_initialized() else torch.cuda.device_count()
    say(f"WARNING: [parallelism] asks for replicate={par.dp_replicate} fsdp={par.dp_sharding} "
        f"tp={par.tp_sharding} but only {visible} device(s) visible; sampling unsharded", flush=True)
    return True


def sampling_mesh_shape(job_config: JobConfig) -> tuple[int, int, int]:
    """(replica, fsdp, tensor) over the world: the TOML's replica and tensor
    sizes with the other ranks as data ranks when the world holds what the
    TOML asks for, else (after :func:`warn_parallelism`) every rank a data
    rank of its own."""
    par = job_config.parallelism
    if warn_parallelism(job_config):
        return 1, pmesh.world_size(), 1
    return pmesh.mesh_shape(max(par.dp_replicate, 1), -1, max(par.tp_sharding, 1), pmesh.world_size())


def build_model(config: ModelConfig, device: torch.device, seed: int = 0, init_state_dir: str | None = None):
    """CogVideoX with the weights of ``init_state_dir`` (a ``save_pretrained``
    directory), else random weights from ``seed``; the float32 masters are
    loaded first, then the matmul weights are cast once to the compute dtype."""
    from ttt_video_dit_torch.models.dit.diffusion import CogVideoX
    from ttt_video_dit_torch.models.dit.dit import cast_matmul_weights_, compute_dtype, init_params_
    from ttt_video_dit_torch.training.checkpoint import load_pretrained

    if init_state_dir:
        with torch.device("meta"):  # every parameter is loaded
            model = CogVideoX(config)
        load_pretrained(init_state_dir, model.to_empty(device=device))
    else:
        with torch.device(device):
            model = CogVideoX(config)
        init_params_(model, torch.Generator(device).manual_seed(seed))
    cast_matmul_weights_(model, compute_dtype(config))
    return model.eval()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _end_stage(device: torch.device, peaks: dict, stage: str) -> None:
    """Free the cached blocks of the stage just run, record its peak allocation
    on the card, and restart the peak count for the next stage."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
        peaks[stage] = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)


def save_video(frames: np.ndarray, path: str, fps: int = 16) -> str:
    """Write [T, H, W, 3] uint8 frames to ``path`` (.mp4) through ``imageio``,
    or to the same name with .npz (key ``frames``) where ``imageio`` or its
    ffmpeg backend is missing. Returns the path written."""
    try:
        import imageio.v2 as imageio

        writer = imageio.get_writer(path, fps=fps, codec="libx264")
    except (ImportError, ValueError, RuntimeError, OSError):
        path = os.path.splitext(path)[0] + ".npz"
        np.savez_compressed(path, frames=frames)
        return path
    with writer:
        for frame in frames:
            writer.append_data(frame)
    return path


def frames_to_uint8(frames: torch.Tensor) -> np.ndarray:
    """Float frames -> uint8: clip to [-1, 1], then (x + 1) * 127.5 truncated, as the JAX entry maps them.
    Raises on NaN or inf, which the clip and the cast would turn into arbitrary bytes."""
    if not torch.isfinite(frames).all():
        raise ValueError(f"decoded frames {list(frames.shape)} hold NaN or inf")
    return ((frames.clamp(-1, 1) + 1) * 127.5).to(torch.uint8).cpu().numpy()


def encode_prompts(job_config: JobConfig, storyboards, device: torch.device, text_dim: int, peaks: dict):
    """[(pos, neg)] text embeddings [1, scenes, txt_maxlen, text_dim] per
    storyboard, and the seconds T5 took (None in smoke mode)."""
    eval_cfg = job_config.eval
    if not eval_cfg.t5_model_dir:
        say("WARNING: no --eval.t5_model_dir; using random text embeddings (smoke mode)", flush=True)
        out = []
        for vi, (texts, _neg_texts) in enumerate(storyboards):
            pos = np.random.default_rng(vi).standard_normal((1, len(texts), eval_cfg.txt_maxlen, text_dim))
            pos = torch.from_numpy(pos.astype(np.float32)).to(device)
            out.append((pos, torch.zeros_like(pos)))
        return out, None
    from ttt_video_dit_torch.models.t5 import load_text_encoder

    t0 = time.perf_counter()
    encoder = load_text_encoder(eval_cfg.t5_model_dir, dtype=eval_cfg.dtype, device=device)
    out = [(encoder.encode(texts, eval_cfg.txt_maxlen)[None], encoder.encode(neg_texts, eval_cfg.txt_maxlen)[None])
           for texts, neg_texts in storyboards]
    _sync(device)
    seconds = time.perf_counter() - t0
    del encoder
    _end_stage(device, peaks, "t5")
    say(f"T5 ({eval_cfg.dtype}) encoded {len(storyboards)} storyboards in {seconds:.1f} s, load included", flush=True)
    return out, seconds


def main(job_config: JobConfig) -> dict:
    """Sample every storyboard of ``--eval.input_file`` (under torchrun, this
    data rank's). Returns a summary: the device, the mesh sizes, T5 seconds,
    DiT set-up seconds, per-eval seconds, per-video VAE seconds, the paths of
    the saved latents and frames (this rank's writes), and on the card the
    peak allocation of each stage ("t5", "dit", "vae"; the entry resets the
    peak count at each stage's start). Under torchrun the process group is
    left at the end."""
    eval_cfg = job_config.eval
    if not eval_cfg.input_file:
        raise ValueError("--eval.input_file (storyboard json/jsonl) required")
    device = resolve_device(job_config.job.platform)
    distributed = pmesh.init_distributed(device)
    try:
        summary = _sample(job_config, device, distributed)
    except BaseException:
        if distributed:  # no barrier: the other ranks may wait in a collective; torchrun stops them
            dist.destroy_process_group()
        raise
    if distributed:
        pmesh.end_distributed()
    return summary


def _sample(job_config: JobConfig, device: torch.device, distributed: bool) -> dict:
    from ttt_video_dit_torch.models.dit import sampler as S
    from ttt_video_dit_torch.models.dit.dit import sequence_metadata
    from ttt_video_dit_torch.parallel.sharding import apply_tensor_parallel

    eval_cfg = job_config.eval
    init_state_dir = job_config.checkpoint.init_state_dir
    cfg = model_config(job_config)
    storyboards = S.load_storyboards(eval_cfg.input_file)
    T = eval_cfg.sampling_num_frames
    meta = sequence_metadata(cfg, T, eval_cfg.image_height // 8, eval_cfg.image_width // 8, len(storyboards[0][0]),
                             eval_cfg.txt_maxlen)
    seq_len = meta.seq_text_length + meta.num_video_tokens
    window = meta.text_length + (cfg.prefix_temporal_length + cfg.attn_length) * meta.tokens_per_frame
    say(f"device {device} ({torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'}); "
        f"model d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, "
        f"dtype {cfg.dtype}, TTT mini-batch {cfg.mini_batch_size}; sequence {seq_len} tokens "
        f"({meta.num_chunks} scenes x {meta.text_length} text + {T} frames x {meta.tokens_per_frame}), "
        f"{meta.num_chunks} attention windows of {window} tokens", flush=True)
    sizes = sampling_mesh_shape(job_config)
    mesh = pmesh.build_mesh(*sizes, device_type=device.type) if distributed else None
    dp_rank, dp_size = pmesh.data_rank(mesh), pmesh.data_size(mesh)
    writer = pmesh.tensor_rank(mesh) == 0  # the first rank of each tensor group writes
    storyboards = storyboards[dp_rank::dp_size]
    if mesh is not None:
        say(f"{pmesh.world_size()} ranks, mesh replica x fsdp x tensor = {' x '.join(map(str, sizes))}: "
            f"heads over tensor, storyboards dealt over {dp_size} data ranks", flush=True)
    peaks = {}
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    texts, t5_seconds = encode_prompts(job_config, storyboards, device, cfg.text_dim, peaks)

    t0 = time.perf_counter()
    if not init_state_dir:
        say("WARNING: no --checkpoint.init_state_dir; sampling from random weights (smoke mode)", flush=True)
    model = build_model(cfg, device, init_state_dir=init_state_dir)
    if mesh is not None:  # every rank built the full model; each keeps its heads
        apply_tensor_parallel(model, mesh)
    setup_seconds = time.perf_counter() - t0
    say(f"model set-up {setup_seconds:.1f} s" + (f" (weights from {init_state_dir})" if init_state_dir else ""),
        flush=True)

    shape = (1, T, eval_cfg.latent_channels, eval_cfg.image_height // 8, eval_cfg.image_width // 8)
    sampler = S.DPMPP2MSampler(
        num_steps=eval_cfg.num_denoising_steps,
        guider=S.DynamicCFG(job_config.guider.scale, job_config.guider.exp, job_config.guider.num_steps),
        shift_scale=job_config.discretization.shift_scale,
        num_idx=job_config.denoiser.num_idx,
    )
    os.makedirs(eval_cfg.output_dir, exist_ok=True)

    eval_seconds, latents_paths, videos = [], [], []
    for vi, (pos, neg) in enumerate(texts):
        denoise = S.make_cfg_denoise_fn(model, pos, neg, sigma_interval=job_config.denoiser.num_idx,
                                        quantize_c_noise=job_config.denoiser.quantize_c_noise)

        def timed_denoise(x, a_sqrt, timestep):
            t = time.perf_counter()
            out = denoise(x, a_sqrt, timestep)
            _sync(device)
            eval_seconds.append(time.perf_counter() - t)
            say(f"[{vi}] denoise eval {len(eval_seconds)}: {eval_seconds[-1]:.3f} s", flush=True)
            return out

        say(f"[{vi}] sampling {T} latent frames, {eval_cfg.num_denoising_steps} steps...", flush=True)
        generator = torch.Generator(device).manual_seed(job_config.job.seed + vi)
        with torch.inference_mode():
            latents = sampler(timed_denoise, shape, generator=generator, device=device)
        videos.append(latents[0].cpu().numpy() / cfg.scale_factor)  # [T, C, H, W]
        if not writer:
            continue
        path = os.path.join(eval_cfg.output_dir, f"video_{dp_rank}_{vi}_latents.npy")
        np.save(path, videos[-1])
        latents_paths.append(path)
        say(f"[{vi}] saved latents to {path}", flush=True)
    del model, texts
    _end_stage(device, peaks, "dit")

    vae_seconds, frame_paths = [], []
    if not eval_cfg.vae_checkpoint_path:
        say("no --eval.vae_checkpoint_path: latents only (no VAE decode)", flush=True)
    else:
        from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder

        group = None if mesh is None else mesh.get_group(pmesh.TENSOR)
        vae = VideoAutoencoder.load_decoder(eval_cfg.vae_checkpoint_path, scale_factor=eval_cfg.vae_scale_factor,
                                            device=device, group=group)
        split = "" if vae.shard is None else f", split over {vae.shard.size} tensor ranks"
        for vi, latents in enumerate(videos):
            t = time.perf_counter()
            frames = frames_to_uint8(vae.decode(torch.from_numpy(latents)))  # [T*4-3, H*8, W*8, 3]
            vae_seconds.append(time.perf_counter() - t)
            if not writer:
                continue
            frame_paths.append(save_video(frames, os.path.join(eval_cfg.output_dir, f"video_{dp_rank}_{vi}.mp4"),
                                          fps=eval_cfg.sampling_fps))
            say(f"[{vi}] VAE decode {vae_seconds[-1]:.2f} s{split}; wrote {frame_paths[-1]} {list(frames.shape)}",
                flush=True)
        del vae
        _end_stage(device, peaks, "vae")
    return {"device": str(device), "mesh": sizes, "t5_seconds": t5_seconds, "setup_seconds": setup_seconds,
            "eval_seconds": eval_seconds, "vae_seconds": vae_seconds, "latents": latents_paths,
            "frames": frame_paths, "peak_memory_bytes": peaks, "model_config": cfg, "seq_len": seq_len,
            "windows": meta.num_chunks}


def parse_args(argv=None) -> JobConfig:
    config = JobConfig(eval_mode=True)
    config.parse_args(argv)
    return config


if __name__ == "__main__":
    main(parse_args())
