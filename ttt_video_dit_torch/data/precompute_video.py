"""Offline VAE precompute: mp4 episodes -> latent posterior tensors (port of
data/precompute_video.py at the repo root).

Each episode is read (``fps * video-length + 1`` frames of 480 x 720, the
frame rate checked), scaled to [-1, 1] and encoded by the causal VAE
encoder in temporal windows of 48 + 1, then 48 frames, the conv cache
carried between them. Its unregularized posterior (mean and log variance,
[T/4 + 1, 32, 60, 90], float32) is saved as ``<save-dir>/<episode>.npy``.
Reruns skip outputs that exist and pass ``validate_existing``. Episodes are
dealt over processes as ``episodes[process_index::process_count]``
(``--process-index``/``--process-count``, by default ``TTT_PROC_ID`` and
``TTT_NUM_PROCS``).

``--spatial-shard`` under ``torchrun --nproc_per_node N`` splits each
window over H across the N ranks (``VideoAutoencoder(group=...)``,
``parallel/spatial.py``; NCCL on ``cuda:LOCAL_RANK``, gloo with ``--device
cpu``): every rank reads the episode, and rank 0 writes. Without torchrun
it runs on one device. The device is CUDA; without a GPU the tool raises
unless ``--device cpu`` asks for the CPU.

Reading mp4 needs ``imageio`` with its ffmpeg plugin, as in the JAX tool;
without it :func:`read_video_frames` raises an ImportError that names it.
:func:`encode_episode` and :func:`precompute_episode` take frames already in
memory.

Usage:
    python -m ttt_video_dit_torch.data.precompute_video --episode-dir /data/mp4s --save-dir /data/latents \\
        --vae-checkpoint /ckpts/vae.pt --video-length 12 --fps 16
    torchrun --standalone --nproc_per_node 8 -m ttt_video_dit_torch.data.precompute_video --spatial-shard ...
"""

from __future__ import annotations

import argparse
import os
import os.path as osp
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

GEOMETRY = (480, 720)  # pixel rows and columns of an episode


def validate_existing(path: str, latent_frames: int) -> bool:
    """Whether ``path`` holds a finished posterior: [latent_frames, 32, 60, 90],
    the means in (-10, 10) and the log variances in (-40, 10)."""
    try:
        arr = np.load(path)
    except (OSError, ValueError, EOFError):
        return False
    return (arr.shape == (latent_frames, 32, 60, 90) and -10 < arr[:, :16].min() and arr[:, :16].max() < 10
            and -40 < arr[:, 16:].min() and arr[:, 16:].max() < 10)


def read_video_frames(path: str, expected_fps: int, expected_frames: int) -> np.ndarray:
    """The episode's uint8 frames [T, H, W, 3]; raises ValueError unless it
    has ``expected_frames`` frames at ``expected_fps`` (within 0.5)."""
    try:
        import imageio.v2 as imageio
    except ImportError as e:
        raise ImportError(f"reading {path} needs the imageio package (with imageio-ffmpeg), which is not "
                          "installed; precompute_episode takes frames already in memory") from e

    reader = imageio.get_reader(path, "ffmpeg")
    try:
        fps = reader.get_meta_data()["fps"]
        if abs(fps - expected_fps) >= 0.5:
            raise ValueError(f"Video FPS ({fps}) != expected ({expected_fps}): {path}")
        frames = np.stack([np.asarray(f) for f in reader])  # [T, H, W, 3] uint8
    finally:
        reader.close()
    if frames.shape[0] != expected_frames:
        raise ValueError(f"Wrong number of frames: {frames.shape[0]} != {expected_frames}: {path}")
    return frames


def encode_episode(vae, frames: np.ndarray) -> np.ndarray:
    """uint8 frames [T, H, W, 3] -> the posterior [T/4 + 1, 2 z, H/8, W/8],
    float32 on the host (scaled to [-1, 1] on the VAE's device)."""
    x = torch.from_numpy(np.ascontiguousarray(frames)).to(vae.device)
    x = (x.float() / 255.0 * 2.0 - 1.0).permute(3, 0, 1, 2)[None]  # [1, 3, T, H, W]
    posterior = vae.encode_first_stage(x, unregularized=True)  # [1, 2 z, T/4 + 1, h, w]
    return posterior[0].transpose(0, 1).cpu().numpy()


def precompute_episode(vae, save_path: str, latent_frames: int, read_frames: Callable[[], np.ndarray],
                       write: bool = True) -> np.ndarray | None:
    """One episode: None when ``save_path`` holds a valid posterior already
    (``read_frames`` is not called); else the posterior of ``read_frames()``,
    checked to be [latent_frames, encoder channels out, H / f, W / f] (f the
    encoder's spatial factor; [T/4 + 1, 32, 60, 90] for VAE 1.0 at 480 x 720)
    and saved to ``save_path`` when ``write`` (rank 0 under ``--spatial-shard``)."""
    if osp.exists(save_path) and validate_existing(save_path, latent_frames):
        return None
    frames = read_frames()
    f = vae.encoder.spatial_factor
    want = (latent_frames, vae.encoder.conv_out.conv.out_channels, frames.shape[1] // f, frames.shape[2] // f)
    out = encode_episode(vae, frames)
    assert out.shape == want, f"posterior {out.shape}, expected {want}"
    if write:
        np.save(save_path, out)
    return out


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--episode-dir", required=True)
    parser.add_argument("--save-dir", required=True)
    parser.add_argument("--vae-checkpoint", required=True)
    parser.add_argument("--video-length", type=int, default=12,
                        help="episode length in seconds; episodes must have fps*length+1 frames "
                        "(reference: data/precomp_video.py:210)")
    parser.add_argument("--num-frames", type=int, default=None,
                        help="explicit pixel frame count; must be a multiple of 48 plus 1 (overrides --video-length)")
    parser.add_argument("--fps", type=int, default=16)
    parser.add_argument("--process-index", type=int, default=int(os.environ.get("TTT_PROC_ID", "0")))
    parser.add_argument("--process-count", type=int, default=int(os.environ.get("TTT_NUM_PROCS", "1")))
    parser.add_argument("--spatial-shard", action="store_true",
                        help="under torchrun, split each encode window over H across the ranks (the 49 x 480 x 720 "
                        "window's ~8.7 GB level-0 feature maps divided by the rank count); rank 0 writes")
    parser.add_argument("--device", default="cuda", help="cuda (the default; raises without a GPU) or cpu")
    args = parser.parse_args(argv)
    if args.num_frames is None:
        args.num_frames = args.fps * args.video_length + 1
    # The tiled causal encoder consumes windows of (48+1, 48, 48, ...) frames;
    # only T = 48n + 1 tiles exactly (VAE temporal stride 4 -> T/4+1 latents).
    if args.num_frames % 48 != 1:
        parser.error(f"--num-frames {args.num_frames} is not 48n+1; episodes must have "
                     f"fps*seconds+1 frames (e.g. 193 for 12 s at 16 fps)")
    return args


def main(argv=None) -> list[str]:
    """Encode this process's episodes. Returns the paths written (on rank 0 under ``--spatial-shard``)."""
    from ttt_video_dit_torch.parallel import mesh as pmesh
    from ttt_video_dit_torch.sample import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device, "--device")
    distributed = args.spatial_shard and pmesh.init_distributed(device)
    try:
        written = _precompute(args, device, dist.group.WORLD if distributed else None)
    except BaseException:
        if distributed:  # no barrier: the other ranks may wait in a collective; torchrun stops them
            dist.destroy_process_group()
        raise
    if distributed:
        pmesh.end_distributed()
    return written


def _precompute(args, device, group) -> list[str]:
    from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder

    vae = VideoAutoencoder.from_torch_checkpoint(args.vae_checkpoint, device=device, halves=("encoder",),
                                                 group=group)
    writer = group is None or dist.get_rank() == 0
    if group is not None and writer:
        print(f"VAE encoder split over H across {dist.get_world_size(group)} ranks", flush=True)
    os.makedirs(args.save_dir, exist_ok=True)
    episodes = sorted(v for v in os.listdir(args.episode_dir) if v.endswith(".mp4"))
    episodes = episodes[args.process_index :: args.process_count]
    latent_frames = (args.num_frames - 1) // 4 + 1
    written = []
    for i, episode in enumerate(episodes):
        save_path = osp.join(args.save_dir, episode.replace(".mp4", ".npy"))

        def read():
            frames = read_video_frames(osp.join(args.episode_dir, episode), args.fps, args.num_frames)
            if frames.shape != (args.num_frames, *GEOMETRY, 3):
                raise ValueError(f"unexpected geometry {frames.shape} of {episode}: [T, 480, 720, 3] expected")
            return frames

        if precompute_episode(vae, save_path, latent_frames, read, writer) is not None and writer:
            written.append(save_path)
            print(f"[{args.process_index}] {i + 1}/{len(episodes)} {episode} -> {save_path}", flush=True)
    return written


if __name__ == "__main__":
    main()
