"""Where the VAE decode of one 3 s video spends its time on a CUDA card.

Builds the CogVideoX VAE 1.0 decoder (ch 128, ch_mult (1, 2, 2, 4), 3 res
blocks, z 16; PyTorch's default initialisation from a seed), decodes seeded
latents [13, 16, 60, 90] into [49, 480, 720, 3] frames once as a warm-up,
then once under torch.profiler, and prints the decode's wall time, the
summed device-kernel time (one stream), the idle share, the time per kernel
family and the top kernels, and the peak memory. Then it times the same
decode unprofiled, with ``torch.backends.cudnn.benchmark`` (cuDNN times its
algorithms per shape; still float32), and with cuDNN's TF32 allowed (the
port decodes with it off), and prints how far those frames lie from the
float32 ones.

    python scripts/profile_torch_vae.py [--frames N]

With ``--frames N`` (latent frames; 253 for a 63 s video, 4N - 3 frames out)
the decode of N frames is timed once by the host clock after a warm-up on 13
frames (the decoder's per-step shapes do not depend on N), with its peak
memory, and nothing else is run.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (
    ("conv (cuDNN)", ("conv", "cudnn", "xmma", "fprop", "implicit", "winograd", "fft", "gemm", "cutlass", "sm90_")),
    ("GroupNorm", ("group_norm", "groupnorm")),
    ("copy / cat / pad / resize", ("cat", "copy", "pad", "index", "upsample", "interp", "gather")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise / reduction"


def time_long_decode(vae, frames: int, device, card: str) -> None:
    """One decode of ``frames`` seeded latent frames, after a warm-up on 13: seconds and peak memory."""
    gen = torch.Generator(device).manual_seed(1)
    vae.decode(torch.randn(13, 16, 60, 90, generator=gen, device=device))
    latents = torch.randn(frames, 16, 60, 90, generator=gen, device=device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = vae.decode(latents)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"VAE 1.0 decode [{frames}, 16, 60, 90] -> {list(out.shape)}, float32, TF32 off: wall {wall:.4f} s, "
          f"{wall / out.shape[0] * 1e3:.2f} ms a frame, peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB, "
          f"finite {bool(torch.isfinite(out).all())} ({card})")


def main() -> None:
    frames = int(sys.argv[sys.argv.index("--frames") + 1]) if "--frames" in sys.argv else None
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from ttt_video_dit_torch.config.model_config import VaeModelConfig
    from ttt_video_dit_torch.models.vae import autoencoder
    from ttt_video_dit_torch.sample import frames_to_uint8

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    device = torch.device("cuda", 0)
    torch.manual_seed(0)
    with torch.device(device):
        vae = autoencoder.VideoAutoencoder(None, VaeModelConfig.get_decoder_config()).eval()
    if frames is not None:
        return time_long_decode(vae, frames, device, card)
    latents = torch.randn(13, 16, 60, 90, generator=torch.Generator(device).manual_seed(1), device=device)

    def decode():
        frames = vae.decode(latents)
        torch.cuda.synchronize()
        return frames

    want = decode()  # warm-up
    torch.cuda.reset_peak_memory_stats(device)
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        decode()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device)

    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0, 0.0])
            k[0] += 1
            k[1] += (evt.time_range.end - evt.time_range.start) / 1e6
    busy = sum(t for _, t in kernels.values())
    print(f"VAE 1.0 decode [13, 16, 60, 90] -> {list(want.shape)}, float32, TF32 off: wall {wall:.4f} s (profiled), "
          f"device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}, peak {peak / 2**30:.2f} GiB ({card})")
    fams = {}
    for name, (n, t) in kernels.items():
        f = fams.setdefault(family(name), [0, 0.0])
        f[0] += n
        f[1] += t
    for fam, (n, t) in sorted(fams.items(), key=lambda kv: -kv[1][1]):
        print(f"  {fam:28s} {t:9.4f} s  {100 * t / wall:5.1f} %  {n:6d} kernels")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:8]:
        print(f"    {t:8.4f} s {n:5d}x  {name[:110]}")

    t0 = time.perf_counter()
    decode()
    fp32_s = time.perf_counter() - t0
    torch.backends.cudnn.benchmark = True
    try:
        decode()  # cuDNN times its algorithms for each new shape
        t0 = time.perf_counter()
        tuned = decode()
        tuned_s = time.perf_counter() - t0
    finally:
        torch.backends.cudnn.benchmark = False
    tuned_rel = float((tuned - want).norm() / want.norm())
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    guard = autoencoder._no_tf32
    autoencoder._no_tf32 = contextlib.nullcontext
    try:
        decode()  # warm-up of the TF32 algorithms
        t0 = time.perf_counter()
        got = decode()
        tf32_s = time.perf_counter() - t0
    finally:
        autoencoder._no_tf32 = guard
        torch.backends.cudnn.allow_tf32 = tf32
    rel = float((got - want).norm() / want.norm())
    u8 = (torch.from_numpy(frames_to_uint8(got)).int() - torch.from_numpy(frames_to_uint8(want)).int()).abs()
    print(f"decode wall, unprofiled: float32 {fp32_s:.4f} s, float32 with cudnn.benchmark {tuned_s:.4f} s (frames "
          f"relative L2 {tuned_rel:.3g} from the default's), TF32 allowed {tf32_s:.4f} s; TF32 frames vs float32: "
          f"relative L2 {rel:.4g}, max |uint8 diff| {int(u8.max())}, {float((u8 > 0).float().mean()) * 100:.3f} % of "
          f"values differ ({card})")


if __name__ == "__main__":
    main()
