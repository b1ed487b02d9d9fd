"""Where one training step of the PyTorch port spends its time on a CUDA card.

Builds the 3 s training model (configs/train/ttt-mlp/3s.toml, or the TOML
given with --job.config_file, e.g. configs/train/ttt-linear/3s.toml; full
width, cut to 4 layers as chip_smoke.py runs it; random weights, synthetic
batch of 1), takes one warm-up step, then one step under torch.profiler, and
prints the step's wall time, the summed device-kernel time (kernels run on
one stream, so the sum is the busy time), the idle share, the time per
kernel family and the top kernels.

    python scripts/profile_torch_train.py [--job.config_file TOML] [--model.num_layers N]
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (
    ("ttt_mlp_forward_train (K1-train)", ("ttt_mlp_fwd_train",)),
    ("ttt_mlp_backward (K2)", ("ttt_mlp_bwd",)),
    ("ttt_linear_forward_train (K5-train)", ("ttt_linear_fwd",)),
    ("ttt_linear_backward (K6)", ("ttt_linear_bwd",)),
    ("convert_f32_bf16 (K7)", ("convert_kernel",)),
    ("attention_forward_lse (K3)", ("attention_fwd",)),
    ("attention_backward (K4)", ("attn_bwd",)),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("conv (cuDNN)", ("conv", "cudnn")),
)
TRAIN_ARGS = [
    "--model.num_layers", "4", "--training.steps", "2", "--training.global_batch_size", "1",
    "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1",
]


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise / reduction / copy"


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from ttt_video_dit_torch import train
    from ttt_video_dit_torch.training.optimizer import build_optimizer_from_config
    from ttt_video_dit_torch.training.setup import make_example_batch
    from ttt_video_dit_torch.training.train_step import train_step

    toml = [] if "--job.config_file" in argv else ["--job.config_file", "configs/train/ttt-mlp/3s.toml"]
    job = train.parse_args(toml + TRAIN_ARGS + argv)
    cfg = train.model_config(job)
    device = torch.device("cuda", 0)
    model = train.build_model(cfg, device, seed=0)
    opt = build_optimizer_from_config(model, job, cfg.adapter_method)
    batch = make_example_batch(cfg, 1, train.synthetic_text_length(cfg), seed=0, device=device)
    gen = torch.Generator(device).manual_seed(1)
    step = lambda: train_step(model, opt, batch, generator=gen)

    step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0, 0.0])
            k[0] += 1
            k[1] += (evt.time_range.end - evt.time_range.start) / 1e6
    busy = sum(t for _, t in kernels.values())
    print(f"train step {cfg.ssm_layer} d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, batch 1, L "
          f"{cfg.num_chunks * train.synthetic_text_length(cfg) + cfg.compressed_num_frames * cfg.tokens_per_frame}: "
          f"step wall {wall:.4f} s, device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}")
    fams = {}
    for name, (n, t) in kernels.items():
        f = fams.setdefault(family(name), [0, 0.0])
        f[0] += n
        f[1] += t
    for fam, (n, t) in sorted(fams.items(), key=lambda kv: -kv[1][1]):
        print(f"  {fam:36s} {t:9.4f} s  {100 * t / wall:5.1f}% of wall  {n:6d} launches")
    print("top kernels:")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:12]:
        print(f"  {t:9.4f} s  {n:5d}x  {name[:110]}")


if __name__ == "__main__":
    main(sys.argv[1:])
