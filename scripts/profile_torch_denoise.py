"""Where one denoise eval of the PyTorch port spends its time on a CUDA card.

Builds the 3 s sampling model (configs/eval/ttt-mlp/3s.toml, or the TOML
given with --job.config_file, e.g. configs/eval/ttt-linear/3s.toml or a 9 s
or 63 s one: the TOML's frame count and scene count, random text of its
txt_maxlen; random weights), runs one warm-up CFG-doubled denoise eval, then one eval under
torch.profiler, and prints the eval's wall time, the summed device-kernel
time (kernels run on one stream, so the sum is the busy time), the idle
share, the time per kernel family and the top kernels.

    python scripts/profile_torch_denoise.py [--job.config_file TOML]
"""

from __future__ import annotations

import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (
    ("ttt_mlp_forward (K1)", ("ttt_mlp_fwd",)),
    ("ttt_linear_forward (K5)", ("ttt_linear_fwd",)),
    ("attention_forward (K3)", ("attention_fwd",)),
    ("matmul (cuBLAS)", ("gemm", "nvjet", "xmma", "cutlass", "sm90_")),
    ("conv (cuDNN)", ("conv", "cudnn")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "elementwise / reduction / copy"


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")

    from ttt_video_dit_torch.models.dit import sampler as S
    from ttt_video_dit_torch.sample import build_model, model_config, parse_args

    job = parse_args(argv if "--job.config_file" in argv else ["--job.config_file", "configs/eval/ttt-mlp/3s.toml"] + argv)
    cfg = model_config(job)
    device = torch.device("cuda", 0)
    model = build_model(cfg, device)
    gen = torch.Generator(device).manual_seed(0)
    ev = job.eval
    text = torch.randn(1, cfg.num_chunks, ev.txt_maxlen, cfg.text_dim, generator=gen, device=device)
    denoise = S.make_cfg_denoise_fn(model, text, torch.zeros_like(text))
    x = torch.randn(1, ev.sampling_num_frames, 16, ev.image_height // 8, ev.image_width // 8, generator=gen,
                    device=device)

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        denoise(x, 0.5, 500.0)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=acts) as prof:
            t0 = time.perf_counter()
            denoise(x, 0.5, 500.0)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0

    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            k = kernels.setdefault(evt.name, [0, 0.0])
            k[0] += 1
            k[1] += (evt.time_range.end - evt.time_range.start) / 1e6
    busy = sum(t for _, t in kernels.values())
    print(f"{cfg.ssm_layer} d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, "
          f"{ev.sampling_num_frames} frames x {cfg.num_chunks} scenes of {ev.txt_maxlen} text tokens, CFG batch 2: "
          f"eval wall {wall:.4f} s, device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}")
    fams = {}
    for name, (n, t) in kernels.items():
        f = fams.setdefault(family(name), [0, 0.0])
        f[0] += n
        f[1] += t
    for fam, (n, t) in sorted(fams.items(), key=lambda kv: -kv[1][1]):
        print(f"  {fam:32s} {t:9.4f} s  {100 * t / wall:5.1f}% of wall  {n:6d} launches")
    print("top kernels:")
    for name, (n, t) in sorted(kernels.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"  {t:9.4f} s {n:6d}x  {name[:110]}")


if __name__ == "__main__":
    main(sys.argv[1:])
