"""GPU smoke test of the PyTorch port (ttt_video_dit_torch) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line with its timing; any failure raises and exits
non-zero, and no result line is printed):

1. device, card name and power limit; build and load the CUDA kernels from
   ttt_video_dit_torch/csrc/ (nvcc, sm_90a).
2. each kernel against its plain PyTorch version on the card, at the 3 s
   slice's shapes and at a small ragged shape, with times.
3. one DiffusionTransformer forward at full width (d3072, 48 heads) and
   2 layers, kernel path against the plain functions, same weights.
4. the sampling entry (ttt_video_dit_torch.sample.main) on
   configs/eval/ttt-mlp/3s.toml at 42 layers, 3 denoise steps; kernel launch
   counts from exactly that run; finite latents of the expected shape.

The second-to-last line is the kernels' JSON record; the last line is
{"ok": true, "device": {...}}. Float32 matmuls run without TF32 here so the
plain versions are exact float32 references.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import torch

SAMPLE_ARGS = [
    "--job.config_file", "configs/eval/ttt-mlp/3s.toml", "--eval.input_file", "inputs/example.json",
    "--eval.num_denoising_steps", "3", "--guider.num_steps", "3",
]
# |kernel - plain| <= ATOL + RTOL * |plain| elementwise, on bf16 outputs. Both
# kernels round at the plain versions' points; what remains is float32
# summation order (and, for attention, P rounded to bf16 before P V), i.e. a
# few bf16 ulps of outputs of magnitude up to ~5.
KERNEL_TOL = {"ttt_mlp_forward": (2e-2, 2e-2), "attention_forward": (2e-2, 2e-2)}
# Relative L2 error of the 2-layer DiT output, kernel path vs plain path: the
# bf16 stream carries the kernels' rounding differences through two layers.
DIT_REL_L2_TOL = 2e-2


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` runs after one warm-up, by CUDA events."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(name: str, got, want) -> float:
    atol, rtol = KERNEL_TOL[name]
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output has non-finite values")
    err = (got - want).abs()
    bad = err > atol + rtol * want.abs()
    if bad.any():
        raise AssertionError(f"{name}: {int(bad.sum())} elements outside atol={atol} rtol={rtol}; "
                             f"max_abs_err={float(err.max()):.4g}")
    return float(err.max())


def phase_build():
    from ttt_video_dit_torch.ops import _build, attention, ttt_mlp_kernel

    t0 = time.perf_counter()
    for lib in (ttt_mlp_kernel._lib(), attention._lib()):
        assert lib is not None
    for name, info in _build.build_info.items():
        usage = [ln.strip() for ln in info["ptxas"].splitlines() if "registers" in ln or "spill" in ln]
        log(f"  {name}: built in {info['seconds']:.1f} s; ptxas: {' | '.join(usage)}")
    smem = _build.load("ttt_mlp_forward").ttt_mlp_forward_smem_bytes()
    log(f"phase 1 build: {time.perf_counter() - t0:.1f} s (ttt_mlp_forward dynamic shared memory {smem} bytes)")


def _ttt_inputs(B, H, NC, gen, device, meta=None):
    from ttt_video_dit_torch.models.ttt.layer import scan_rope_tables

    CS, F = 16, 64
    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=device) * std
    x = lambda: randn(B, NC, CS, H * F).to(torch.bfloat16)
    if meta is None:
        angles = torch.rand(NC, CS, F // 2, generator=gen, device=device) * 6.3
        cos, sin = (t.repeat_interleave(2, dim=-1).contiguous() for t in (torch.cos(angles), torch.sin(angles)))
    else:
        cos, sin = scan_rope_tables(meta, F, 10000.0, CS, device)
    return dict(
        XQ=x(), XK=x(), XV=x(), gate=randn(B, H, NC, CS), rope_cos=cos, rope_sin=sin,
        ln_w=1.0 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1),
        W1=randn(H, F, 4 * F, std=0.02), b1=randn(H, 1, 4 * F, std=0.02),
        W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02),
    )


def phase_kernels(device) -> list[dict]:
    from ttt_video_dit_torch import sample
    from ttt_video_dit_torch.models.dit.dit import sequence_metadata
    from ttt_video_dit_torch.ops import attention, ttt_mlp_kernel

    t0 = time.perf_counter()
    gen = torch.Generator(device).manual_seed(0)
    eta_scale = 0.1 / 64 / 16
    records = []

    # K1 at the slice (B=2 CFG, 48 heads, NC=1128 at CS=16, the 3 s tables) and ragged.
    meta = sequence_metadata(sample.model_config(sample.parse_args(SAMPLE_ARGS)), num_frames=13,
                             latent_height=60, latent_width=90, num_scenes=1, text_length=498)
    for B, H, NC, m in ((2, 48, 1128, meta), (1, 2, 7, None)):
        a = _ttt_inputs(B, H, NC, gen, device, m)
        got = ttt_mlp_kernel.ttt_mlp_forward(**a, eta_scale=eta_scale)
        want = ttt_mlp_kernel.ttt_mlp_forward_plain(**a, eta_scale=eta_scale)
        err = compare("ttt_mlp_forward", got, want)
        log(f"  ttt_mlp_forward B={B} H={H} NC={NC}: max_abs_err {err:.4g} (tol {KERNEL_TOL['ttt_mlp_forward']})")
        if NC == 1128:
            k1 = dict(a=a, err=err)
    k1_ms = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_forward(**k1["a"], eta_scale=eta_scale), 5)
    k1_plain_ms = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_forward_plain(**k1["a"], eta_scale=eta_scale), 1)
    log(f"  ttt_mlp_forward slice: kernel {k1_ms:.3f} ms, plain {k1_plain_ms:.3f} ms")
    records.append(dict(name="ttt_mlp_forward", route="cuda", source="ttt_video_dit_torch/csrc/ttt_mlp_forward.cu",
                        replaces="ttt_video_dit_tpu/ops/pallas/ttt_forward.py:247", max_abs_err=k1["err"],
                        ms=k1_ms, plain_ms=k1_plain_ms))

    # K3 at the slice ([2, 18048, 48, 64], one window per CFG sample) and ragged (3 windows of 417).
    for shape in ((2, 18048, 48, 64), (3, 417, 4, 64)):
        q, k, v = (torch.randn(*shape, generator=gen, device=device).mul(2.0).to(torch.bfloat16) for _ in range(3))
        got = attention.attention(q, k, v)
        want = attention.attention_plain(q, k, v)
        err = compare("attention_forward", got, want)
        log(f"  attention_forward {list(shape)}: max_abs_err {err:.4g} (tol {KERNEL_TOL['attention_forward']})")
        if shape[1] == 18048:
            k3 = dict(qkv=(q, k, v), err=err)
    k3_ms = cuda_ms(lambda: attention.attention(*k3["qkv"]), 5)
    k3_plain_ms = cuda_ms(lambda: attention.attention_plain(*k3["qkv"]), 1)
    flops = 4 * 2 * 48 * 18048**2 * 64
    log(f"  attention_forward slice: kernel {k3_ms:.3f} ms ({flops / k3_ms / 1e9:.1f} TFLOP/s), plain {k3_plain_ms:.3f} ms")
    records.append(dict(name="attention_forward", route="cuda", source="ttt_video_dit_torch/csrc/attention_forward.cu",
                        replaces="ttt_video_dit_tpu/ops/attention.py:265", max_abs_err=k3["err"],
                        ms=k3_ms, plain_ms=k3_plain_ms))
    log(f"phase 2 kernels vs plain: {time.perf_counter() - t0:.1f} s")
    return records


def phase_dit(device) -> None:
    from ttt_video_dit_torch.sample import build_model, model_config, parse_args

    t0 = time.perf_counter()
    cfg = model_config(parse_args(SAMPLE_ARGS + ["--model.num_layers", "2"]))
    model = build_model(cfg, device, seed=1)
    gen = torch.Generator(device).manual_seed(2)
    video = torch.randn(2, 13, 16, 60, 90, generator=gen, device=device)
    text = torch.randn(2, 1, 498, cfg.text_dim, generator=gen, device=device)
    timesteps = torch.tensor([999.0, 500.0], device=device)
    outs = {}
    with torch.inference_mode():
        for use_kernel in (False, True):
            cfg.use_kernel = use_kernel
            outs[use_kernel] = model.dit(video.to(torch.bfloat16), text, timesteps).float()
    ref, got = outs[False], outs[True]
    if not torch.isfinite(got).all():
        raise AssertionError("DiT kernel-path output has non-finite values")
    rel = float((got - ref).norm() / ref.norm())
    if rel > DIT_REL_L2_TOL:
        raise AssertionError(f"DiT kernel path vs plain path: relative L2 error {rel:.4g} > {DIT_REL_L2_TOL}")
    log(f"phase 3 DiT d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, kernel vs plain: "
        f"rel L2 {rel:.4g} (tol {DIT_REL_L2_TOL}), max_abs_err {float((got - ref).abs().max()):.4g}: "
        f"{time.perf_counter() - t0:.1f} s")
    del model


def phase_sample(device) -> dict[str, int]:
    import numpy as np

    from ttt_video_dit_torch import sample
    from ttt_video_dit_torch.ops import attention, ttt_mlp_kernel

    t0 = time.perf_counter()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    job = sample.parse_args(SAMPLE_ARGS)
    ttt_mlp_kernel.launches = 0
    attention.launches = 0
    summary = sample.main(job)
    counts = {"ttt_mlp_forward": ttt_mlp_kernel.launches, "attention_forward": attention.launches}
    cfg = summary["model_config"]
    evals = len(summary["eval_seconds"])
    if summary["device"].split(":")[0] != "cuda":
        raise AssertionError(f"sampling ran on {summary['device']}, not the card")
    if counts["ttt_mlp_forward"] != 2 * cfg.num_layers * evals or counts["attention_forward"] != cfg.num_layers * evals:
        raise AssertionError(f"kernel launches {counts} do not match {cfg.num_layers} layers x {evals} evals")
    latents = np.load(summary["latents"][0])
    if latents.shape != (13, 16, 60, 90) or not np.isfinite(latents).all():
        raise AssertionError(f"latents {latents.shape} not finite of shape (13, 16, 60, 90)")
    steady = summary["eval_seconds"][1:] or summary["eval_seconds"]
    log(f"phase 4 sample d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, {evals} evals: "
        f"{sum(steady) / len(steady):.3f} s/eval after the first ({summary['eval_seconds'][0]:.3f} s first), "
        f"peak {torch.cuda.max_memory_allocated(device) / 2**30:.2f} GiB, launches {counts}, "
        f"latents finite, std {float(latents.std()):.4f}: {time.perf_counter() - t0:.1f} s")
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"device: torch {torch.__version__}, CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)} "
        f"x {torch.cuda.device_count()}; tf32 off")
    phase_build()
    records = phase_kernels(device)
    phase_dit(device)
    counts = phase_sample(device)
    for r in records:
        r["launches"] = counts[r["name"]]
    print(smi)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
