"""Times of K1 (the TTT-MLP sampling scan), K1-train and K2 (the TTT-MLP training scan and its backward), K5,
K5-train and K6 (the same for TTT-linear) and K7 (the float32 -> bf16 weight cast) on a CUDA card.

At the 3 s slices' shapes (chip_smoke.py's): K1 at [B 2, NC 1,128, CS 16,
48 heads x 64] with eta_scale 0.1 / 64 / 16; K1-train at [B 1, NC 282,
CS 64, 48 heads x 64], K 16, eta_scale 0.1 / 64 / 64, and K2 from its
checkpoints; K5 at [B 2, NC 1,128, CS 16, 48 heads x 64] with eta_scale
1.0 / 64 / 16; K5-train at [B 1, NC 1,128, CS 16], K 4, the same eta, and
K6 from its checkpoints (--reps launches each); at the model's default
mini-batch CS 64 (chip_smoke.py's phase-19 slices), K5 at [B 2, NC 282,
8 heads] (the debug eval TOML), K5-train and K6 at [B 1, NC 282, 48 heads],
K 4, eta_scale 1.0 / 64 / 64, and K1 at [B 2, NC 282, 48 heads] with
eta_scale 0.1 / 64 / 64; and K5 at CS 32, [B 2, NC 564, 48 heads] (keys
``*_cs64_ms``, ``K5_cs32_ms``, only for a tree whose wrappers take those
mini-batches); K7 on a [12288, 3072]
float32 weight beside ``.to(torch.bfloat16)`` on the same tensor, the two
timed in turns (--rounds rounds of --k7-reps launches each, after one
untimed round); then, after K7, the TTT-MLP kernels at the other
mini-batches of the 3 s slices (chip_smoke.py's phase-20 slices, only for a
tree whose wrappers take them): K1 at CS 32 and 48, [B 2, NC 564 and 376,
48 heads], and K1-train and K2 at CS 16, 32 and 48, [B 1, NC 1,128, 564 and
376], K 16, each at eta_scale 0.1 / 64 / CS (keys ``K1_cs32_ms``,
``K1_train_cs16_ms``, ``K2_cs16_ms`` etc.); last, every TTT kernel at the
half slabs of CS 8 and 24 at the 3 s slices (NC 2,256 and 752: K1 and K5 at
B 2, the training kernels at B 1; keys ``K1_cs8_ms``, ``K6_cs24_ms`` etc.,
only for a tree that takes them); and the float32 kernels (float32 q/k/v)
at the 3 s slices: K1 at [B 2, NC 1,128, CS 16], K1-train and K2 at [B 1,
NC 282, CS 64], K 16, K5 at [B 2, NC 1,128, CS 16], K5-train and K6 at
[B 1, NC 1,128, CS 16], K 4 (keys ``K1_f32_ms``, ``K2_f32_ms`` etc., only
for a tree whose wrappers take float32). Times are means
by CUDA events after one warm-up; K7's and ``.to``'s device times are also
read once from torch.profiler, so the wrapper's host time is not in them.
Prints one JSON line.

    python scripts/bench_torch_kernels.py [--reps N] [--k7-reps N] [--rounds N] [--tree DIR]

With --parent DIR (an unpacked checkout of another commit), it runs itself
four times in turn, on DIR's port, on this one, on this one and on DIR's
again, each in its own process on the same card, and prints the four lines
and the mean of each side:

    python scripts/bench_torch_kernels.py --parent output/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NC, CS, H, F = 1128, 16, 48, 64
NC_TRAIN, CS_TRAIN, K_TRAIN = 282, 64, 16
K_LINEAR = 4
SEQ = NC * CS  # tokens of the 3 s slices: every mini-batch's NC is SEQ / CS


def cuda_ms(fn, reps: int) -> float:
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def device_us(fn, reps: int) -> float | None:
    """Mean device time of the kernel ``fn`` launches, by torch.profiler (None if it shows none)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [ev.device_time for ev in prof.key_averages() if ev.count == reps and ev.device_time > 0]
    return max(times) if times else None


def linear_inputs(gen, device, B: int, NC: int, CS: int, H: int) -> dict:
    """A TTT scan's q/k/v, gate, rope tables and LN affine (no state) at [B, NC, CS, H heads x 64]."""
    import torch

    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=device) * std
    angles = torch.rand(NC, CS, F // 2, generator=gen, device=device) * 6.3
    return dict(XQ=randn(B, NC, CS, H * F).bfloat16(), XK=randn(B, NC, CS, H * F).bfloat16(),
                XV=randn(B, NC, CS, H * F).bfloat16(), gate=randn(B, H, NC, CS),
                rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
                rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
                ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1))


def measure(tree: str, reps: int, k7_reps: int, rounds: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from ttt_video_dit_torch.ops import convert, ttt_linear_kernel, ttt_mlp_kernel

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device).manual_seed(0)
    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=device) * std
    angles = torch.rand(NC, CS, F // 2, generator=gen, device=device) * 6.3
    a = dict(XQ=randn(2, NC, CS, H * F).bfloat16(), XK=randn(2, NC, CS, H * F).bfloat16(),
             XV=randn(2, NC, CS, H * F).bfloat16(), gate=randn(2, H, NC, CS),
             rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
             rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
             ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1), W1=randn(H, F, 4 * F, std=0.02),
             b1=randn(H, 1, 4 * F, std=0.02), W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02))
    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(convert.__file__))), "card": smi}
    out["K1_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_forward(**a, eta_scale=0.1 / 64 / 16), reps)
    del a

    # K1-train and K2 at the training slice; K2 from K1-train's checkpoints.
    angles = torch.rand(NC_TRAIN, CS_TRAIN, F // 2, generator=gen, device=device) * 6.3
    t = dict(XQ=randn(1, NC_TRAIN, CS_TRAIN, H * F).bfloat16(), XK=randn(1, NC_TRAIN, CS_TRAIN, H * F).bfloat16(),
             XV=randn(1, NC_TRAIN, CS_TRAIN, H * F).bfloat16(), gate=randn(1, H, NC_TRAIN, CS_TRAIN),
             rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
             rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
             ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1), W1=randn(H, F, 4 * F, std=0.02),
             b1=randn(H, 1, 4 * F, std=0.02), W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02))
    eta = 0.1 / 64 / 64
    fwd = lambda: ttt_mlp_kernel.ttt_mlp_forward_train(**t, eta_scale=eta, checkpoint_group=K_TRAIN)
    out["K1_train_ms"] = cuda_ms(fwd, reps)
    ck = fwd()[1:]
    dout = randn(*t["XQ"].shape).bfloat16()
    ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    out["K2_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_backward(*ins, *ck, dout, eta, K_TRAIN), reps)
    del t, ck, dout, ins

    # K5 at the sampling slice; K5-train and K6 at the training slice, K6 from K5-train's checkpoints.
    eta = 1.0 / 64 / 16
    for B, key in ((2, "K5_ms"), (1, "K5_train_ms")):
        angles = torch.rand(NC, CS, F // 2, generator=gen, device=device) * 6.3
        t = dict(XQ=randn(B, NC, CS, H * F).bfloat16(), XK=randn(B, NC, CS, H * F).bfloat16(),
                 XV=randn(B, NC, CS, H * F).bfloat16(), gate=randn(B, H, NC, CS),
                 rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
                 rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
                 ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1), W1=randn(H, F, F, std=0.02),
                 b1=randn(H, 1, F, std=0.02))
        if B == 2:
            out[key] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_forward(**t, eta_scale=eta), reps)
            continue
        fwd = lambda: ttt_linear_kernel.ttt_linear_forward_train(**t, eta_scale=eta, checkpoint_group=K_LINEAR)
        out[key] = cuda_ms(fwd, reps)
        ck = fwd()[1:]
        dout = randn(*t["XQ"].shape).bfloat16()
        ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
        out["K6_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_backward(*ins, *ck, dout, eta, K_LINEAR), reps)
    del t, ck, dout, ins

    # The wider mini-batches, where the tree's wrappers take them.
    wide = getattr(ttt_linear_kernel, "KERNEL_MINI_BATCHES", (16,))
    linear = lambda B, NC, CS, H: dict(linear_inputs(gen, device, B, NC, CS, H), W1=randn(H, F, F, std=0.02),
                                       b1=randn(H, 1, F, std=0.02))
    if 64 in wide:
        eta = 1.0 / 64 / 64
        t = linear(2, NC_TRAIN, 64, 8)
        out["K5_cs64_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_forward(**t, eta_scale=eta), reps)
        t = linear(1, NC_TRAIN, 64, H)
        fwd = lambda: ttt_linear_kernel.ttt_linear_forward_train(**t, eta_scale=eta, checkpoint_group=K_LINEAR)
        out["K5_train_cs64_ms"] = cuda_ms(fwd, reps)
        ck = fwd()[1:]
        dout = randn(*t["XQ"].shape).bfloat16()
        ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
        out["K6_cs64_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_backward(*ins, *ck, dout, eta, K_LINEAR),
                                    reps)
        del t, ck, dout, ins
    if 32 in wide:
        t = linear(2, 2 * NC_TRAIN, 32, H)
        out["K5_cs32_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_forward(**t, eta_scale=1.0 / 64 / 32), reps)
        del t
    if 64 in getattr(ttt_mlp_kernel, "KERNEL_MINI_BATCHES", (16,)):
        t = dict(linear_inputs(gen, device, 2, NC_TRAIN, 64, H), W1=randn(H, F, 4 * F, std=0.02),
                 b1=randn(H, 1, 4 * F, std=0.02), W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02))
        out["K1_cs64_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_forward(**t, eta_scale=0.1 / 64 / 64), reps)
        del t

    w = randn(12288, 3072)
    k7, to = (lambda: convert.convert_f32_bf16(w)), (lambda: w.to(torch.bfloat16))
    k7_ms, to_ms = [], []
    cuda_ms(k7, k7_reps), cuda_ms(to, k7_reps)  # a round untimed: the first after K1 ran slow
    for _ in range(rounds):
        k7_ms.append(cuda_ms(k7, k7_reps))
        to_ms.append(cuda_ms(to, k7_reps))
    out["K7_ms"], out["K7_to_ms"] = sum(k7_ms) / rounds, sum(to_ms) / rounds
    out["K7_rounds_ms"], out["K7_to_rounds_ms"] = k7_ms, to_ms
    out["K7_device_us"], out["K7_to_device_us"] = device_us(k7, k7_reps), device_us(to, k7_reps)
    del w

    # The TTT-MLP kernels at their other mini-batches, where the tree's wrappers take them (a tree whose training
    # wrappers take CS 64 alone names it KERNEL_TRAIN_MINI_BATCH).
    sampling_cs = getattr(ttt_mlp_kernel, "KERNEL_MINI_BATCHES", (16,))
    training_cs = (64,) if hasattr(ttt_mlp_kernel, "KERNEL_TRAIN_MINI_BATCH") else sampling_cs
    mlp = lambda B, cs: dict(linear_inputs(gen, device, B, SEQ // cs, cs, H), W1=randn(H, F, 4 * F, std=0.02),
                             b1=randn(H, 1, 4 * F, std=0.02), W2=randn(H, 4 * F, F, std=0.02),
                             b2=randn(H, 1, F, std=0.02))
    for cs in (32, 48):
        if cs in sampling_cs:
            t = mlp(2, cs)
            out[f"K1_cs{cs}_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_forward(**t, eta_scale=0.1 / 64 / cs), reps)
            del t
    for cs in (16, 32, 48):
        if cs in training_cs:
            t, eta = mlp(1, cs), 0.1 / 64 / cs
            fwd = lambda: ttt_mlp_kernel.ttt_mlp_forward_train(**t, eta_scale=eta, checkpoint_group=K_TRAIN)
            out[f"K1_train_cs{cs}_ms"] = cuda_ms(fwd, reps)
            ck = fwd()[1:]
            dout = randn(*t["XQ"].shape).bfloat16()
            ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
            out[f"K2_cs{cs}_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_backward(*ins, *ck, dout, eta, K_TRAIN), reps)
            del t, ck, dout, ins

    # The half slabs at the 3 s slices, CS 8 and 24, where the tree's wrappers take them: K1 and K5 (B 2), K1-train
    # and K2 (K 16), K5-train and K6 (K 4), 48 heads.
    for cs in (8, 24):
        if cs not in sampling_cs:
            continue
        t = mlp(2, cs)
        out[f"K1_cs{cs}_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_forward(**t, eta_scale=0.1 / 64 / cs), reps)
        t, eta = mlp(1, cs), 0.1 / 64 / cs
        fwd = lambda: ttt_mlp_kernel.ttt_mlp_forward_train(**t, eta_scale=eta, checkpoint_group=K_TRAIN)
        out[f"K1_train_cs{cs}_ms"] = cuda_ms(fwd, reps)
        ck = fwd()[1:]
        dout = randn(*t["XQ"].shape).bfloat16()
        ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
        out[f"K2_cs{cs}_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_backward(*ins, *ck, dout, eta, K_TRAIN), reps)
        t, eta = linear(2, SEQ // cs, cs, H), 1.0 / 64 / cs
        out[f"K5_cs{cs}_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_forward(**t, eta_scale=eta), reps)
        t = linear(1, SEQ // cs, cs, H)
        fwd = lambda: ttt_linear_kernel.ttt_linear_forward_train(**t, eta_scale=eta, checkpoint_group=K_LINEAR)
        out[f"K5_train_cs{cs}_ms"] = cuda_ms(fwd, reps)
        ck = fwd()[1:]
        dout = randn(*t["XQ"].shape).bfloat16()
        ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
        out[f"K6_cs{cs}_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_backward(*ins, *ck, dout, eta, K_LINEAR),
                                       reps)
        del t, ck, dout, ins

    # The float32 kernels at the 3 s slices, where the tree's wrappers take float32 q/k/v.
    if torch.float32 not in getattr(ttt_mlp_kernel, "KERNEL_DTYPES", ()):
        return out
    f32 = lambda d: {k: v.float() if k in ("XQ", "XK", "XV") else v for k, v in d.items()}
    t = f32(mlp(2, CS))
    out["K1_f32_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_forward(**t, eta_scale=0.1 / 64 / CS), reps)
    t, eta = f32(mlp(1, CS_TRAIN)), 0.1 / 64 / CS_TRAIN
    fwd = lambda: ttt_mlp_kernel.ttt_mlp_forward_train(**t, eta_scale=eta, checkpoint_group=K_TRAIN)
    out["K1_train_f32_ms"] = cuda_ms(fwd, reps)
    ck = fwd()[1:]
    dout = randn(*t["XQ"].shape)
    ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    out["K2_f32_ms"] = cuda_ms(lambda: ttt_mlp_kernel.ttt_mlp_backward(*ins, *ck, dout, eta, K_TRAIN), reps)
    del t, ck, dout, ins
    eta = 1.0 / 64 / CS
    t = f32(linear(2, NC, CS, H))
    out["K5_f32_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_forward(**t, eta_scale=eta), reps)
    t = f32(linear(1, NC, CS, H))
    fwd = lambda: ttt_linear_kernel.ttt_linear_forward_train(**t, eta_scale=eta, checkpoint_group=K_LINEAR)
    out["K5_train_f32_ms"] = cuda_ms(fwd, reps)
    ck = fwd()[1:]
    dout = randn(*t["XQ"].shape)
    ins = [t[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    out["K6_f32_ms"] = cuda_ms(lambda: ttt_linear_kernel.ttt_linear_backward(*ins, *ck, dout, eta, K_LINEAR), reps)
    return out


def compare(parent: str, args) -> None:
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--reps", str(args.reps), "--k7-reps",
                               str(args.k7_reps), "--rounds", str(args.rounds), "--tree", tree],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"run on {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for side, pair in (("parent", (runs[0], runs[3])), ("this tree", (runs[1], runs[2]))):
        keys = [key for key in pair[0] if isinstance(pair[0][key], float) and isinstance(pair[1][key], float)]
        print(f"{side} mean: " + ", ".join(f"{key} {sum(r[key] for r in pair) / 2:.4f}" for key in keys))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5, help="K1, K1-train, K2, K5, K5-train and K6 launches timed")
    ap.add_argument("--k7-reps", type=int, default=50, help="K7 (and .to) launches a round")
    ap.add_argument("--rounds", type=int, default=4, help="rounds of K7 then .to")
    ap.add_argument("--tree", default=ROOT, help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--parent", help="an unpacked checkout of another commit to compare with")
    args = ap.parse_args()
    if args.parent:
        compare(args.parent, args)
    else:
        print(json.dumps(measure(args.tree, args.reps, args.k7_reps, args.rounds)))


if __name__ == "__main__":
    main()
