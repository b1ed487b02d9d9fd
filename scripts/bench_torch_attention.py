"""Times of the window-attention kernels on a CUDA card, against one PyTorch call.

At the 3 s slices' shapes (chip_smoke.py's): K3 at [2, 18048, 48, 64] (the
sampling launch, no log-sum-exp), K3 with the log-sum-exp and K4 at
[1, 18048, 48, 64]; K4 also at the 9 s and 63 s training windows
[3, 18052, 48, 64] and [21, 18072, 48, 64]; beside each,
scaled_dot_product_attention (forward, or its backward through autograd) on
the same inputs. Times are means over --reps launches after one warm-up, by
CUDA events; at the 3 s shape also K4's kernels one by one (torch.profiler
device time) and the MiB one K4 call allocates. Prints one JSON line.

    python scripts/bench_torch_attention.py [--reps N] [--tree DIR]

With --parent DIR (an unpacked checkout of another commit), it runs itself
four times in turn, on DIR's port, on this one, on this one and on DIR's
again, each in its own process on the same card, and prints the four lines
and the mean of each side:

    python scripts/bench_torch_attention.py --parent output/parent
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEQ = 18048
# K4's shapes: the 3 s training windows, the 9 s ones (3 windows of 18,052) and the 63 s TTT-MLP train TOML's
# (21 windows of 18,072), all heads.
K4_SHAPES = {"K4": (1, SEQ, 48, 64), "K4_9s": (3, 18052, 48, 64), "K4_63s": (21, 18072, 48, 64)}


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


def profiled(fn) -> tuple[dict, float]:
    """({kernel name: device ms} of one ``fn()`` under torch.profiler, the MiB it allocated above what was
    allocated before it)."""
    import re

    import torch

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = lambda key: (re.findall(r"(\w+)(?:<[^(]*>)?\(", key) or [key])[0]
    kernels = {names(e.key): e.device_time_total / e.count / 1e3 for e in prof.key_averages()
               if e.device_time_total > 0}
    return kernels, (torch.cuda.max_memory_allocated() - base) / 2**20


def measure(tree: str, reps: int) -> dict:
    sys.path.insert(0, os.path.abspath(tree))
    import torch
    import torch.nn.functional as Fn

    from ttt_video_dit_torch.ops import attention

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    device = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device).manual_seed(0)
    heads = lambda x: x.transpose(1, 2)  # SDPA takes [B, H, S, F]
    sdpa = lambda q, k, v: Fn.scaled_dot_product_attention(heads(q), heads(k), heads(v))
    out = {"tree": os.path.dirname(os.path.dirname(os.path.abspath(attention.__file__))), "card": smi}

    q, k, v = (torch.randn(2, SEQ, 48, 64, generator=gen, device=device).mul(2.0).bfloat16() for _ in range(3))
    out["K3_ms"] = cuda_ms(lambda: attention.attention(q, k, v), reps)
    out["K3_sdpa_ms"] = cuda_ms(lambda: sdpa(q, k, v), reps)
    q, k, v, do = (torch.randn(1, SEQ, 48, 64, generator=gen, device=device).bfloat16() for _ in range(4))
    out["K3_lse_ms"] = cuda_ms(lambda: attention.attention_with_lse(q, k, v), reps)
    out["K3_lse_sdpa_ms"] = cuda_ms(lambda: sdpa(q, k, v), reps)
    for key, shape in K4_SHAPES.items():
        if shape != (1, SEQ, 48, 64):
            del q, k, v, do
            torch.cuda.empty_cache()
            q, k, v, do = (torch.randn(*shape, generator=gen, device=device).bfloat16() for _ in range(4))
        o, lse = attention.attention_with_lse(q, k, v)
        out[f"{key}_ms"] = cuda_ms(lambda: attention.attention_backward(q, k, v, o, lse, do), reps)
        if key == "K4":  # its launches one by one, and the memory one call allocates
            out["K4_kernels"], out["K4_alloc_mib"] = profiled(lambda: attention.attention_backward(q, k, v, o, lse, do))
        ql, kl, vl = (heads(x).detach().requires_grad_(True) for x in (q, k, v))
        lib_out = Fn.scaled_dot_product_attention(ql, kl, vl)
        out[f"{key}_sdpa_ms"] = cuda_ms(
            lambda: torch.autograd.grad(lib_out, (ql, kl, vl), heads(do), retain_graph=True), reps)
        del o, lse, ql, kl, vl, lib_out
    return out


def compare(parent: str, reps: int) -> None:
    runs = []
    for tree in (parent, ROOT, ROOT, parent):
        tree = os.path.abspath(tree)
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--reps", str(reps), "--tree", tree],
                              cwd=tree, capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"run on {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        runs.append(json.loads(proc.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    for side, pair in (("parent", (runs[0], runs[3])), ("this tree", (runs[1], runs[2]))):
        keys = [key for key in pair[0] if key.endswith("_ms")]
        print(f"{side} mean: " + ", ".join(f"{key} {sum(r[key] for r in pair) / 2:.3f}" for key in keys))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--tree", default=ROOT, help="the checkout whose port is timed (default: this one)")
    ap.add_argument("--parent", help="an unpacked checkout of another commit to compare with")
    args = ap.parse_args()
    if args.parent:
        compare(args.parent, args.reps)
    else:
        print(json.dumps(measure(args.tree, args.reps)))


if __name__ == "__main__":
    main()
