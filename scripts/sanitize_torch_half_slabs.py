"""The six TTT kernels at the half slabs: out-of-bounds reads and writes.

    python scripts/sanitize_torch_half_slabs.py [--cs 8 56] [--tools memcheck initcheck guard] [--out DIR]

Every tool drives one worker: K1, K1-train, K2, K5, K5-train and K6 on the
kernel self-test's ragged cases at each CS (ttt_video_dit_torch/utils/
selftest.py: 8 heads, NC 5 with checkpoint groups of 2, so the last group
holds one mini-batch), at B 2, so the last mini-batch of the second batch
row ends the q/k/v, gate, rope, output and gradient tensors.

- ``memcheck`` and ``initcheck`` run the worker under ``compute-sanitizer
  --tool <tool>`` (from the CUDA toolkit: $CUDA_HOME/bin, else PATH) with
  PyTorch's caching allocator off (PYTORCH_NO_CUDA_MEMORY_CACHING=1: every
  tensor its own allocation) and, for memcheck, a 256-byte guard after every
  allocation. A sanitizer that refuses the card ("Device not supported") is
  reported as such, with no verdict.
- ``guard`` needs no sanitizer: every input of a kernel (q/k/v, gate, rope
  tables, the output gradient) is the head of a buffer whose next mini-batch's
  worth of elements is NaN, and every tensor the wrappers allocate (outputs,
  checkpoints, workspaces) is the head of a buffer whose tail holds a canary.
  A row read past a tensor's end that enters the computation carries the NaN
  into the outputs (a half slab's padding meets eta = 0, and 0 x NaN is NaN);
  a write past an allocation's end changes its canary. The outputs must be
  finite, equal bit for bit to an unguarded run, and every canary intact. (A
  read that is loaded and never used leaves no trace here.)

Prints each tool's verdict and one JSON line; exits 1 if a tool found an
error, 2 if there is no card (or no tool could give a verdict).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
B, H, NC, K = 2, 8, 5, 2
CANARY = {"float": -12345.0, "int": 165}  # exact in bf16 and float32; a byte of a uint8 workspace


def run_kernels(CS: int, variant: str, guard: bool):
    """The variant's three kernels at mini-batch CS on the self-test's ragged arrays: the outputs, and with
    ``guard`` whether every canary of the tensors the wrappers allocated held."""
    import numpy as np
    import torch

    from ttt_video_dit_torch.ops import ttt_linear_kernel, ttt_mlp_kernel
    from ttt_video_dit_torch.utils import selftest

    mod = ttt_mlp_kernel if variant == "ttt_mlp" else ttt_linear_kernel
    device = torch.device("cuda", 0)
    a = selftest.ttt_arrays(np.random.default_rng(CS), variant, B, H, NC, CS)
    args = selftest._tensors(a, variant, device, grad=False)
    dout = torch.from_numpy(np.random.default_rng(1).standard_normal(args[0].shape, dtype=np.float32))
    dout = dout.to(device).bfloat16()
    allocated = []
    if guard:
        args = [nan_tailed(t) if i < 6 else t for i, t in enumerate(args)]  # q/k/v, gate, rope tables
        dout = nan_tailed(dout)
    eta = selftest.eta_scale(variant, CS)
    with canaried_allocations(allocated) if guard else contextlib.nullcontext():
        outs = [getattr(mod, f"{variant}_forward")(*args, eta)]
        outs += getattr(mod, f"{variant}_forward_train")(*args, eta, K)
        outs += getattr(mod, f"{variant}_backward")(*args[:8], *outs[2:], dout, eta, K)
        torch.cuda.synchronize()
    held = all(bool((buf[n:] == canary(buf.dtype)).all()) for buf, n in allocated)
    return [o.clone() for o in outs], held, len(allocated)


def canary(dtype) -> float:
    return CANARY["float" if dtype.is_floating_point else "int"]


def nan_tailed(t):
    """``t`` copied into the head of a buffer with one mini-batch's worth (t's numel / NC) of NaN after it."""
    import torch

    buf = torch.full((t.numel() + t.numel() // NC,), float("nan"), dtype=t.dtype, device=t.device)
    head = buf[: t.numel()].view(t.shape)
    head.copy_(t)
    return head


@contextlib.contextmanager
def canaried_allocations(allocated: list):
    """torch.empty and torch.empty_like on the card return the head of a buffer with 4,096 canary elements after
    it; ``allocated`` receives (buffer, head size) of each."""
    import torch

    empty, empty_like = torch.empty, torch.empty_like

    def tailed(shape, dtype, device):
        n = 1
        for s in shape:
            n *= s
        dtype = dtype or torch.float32
        buf = torch.full((n + 4096,), canary(dtype), dtype=dtype, device=device)
        allocated.append((buf, n))
        return buf[:n].view(shape)

    def guarded_empty(*shape, dtype=None, device=None, **kw):
        shape = tuple(shape[0]) if len(shape) == 1 and isinstance(shape[0], (tuple, list, torch.Size)) else shape
        if device is None or torch.device(device).type != "cuda" or kw:
            return empty(*shape, dtype=dtype, device=device, **kw)
        return tailed(shape, dtype, device)

    def guarded_empty_like(t, dtype=None, **kw):
        if t.device.type != "cuda" or kw:
            return empty_like(t, dtype=dtype, **kw)
        return tailed(tuple(t.shape), dtype or t.dtype, t.device)

    torch.empty, torch.empty_like = guarded_empty, guarded_empty_like
    try:
        yield
    finally:
        torch.empty, torch.empty_like = empty, empty_like


def worker(cs_list: list[int]) -> None:
    import torch

    for CS in cs_list:
        for variant in ("ttt_mlp", "ttt_linear"):
            outs, _, _ = run_kernels(CS, variant, guard=False)
            finite = all(bool(torch.isfinite(t).all()) for t in outs)
            print(f"worker: {variant} CS {CS}: forward, forward_train, backward launched, outputs finite {finite}",
                  flush=True)


def guard(cs_list: list[int]) -> dict:
    import torch

    results = {}
    for CS in cs_list:
        for variant in ("ttt_mlp", "ttt_linear"):
            plain_run, _, _ = run_kernels(CS, variant, guard=False)
            guarded, held, buffers = run_kernels(CS, variant, guard=True)
            finite = all(bool(torch.isfinite(t).all()) for t in guarded)
            same = all(torch.equal(g.view(torch.uint8), p.view(torch.uint8)) for g, p in zip(guarded, plain_run))
            results[f"{variant} CS {CS}"] = {"finite": finite, "equal_to_unguarded": same, "canaries_held": held,
                                             "guarded_allocations": buffers}
            print(f"guard: {variant} CS {CS}: outputs finite {finite}, equal to the unguarded run {same}, "
                  f"{buffers} allocations' canaries held {held}", flush=True)
    return results


def sanitizer() -> str | None:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    found = os.path.join(home, "bin", "compute-sanitizer")
    return found if os.path.exists(found) else shutil.which("compute-sanitizer")


def sanitize(tool: str, tool_path: str, cs_list: list[int], out: str) -> dict:
    env = dict(os.environ, PYTORCH_NO_CUDA_MEMORY_CACHING="1")
    cmd = [tool_path, "--tool", tool, "--error-exitcode", "1"] + (["--padding", "256"] if tool == "memcheck" else [])
    cmd += [sys.executable, os.path.abspath(__file__), "--worker", "--cs", *map(str, cs_list)]
    proc = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT, env=env)
    log = proc.stdout + proc.stderr
    with open(os.path.join(out, f"{tool}.log"), "w", encoding="utf-8") as f:
        f.write(log)
    if "Device not supported" in log:
        print(f"{tool}: compute-sanitizer refuses this card (\"Device not supported\"): no verdict", flush=True)
        return {"supported": False}
    summary = re.findall(r"ERROR SUMMARY: (\d+) errors?", log)
    launched = sum(ln.startswith("worker:") for ln in log.splitlines())
    print(f"{tool}: rc {proc.returncode}, ERROR SUMMARY {summary[-1] if summary else 'missing'} errors, "
          f"{launched} workers' kernels launched", flush=True)
    return {"supported": True, "rc": proc.returncode, "errors": int(summary[-1]) if summary else None,
            "launched": launched}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cs", type=int, nargs="+", default=[8, 56])
    ap.add_argument("--tools", nargs="+", default=["memcheck", "initcheck", "guard"])
    ap.add_argument("--out", default="output/sanitize_half_slabs", help="each sanitizer's full log goes here")
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.cs)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    tool_path = sanitizer()
    results, failed, verdicts = {}, False, 0
    for tool in args.tools:
        if tool == "guard":
            results[tool] = guard(args.cs)
            failed |= not all(all(r.values()) for r in results[tool].values())
            verdicts += 1
        elif tool_path is None:
            print(f"{tool}: compute-sanitizer not found (neither $CUDA_HOME/bin nor PATH): no verdict", flush=True)
            results[tool] = {"supported": None}
        else:
            results[tool] = r = sanitize(tool, tool_path, args.cs, args.out)
            if r["supported"]:
                failed |= not (r["rc"] == 0 and r["errors"] == 0 and r["launched"] == 2 * len(args.cs))
                verdicts += 1
    print(json.dumps({"card": card, "compute_sanitizer": tool_path, "cs": args.cs, "B": B, "H": H, "NC": NC, "K": K,
                      "tools": results}))
    return 1 if failed else 0 if verdicts else 2


if __name__ == "__main__":
    sys.exit(main())
