"""K6 (the TTT-linear backward) against its plain version at the training slice under several input seeds, and what
the elements outside the elementwise tolerance are made of.

    python scripts/k6_tolerance_seeds.py [--seeds 0 1 2 3] [--tree DIR] [--parent DIR] [--explain N]

For each seed the inputs are drawn as chip_smoke.py draws the TTT-linear
training slice (its ``_ttt_inputs``: B 1, 48 heads, NC 1,128 at CS 16, the
3 s rope tables, then dout), K5-train's plain version gives the fp32
checkpoints every K = 4, and K6 and its plain version the gradients. It prints
one JSON line per seed: for dXQ, dXK, dXV and d_gate the number of elements
outside |kernel - plain| <= 2e-2 + 2e-2 |plain| (chip_smoke.py's tolerance),
the largest error and the largest ratio of error to tolerance, and the first
elements outside it.

With --parent DIR (an unpacked checkout of another commit) it runs the seeds
on DIR's kernel and then on this tree's, each in its own process. Then, for the
first --explain dXK elements outside the tolerance (this tree's first), this
tree's plain version re-runs the backward for that head alone from the full
run's checkpoints, on the card and on the CPU (two float32 summation orders),
records dXK's operands (its ``trace``), and splits the element into its four
terms, each carried through the rope and L2-norm VJPs: -Gs bf16(dW)^T,
bf16(dA1)^T XQ, -dtv (the target LN's VJP) and bf16(dZ1) W^T. It prints the
term that moves most between the two orders, how many of that term's bf16
operands flipped (in the mini-batch and in the element's row), the carry
entries whose one-ulp rounding moves the element most and how far each lies
from a rounding boundary, and, for an element of the first checkpoint group,
K6's own value for that head and its pass-A stash (Gs, bf16(W^T), Z1) held
against the plain version's.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H, NC, CS, F, K = 48, 1128, 16, 64, 4
ETA = 1.0 / 64 / 16
GRADS = ("dXQ", "dXK", "dXV", "d_gate")
INPUTS = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")


def inputs(seed: int, device):
    """chip_smoke.py's TTT-linear training-slice inputs from a generator seeded ``seed``, then dout."""
    import torch

    import chip_smoke

    _, meta = chip_smoke._training_meta("ttt_linear")
    gen = torch.Generator(device).manual_seed(seed)
    a = chip_smoke._ttt_inputs(1, H, NC, gen, device, meta, CS=CS, variant="ttt_linear")
    dout = torch.randn(*a["XQ"].shape, generator=gen, device=device).bfloat16()
    return a, dout


def measure(tree: str, seeds: list[int], top: int) -> None:
    sys.path.insert(0, os.path.abspath(tree))
    os.chdir(os.path.abspath(tree))
    import torch

    from ttt_video_dit_torch.ops import ttt_linear_kernel as tk

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    for seed in seeds:
        a, dout = inputs(seed, device)
        ck = tk.ttt_linear_forward_plain(**a, eta_scale=ETA, checkpoint_group=K)[1:]
        ins = [a[k] for k in INPUTS]
        got = tk.ttt_linear_backward(*ins, *ck, dout, ETA, K)
        want = tk.ttt_linear_backward_plain(*ins, *ck, dout, ETA, K)
        rec = {"tree": os.path.abspath(tree), "card": card, "seed": seed}
        for name, g, w in zip(GRADS, got, want):
            g, w = g.float(), w.float()
            err = (g - w).abs()
            ratio = err / (2e-2 + 2e-2 * w.abs())
            bad = (ratio > 1).nonzero().tolist()[:top]
            rec[name] = {"outside": int((ratio > 1).sum()), "max_abs_err": float(err.max()),
                         "max_tol_ratio": float(ratio.max()), "max_abs_plain": float(w.abs().max()),
                         "first": [{"at": i, "plain": float(w[tuple(i)]), "kernel": float(g[tuple(i)])} for i in bad]}
        print(json.dumps(rec), flush=True)
        del a, dout, ck, ins, got, want
        torch.cuda.empty_cache()


def explain(seed: int, at: list[int], kernel: float) -> dict:
    """Split the dXK element ``at`` = [b, n, r, h*F + f] of seed ``seed`` into its terms under two summation
    orders (this head's plain backward on the card and on the CPU)."""
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    from ttt_video_dit_torch.ops import ln as ln_ops
    from ttt_video_dit_torch.ops import ttt_linear_kernel as tk

    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    a, dout = inputs(seed, device)
    _, n, r, col = at
    h, f = divmod(col, F)
    cols = slice(h * F, (h + 1) * F)
    one = dict(XQ=a["XQ"][..., cols], XK=a["XK"][..., cols], XV=a["XV"][..., cols], gate=a["gate"][:, h:h + 1],
               rope_cos=a["rope_cos"], rope_sin=a["rope_sin"], ln_w=a["ln_w"][h:h + 1], ln_b=a["ln_b"][h:h + 1],
               W1=a["W1"][h:h + 1], b1=a["b1"][h:h + 1])
    one = {k: v.contiguous() for k, v in one.items()}
    d_one = dout[..., cols].contiguous()
    # The checkpoints of the full run (all heads), as the kernel and the plain version were given them there.
    ck = [c[:, h:h + 1].contiguous() for c in tk.ttt_linear_forward_plain(**a, eta_scale=ETA, checkpoint_group=K)[1:]]
    xk_raw = one["XK"][0, n, r].double().cpu()
    cos, sin = one["rope_cos"][n, r].double().cpu(), one["rope_sin"][n, r].double().cpu()
    vjp = lambda u: float(ln_ops.l2norm_vjp(xk_raw, ln_ops.rope_vjp(u, cos, sin))[f])
    out = {"seed": seed, "at": at, "kernel": kernel}
    traces = {}
    for where in ("cuda", "cpu"):
        dev = torch.device(where)
        trace = {}
        grads = tk.ttt_linear_backward_plain(*(one[k].to(dev) for k in INPUTS), *(c.to(dev) for c in ck),
                                             d_one.to(dev), ETA, K, trace=trace)
        t = {k: v[0, 0].double().cpu() for k, v in trace[n].items()}
        terms = {"-Gs dW^T": -(t["Gs"] @ t["dW"].T)[r], "dA1^T XQ": (t["dA1"].T @ t["XQ"])[r], "-dtv": -t["dtv"][r],
                 "dZ1 W^T": (t["dZ1"] @ t["W"].T)[r]}
        out[where] = {"value": float(grads[1][0, n, r, f]), "terms": {k: vjp(v) for k, v in terms.items()}}
        traces[where] = t
    diff = {k: out["cuda"]["terms"][k] - out["cpu"]["terms"][k] for k in out["cuda"]["terms"]}
    moved = max(diff, key=lambda k: abs(diff[k]))
    operands = {"-Gs dW^T": ("Gs", "dW"), "dA1^T XQ": ("dA1", "XQ"), "-dtv": (), "dZ1 W^T": ("dZ1", "W")}[moved]
    flips = {}
    for name in operands:
        x, y = traces["cuda"][name], traces["cpu"][name]
        flips[name] = {"mini_batch": int((x != y).sum()), "row": int((x[r] != y[r]).sum()) if x.shape[0] == CS else None}
    out.update(term_moved=moved, term_diffs=diff, flips=flips, carry_boundary=carry_boundary(traces["cuda"], r, vjp))
    if n < K:  # the kernel's own operands: its pass-A stash of the first group (the last one it runs) survives
        out["kernel_stash"] = kernel_stash(tk, one, ck, d_one, n, r, f, traces["cuda"], vjp)
    return out


def carry_boundary(t, r, vjp, top: int = 3) -> list:
    """The carry entries dW[k][c] whose bf16 rounding moves the element most: what one bf16 ulp of each does to
    the element through -Gs bf16(dW)^T and the VJPs, and how far its fp32 value lies from a rounding boundary,
    in ulps (0: on it)."""
    import torch

    dw32, dwb = t["dW32"], t["dW"]
    ulp = torch.exp2(torch.floor(torch.log2(dwb.abs().clamp_min(1e-30))) - 7)
    edge = ((dw32 - dwb).abs() - ulp / 2).abs() / ulp
    jac = torch.tensor([vjp(e) for e in torch.eye(F, dtype=torch.float64)], dtype=torch.float64)  # d element / d dXK[r][k]
    effect = -t["Gs"][r][None, :] * ulp * jac[:, None]  # [k][c]
    order = effect.abs().flatten().argsort(descending=True)[:top].tolist()
    return [{"k": i // F, "c": i % F, "ulp_effect": float(effect.flatten()[i]), "dW": float(dw32.flatten()[i]),
             "ulps_from_boundary": float(edge.flatten()[i])} for i in order]


def kernel_stash(tk, one, ck, d_one, n, r, f, t, vjp) -> dict:
    """Run K6 on the one head with workspaces of our own, and hold its pass-A stash of mini-batch n (< K) against
    the plain version's operands: Gs (bf16), bf16(W^T) and Z1 (fp32); and what the Gs that differ do to the
    element."""
    import torch

    device = one["XQ"].device
    lib = tk._lib("ttt_linear_backward")
    step = [lib.ttt_linear_backward_stash_bytes(part, CS) for part in (0, 1)]
    new = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device=device)
    dx = [torch.empty_like(one["XQ"]) for _ in range(3)]
    grads = (new(1, 1, F, F), new(1, 1, 1, F), new(1, 1, F), new(1, 1, F))
    sh, sf = new(K * step[0] // 2, dtype=torch.bfloat16), new(K * step[1] // 4)
    tk._launch(lib, "ttt_linear_backward", (*(one[k] for k in INPUTS), *ck, d_one, *dx, new(1, 1, NC, CS), *grads,
                                            sh, sf), (1, NC, 1, CS, K), ETA, device)
    torch.cuda.synchronize()
    ld_b, ld_z = F + 8, F + 4  # the stash's padded row pitches (csrc/ttt_linear_step.cuh)
    hs = sh[n * step[0] // 2:(n + 1) * step[0] // 2]
    fs = sf[n * step[1] // 4:(n + 1) * step[1] // 4]
    wt = hs[:F * ld_b].view(F, ld_b)[:, :F].double().cpu()
    gs = hs[(F + 2 * CS) * ld_b:(F + 3 * CS) * ld_b].view(CS, ld_b)[:, :F].double().cpu()
    z1 = fs[:CS * ld_z].view(CS, ld_z)[:, :F].double().cpu()
    bad = (gs != t["Gs"]).nonzero().tolist()
    in_row = [[c, float(gs[r, c]), float(t["Gs"][r, c])] for rr, c in bad if rr == r]
    # The element's -Gs dW^T term with the kernel's Gs against the plain's (the plain's dW in both).
    effect = vjp(-(gs @ t["dW"].T)[r]) - vjp(-(t["Gs"] @ t["dW"].T)[r])
    return {"value": float(dx[1][0, n, r, f]), "Gs_differ": len(bad), "Gs_differ_in_row": in_row,
            "Gs_effect_on_element": effect, "Wt_differ": int((wt != t["W"].T).sum()),
            "Z1_row_max_abs_diff": float((z1[r] - t["Z1"][r]).abs().max()), "Z1_row_max_abs": float(z1[r].abs().max())}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--tree", default=ROOT, help="the checkout whose kernel is checked (default: this one)")
    ap.add_argument("--parent", help="an unpacked checkout of another commit: its kernel first, then this tree's")
    ap.add_argument("--top", type=int, default=4, help="elements outside the tolerance listed per gradient")
    ap.add_argument("--explain", type=int, default=0, help="dXK elements outside the tolerance to explain")
    args = ap.parse_args()
    if not args.parent:
        measure(args.tree, args.seeds, args.top)
        return
    outliers = []  # this tree's first, then the parent's
    for tree in (args.parent, ROOT):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--tree", os.path.abspath(tree), "--top",
                               str(args.top), "--seeds", *map(str, args.seeds)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise SystemExit(f"run on {tree} failed:\n{proc.stdout}\n{proc.stderr}")
        for line in proc.stdout.strip().splitlines():
            rec = json.loads(line)
            print(json.dumps(rec), flush=True)
            found = [(rec["seed"], e["at"], e["kernel"]) for e in rec["dXK"]["first"]]
            outliers = outliers + found if tree == args.parent else found + outliers
    for seed, at, kernel in outliers[: args.explain]:
        print(json.dumps(explain(seed, at, kernel)), flush=True)


if __name__ == "__main__":
    main()
