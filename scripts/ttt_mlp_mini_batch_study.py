"""K1-train and K2 against their plain versions at the 5B TTT-MLP training slice of one mini-batch, and where
the elements outside chip_smoke.py's elementwise tolerance lie.

    python scripts/ttt_mlp_mini_batch_study.py [--cs 16] [--seeds 27] [--runs 3] [--check-only]

For each seed the inputs are drawn as chip_smoke.py draws the slice of
check_ttt_training (its ``_ttt_inputs``: B 1, 48 heads, NC = 18,048 / CS, the
3 s train TOML's rope tables at ``--model.mini_batch_size CS``, K 16). It
prints one JSON line per seed:

- ``reruns``: K1-train launched ``--runs`` times on the same inputs; the
  number of output and checkpoint elements whose bits differ from the first
  launch (a race shows here);
- ``k1_train``: the output against the plain scan: elements outside
  |kernel - plain| <= 2e-2 + 2e-2 |plain|, the largest error and ratio to the
  tolerance, and the largest ratio in each quarter of the scan (drift grows
  along it); the checkpoints' relative L2 error in each quarter of the
  groups;
- ``k1_train_per_group``: the kernel's output of every checkpoint group
  against the plain scan of that group alone from the kernel's own
  checkpoint: the same measures (a step that computes wrongly shows here,
  whatever state it starts from);
- ``k1``: the sampling kernel (K1 at CS 16 is its own kernel; past 16
  K1-train's with no checkpoints) on the same inputs against the same plain
  output;
- ``k2``: K2 from the plain checkpoints against the plain backward, for
  dXQ, dXK, dXV and d_gate, as above;
- ``group_check``: chip_smoke.py's long-scan check (check_scan_by_group: each
  checkpoint group's output elementwise against the plain scan of that group
  from the kernel's own checkpoint, the group's end state against the
  kernel's next checkpoint, and K2's dXQ, dXK, dXV and d_gate by each group's
  relative L2 error, both backwards from the kernel's checkpoints): whether
  it passes, its message if not, and its largest errors.

With ``--check-only`` a seed's line holds ``group_check`` alone.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
H, SEQ, K = 48, 18048, 16
INPUTS = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")
STATE = ("W1", "b1", "W2", "b2")


def outside(got, want, n_axis: int = 1, quarters: int = 4) -> dict:
    """Elements of ``got`` outside chip_smoke.py's elementwise tolerance of ``want``, the largest error, ratio to
    the tolerance and |want|, the relative L2 error, and the largest ratio in each quarter of the mini-batch
    axis ``n_axis``."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    ratio = err / (2e-2 + 2e-2 * want.abs())
    per_n = ratio.transpose(0, n_axis).reshape(ratio.shape[n_axis], -1).amax(dim=1)
    NC = per_n.numel()
    bad_n = (per_n > 1).nonzero().flatten().tolist()
    return {"outside": int((ratio > 1).sum()), "max_abs_err": float(err.max()), "max_tol_ratio": float(ratio.max()),
            "max_abs_plain": float(want.abs().max()), "rel_l2": float((got - want).norm() / want.norm()),
            "quarters_max_tol_ratio": [float(q.max()) for q in per_n.tensor_split(quarters)],
            "mini_batches_outside": len(bad_n), "first_outside": bad_n[:8], "of": NC}


def rel_l2_quarters(got, want, quarters: int = 4) -> list[float]:
    """Relative L2 error of checkpoints [B, H, NG, ...] in each quarter of the groups."""
    g, w = got.float().transpose(0, 2), want.float().transpose(0, 2)
    return [float((a - b).norm() / b.norm()) for a, b in zip(g.tensor_split(quarters), w.tensor_split(quarters))]


def group_check(chip_smoke, a, eta, dout) -> dict:
    """chip_smoke.check_scan_by_group on a draw: passed or not (and why), its largest errors."""
    try:
        r = chip_smoke.check_scan_by_group("ttt_mlp", a, K, eta, dout)
    except AssertionError as e:
        return {"passed": False, "error": str(e)}
    return {"passed": True, "out_max_abs_err": r["err"], "end_states": r["ck_errs"],
            "group_rel_l2": r["group_rel_l2"], "gradients_max_abs_err": r["gerr"]}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cs", type=int, default=16)
    ap.add_argument("--seeds", type=int, nargs="+", default=[27])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--check-only", action="store_true", help="run chip_smoke.py's long-scan check alone")
    args = ap.parse_args()
    os.chdir(ROOT)
    import torch

    import chip_smoke
    from ttt_video_dit_torch.ops import ttt_mlp_kernel as tm

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    device = torch.device("cuda", 0)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    CS = args.cs
    NC, eta = SEQ // CS, 0.1 / 64 / CS
    _, meta = chip_smoke._training_meta("ttt_mlp", extra=tuple(chip_smoke.mini_batch(CS)))
    for seed in args.seeds:
        gen = torch.Generator(device).manual_seed(seed)
        a = chip_smoke._ttt_inputs(1, H, NC, gen, device, meta, CS=CS)
        rec = {"card": card, "cs": CS, "nc": NC, "k": K, "seed": seed}
        if args.check_only:  # the draws of chip_smoke.py's slice: the inputs, then the output gradient
            dout = torch.randn(*a["XQ"].shape, generator=gen, device=device).bfloat16()
            rec["group_check"] = group_check(chip_smoke, a, eta, dout)
            print(json.dumps(rec), flush=True)
            del a, dout
            torch.cuda.empty_cache()
            continue
        got = tm.ttt_mlp_forward_train(**a, eta_scale=eta, checkpoint_group=K)
        differ = [0] * 5
        for _ in range(args.runs - 1):
            again = tm.ttt_mlp_forward_train(**a, eta_scale=eta, checkpoint_group=K)
            differ = [d + int((x.view(torch.int16 if x.dtype == torch.bfloat16 else torch.int32)
                               != y.view(torch.int16 if y.dtype == torch.bfloat16 else torch.int32)).sum())
                      for d, x, y in zip(differ, got, again)]
        rec["reruns"] = dict(zip(("out",) + tuple(f"{n}_ck" for n in STATE), differ))
        want = tm.ttt_mlp_forward_plain(**a, eta_scale=eta, checkpoint_group=K)
        rec["k1_train"] = outside(got[0], want[0])
        rec["k1_train"]["checkpoints_rel_l2_quarters"] = {n: rel_l2_quarters(g, w)
                                                          for n, g, w in zip(STATE, got[1:], want[1:])}
        NG = got[1].shape[2]
        per_group = []
        for g in range(NG):
            n0, n1 = g * K, min(NC, (g + 1) * K)
            part = {k: v for k, v in a.items() if k not in STATE}
            for k in ("XQ", "XK", "XV"):
                part[k] = a[k][:, n0:n1].contiguous()
            part["gate"] = a["gate"][:, :, n0:n1].contiguous()
            part["rope_cos"], part["rope_sin"] = a["rope_cos"][n0:n1], a["rope_sin"][n0:n1]
            state = {n: c[0, :, g] for n, c in zip(STATE, got[1:])}
            per_group.append(tm.ttt_mlp_forward_plain(**part, **state, eta_scale=eta))
        rec["k1_train_per_group"] = outside(got[0], torch.cat(per_group, dim=1))
        del per_group
        sampled = tm.ttt_mlp_forward(**a, eta_scale=eta)
        rec["k1"] = outside(sampled, want[0])
        rec["k1_train_vs_k1"] = outside(got[0], sampled)
        del got, sampled
        dout = torch.randn(*a["XQ"].shape, generator=gen, device=device).bfloat16()
        ins = [a[k] for k in INPUTS]
        gk = tm.ttt_mlp_backward(*ins, *want[1:], dout, eta, K)
        gp = tm.ttt_mlp_backward_plain(*ins, *want[1:], dout, eta, K)
        rec["k2"] = {n: outside(g, w, n_axis=2 if n == "d_gate" else 1)
                     for n, g, w in zip(("dXQ", "dXK", "dXV", "d_gate"), gk, gp)}
        del gk, gp
        rec["group_check"] = group_check(chip_smoke, a, eta, dout)
        print(json.dumps(rec), flush=True)
        del a, want, dout, ins
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
