"""Sequence parallelism on 2 and 4 cards: the 30 s and 63 s TOMLs through the
port's entries under torchrun, against one card and against another
checkout of the port (``--parent DIR``, e.g. the parent commit unpacked
with ``git archive``).

    python scripts/check_torch_sequence_parallel.py [--parent DIR] [--depths 2,4] [--out DIR]
    python scripts/check_torch_sequence_parallel.py --device cpu      # gloo ranks, a tiny model

The script is a launcher: it starts every run itself (``python -m
torch.distributed.run --standalone``, or one process for one card), each a
worker of this file with the tree's package on PYTHONPATH and the tree as
its working directory, so the parent's runs are the parent's code. Each
rank writes its summary to a JSON file; the launcher reads them.

Runs, at ``--depth`` layers (the sampling runs at ``--eval-depth``; the
63 s TTT-MLP step at tp 4 also at each of ``--depths``: the depth series),
2 training steps or 2 denoise steps, synthetic latents and seeded text (the
sampling entry's smoke mode), every line of the TOML but the mesh sizes, the
depth and the global batch, which the cards force (micro-batch 1 on every
data rank):

- train, ttt-mlp 18 s and 30 s: fsdp 2 x tp 2 (30 s: its TOML's tp; 18 s,
  whose TOML has none, the point where the parent still fits), global batch 2;
- train, ttt-mlp 63 s: tp 4 (its TOML's), global batch 1, and tp 2 on two
  cards as its reference;
- train, ttt-linear 30 s and 63 s: fsdp 2 x tp 2 (their TOMLs' tp), global batch 2;
- sample, ttt-mlp 30 s and 63 s eval TOMLs: tp 2 (theirs) on two cards.

One card runs the configurations whose layer fits it as the reference: the
TOML with ``shard_transformer_inputs = false`` and ``tp_sharding = 1`` (the
JAX package refuses the flag without a tensor axis), the same global batch
in ``--training.grad_accum_steps`` micro-batches, and the sigma bounds
stratified over the same count of data ranks; four at a time, one a card. A
63 s training layer does not fit one card (its backward keeps ~43 times the
bf16 stream, scripts/measure_torch_layer_saves.py), so the tp-4 step is
held to the tp-2 step and the ttt-linear 63 s step only to finite losses. Gates: every step's loss within
LOSS_RTOL of the reference's, the latents within LATENT_REL_L2 (relative
L2) of one card's (the port's bf16 gates: chip_smoke.py's
GRAD_REL_L2_TOL["loss"] and DIT_REL_L2_TOL). With ``--parent`` each
multi-card run but the tp-2 reference and the deeper steps of the series
runs again from DIR, right after this tree's, and the per-rank peak and
s/step (s/eval) stand side by side.

With ``--float32-reference`` each sampling run's one-card reference runs
once more in float32, and each run's latents are reported by their distance
from those too, not gated: a diagnostic of how far bf16 alone moves them.

Prints one line a run, the card's name and power limit, and a JSON summary
as its last line (also written to ``--out``/summary.json); exits 1 when a
gate fails or a run fails.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
LOSS_RTOL = 1e-2
LATENT_REL_L2 = 2e-2
KERNELS = ("attention_forward", "attention_backward", "ttt_mlp_forward", "ttt_mlp_backward", "ttt_linear_forward",
           "ttt_linear_backward", "convert")
# The tiny model of --device cpu: d128, 8 heads, 2 x 2 latents; the 30 s and 63 s geometries stay the TOMLs'.
TINY = ["--model.model_dim", "128", "--model.num_heads", "8", "--model.latent_height", "2", "--model.latent_width", "2",
        "--model.mini_batch_size", "8", "--remat.scan_checkpoint_group_size", "4", "--job.platform", "cpu"]
# 2 x 2 tokens a frame; text lengths that keep L a multiple of the eval TOMLs' CS 16 (30 s: 10 x 6 + 121 x 4 = 544,
# 63 s: 21 x 12 + 253 x 4 = 1,264).
TINY_EVAL = ["--model.model_dim", "128", "--model.num_heads", "8", "--model.latent_height", "2",
             "--model.latent_width", "2", "--eval.image_height", "32", "--eval.image_width", "32", "--job.platform", "cpu"]
TINY_TEXT = {"30s": "6", "63s": "12"}
FLOAT32 = ("--parallelism.fsdp_unsharded_dtype", "float32")  # the compute dtype of --float32-reference's runs


# ----------------------------------------------------------------- the runs


def configurations(args) -> list[dict]:
    """Every multi-card run: name, entry, TOML, mesh (replica, fsdp, tensor), depth, global batch, its reference
    ("one card", the name of another run, or None) and whether the parent runs it too."""
    mlp, lin, ev = "configs/train/ttt-mlp", "configs/train/ttt-linear", "configs/eval/ttt-mlp"
    d = args.depth
    runs = [dict(name="train ttt-mlp 18s fsdp2 x tp2", entry="train", toml=f"{mlp}/18s.toml", mesh=(1, 2, 2), depth=d,
                 batch=2, ref="one card"),
            dict(name="train ttt-mlp 30s fsdp2 x tp2", entry="train", toml=f"{mlp}/30s.toml", mesh=(1, 2, 2), depth=d,
                 batch=2, ref="one card"),
            dict(name=f"train ttt-mlp 63s tp2 depth {d}", entry="train", toml=f"{mlp}/63s.toml", mesh=(1, 1, 2),
                 depth=d, batch=1, ref=None, parent=False)]
    runs += [dict(name=f"train ttt-mlp 63s tp4 depth {k}", entry="train", toml=f"{mlp}/63s.toml", mesh=(1, 1, 4),
                  depth=k, batch=1, ref=f"train ttt-mlp 63s tp2 depth {d}" if k == d else None, parent=k == d,
                  series=True) for k in args.depths]
    runs += [dict(name="train ttt-linear 30s fsdp2 x tp2", entry="train", toml=f"{lin}/30s.toml", mesh=(1, 2, 2),
                  depth=d, batch=2, ref="one card"),
             dict(name="train ttt-linear 63s fsdp2 x tp2", entry="train", toml=f"{lin}/63s.toml", mesh=(1, 2, 2),
                  depth=d, batch=2, ref=None)]
    runs += [dict(name=f"sample ttt-mlp {t} tp2", entry="sample", toml=f"{ev}/{t}.toml", mesh=(1, 1, 2),
                  depth=args.eval_depth, batch=1, ref="one card") for t in ("30s", "63s")]
    for r in runs:
        r["cards"] = r["mesh"][0] * r["mesh"][1] * r["mesh"][2]
        r.setdefault("parent", True)
    return [r for r in runs if not args.only or any(o in r["name"] for o in args.only.split(","))]


def entry_flags(run: dict, args, one_card: bool) -> list[str]:
    """The entry's flags for ``run``, at its mesh or (``one_card``) at world 1."""
    rep, fsdp, tp = run["mesh"]
    if ROOT not in sys.path:  # the launcher's: chip_smoke.py at the root (a worker takes its tree's package)
        sys.path.append(ROOT)
    from chip_smoke import one_card_toml

    toml = os.path.join(ROOT, one_card_toml(run["toml"], args.work) if one_card else run["toml"])
    flags = ["--job.config_file", toml, "--model.num_layers", str(run["depth"]), "--job.seed", "0"]
    if run["entry"] == "train":
        flags += ["--training.steps", "2", "--training.global_batch_size", str(run["batch"]),
                  "--checkpoint.interval", "0"]
        if one_card:
            flags += ["--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1",
                      "--training.grad_accum_steps", str(rep * fsdp)]
        else:
            flags += ["--parallelism.dp_replicate", str(rep), "--parallelism.dp_sharding", str(fsdp),
                      "--parallelism.tp_sharding", str(tp), "--training.grad_accum_steps", "1"]
        return flags + (TINY if args.device == "cpu" else [])
    flags += ["--eval.num_denoising_steps", "2", "--guider.num_steps", "2", "--eval.input_file",
              os.path.join(args.work, f"storyboard_{run['toml'].split('/')[-1][:-5]}.json")]
    if not one_card:
        flags += ["--parallelism.tp_sharding", str(tp)]
    length = run["toml"].split("/")[-1][:-5]
    return flags + (TINY_EVAL + ["--eval.txt_maxlen", TINY_TEXT[length]] if args.device == "cpu" else [])


def storyboards(out: str) -> None:
    """One storyboard per eval TOML, a scene per 12 latent frames (30 s: 10, 63 s: 21)."""
    for name, scenes in (("30s", 10), ("63s", 21)):
        with open(os.path.join(out, f"storyboard_{name}.json"), "w", encoding="utf-8") as f:
            json.dump([[{"text": f"scene {i}", "neg_text": None} for i in range(scenes)]], f)


def launch(tree: str, run: dict, args, one_card: bool, tag: str, gpu: int | None = None, extra=()) -> dict:
    """One run from ``tree``, with ``extra`` flags: its ranks' summaries (rank 0's first), or {"error": ...}."""
    result = os.path.join(args.work, f"result_{tag}")
    for old in glob.glob(f"{result}-*.json"):
        os.remove(old)
    worker = [HERE, "--worker", result, "--data-ranks", str(run["mesh"][0] * run["mesh"][1]), "--entry", run["entry"],
              "--", *entry_flags(run, args, one_card), *extra,
              "--job.dump_folder" if run["entry"] == "train" else "--eval.output_dir", os.path.join(args.work, tag)]
    env = {**os.environ, "PYTHONPATH": tree, "OMP_NUM_THREADS": "1" if args.device == "cpu" else "4"}
    if gpu is not None:
        env["CUDA_VISIBLE_DEVICES"] = str(gpu)
    if one_card:
        cmd = [sys.executable, *worker]
    else:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(run["cards"]),
               *worker]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, cwd=tree, env=env, capture_output=True, text=True, timeout=args.timeout)
    with open(os.path.join(args.out, f"log_{tag}.txt"), "w", encoding="utf-8") as f:
        f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
    if proc.returncode:  # the workers' exceptions, not torchrun's summary
        why = [ln for ln in proc.stderr.splitlines() if "Error" in ln and not ln.startswith(" ")][-3:]
        return {"error": f"exit {proc.returncode}: {' | '.join(why) or proc.stderr[-800:]}",
                "seconds": time.perf_counter() - t0}
    ranks = []
    for rank in range(1 if one_card else run["cards"]):
        with open(f"{result}-{rank}.json", encoding="utf-8") as f:
            ranks.append(json.load(f))
    return {"ranks": ranks, "seconds": time.perf_counter() - t0, "stdout": proc.stdout}


def prebuild(tree: str) -> float:
    """Build the kernels in ``tree`` (one nvcc a source, all at once) before its ranks start."""
    t0 = time.perf_counter()
    code = ("from concurrent.futures import ThreadPoolExecutor; from ttt_video_dit_torch.ops import _build; "
            f"list(ThreadPoolExecutor({len(KERNELS)}).map(_build.load, {KERNELS!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env={**os.environ, "PYTHONPATH": tree},
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"the kernels of {tree} did not build: {proc.stderr[-2000:]}")
    return time.perf_counter() - t0


# ----------------------------------------------------------------- summaries


def mean_after_first(xs: list) -> float:
    return float(np.mean(xs[1:] if len(xs) > 1 else xs))


def digest(run: dict, res: dict) -> dict:
    """The numbers a run reports: per step losses, s/step (or s/eval) after the first, per-rank peaks in GiB."""
    if "error" in res:
        return {"error": res["error"]}
    r0 = res["ranks"][0]
    peaks = [r["peak_gib"] for r in res["ranks"]]
    out = {"peak_gib": max(peaks) if None not in peaks else None, "rank_peaks_gib": peaks, "wall_s": res["seconds"]}
    if run["entry"] == "train":
        out.update(losses=r0["losses"], grad_norms=r0["grad_norms"], s_per_step=mean_after_first(r0["step_seconds"]),
                   sequence_parallel=[ln for ln in res["stdout"].splitlines() if "token-sharded" in ln][:1])
    else:
        out.update(s_per_eval=mean_after_first(r0["eval_seconds"]), latents=r0["latents"])
    return out


def gate(run: dict, got: dict, ref: dict) -> tuple[bool, str]:
    """Loss (train) or latents (sample) of a multi-card run against one card's."""
    if "error" in got or "error" in ref:
        return False, "a run failed"
    if run["entry"] == "train":
        rel = max(abs(a - b) / abs(b) for a, b in zip(got["losses"], ref["losses"]))
        return bool(rel <= LOSS_RTOL), f"loss rel {rel:.3g} (tol {LOSS_RTOL})"
    a, b = np.load(got["latents"]), np.load(ref["latents"])
    rel = float(np.linalg.norm(a - b) / np.linalg.norm(b))
    return bool(a.shape == b.shape and np.isfinite(a).all() and rel <= LATENT_REL_L2), \
        f"latents rel L2 {rel:.3g} (tol {LATENT_REL_L2})"


def rel_l2(got: dict, ref: dict) -> str:
    """The relative L2 distance of two runs' latents, or why there is none."""
    if "error" in got or "error" in ref:
        return "not measured (a run failed)"
    a, b = np.load(got["latents"]), np.load(ref["latents"])
    return f"{float(np.linalg.norm(a - b) / np.linalg.norm(b)):.3g}"


def card() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError):
        return "no nvidia-smi (CPU run)"


def launcher(args) -> int:
    args.out, args.work = os.path.abspath(args.out), os.path.abspath(args.work)
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.work, exist_ok=True)
    storyboards(args.work)
    runs = configurations(args)
    trees = [("this tree", ROOT)] + ([("parent", os.path.abspath(args.parent))] if args.parent else [])
    if args.device == "cuda":
        for name, tree in trees:
            print(f"built the kernels of {name} in {prebuild(tree):.1f} s", flush=True)
    summary = {"card": card(), "runs": []}
    print(summary["card"], flush=True)

    # One card, the reference of the runs whose layer fits one card, four at a time, one a card.
    refs = [r for r in runs if r["ref"] == "one card"]
    slots = 1 if args.device == "cpu" else args.cards
    with ThreadPoolExecutor(slots) as pool:
        futures = [pool.submit(launch, ROOT, r, args, True, f"one_{i}", None if args.device == "cpu" else i % slots)
                   for i, r in enumerate(refs)]
        f32 = [r for r in refs if args.float32_reference and r["entry"] == "sample"]
        futures32 = [pool.submit(launch, ROOT, r, args, True, f"f32_{i}",
                                 None if args.device == "cpu" else (len(refs) + i) % slots, FLOAT32)
                     for i, r in enumerate(f32)]
        one = {r["name"]: digest(r, f.result()) for r, f in zip(refs, futures)}
        one32 = {r["name"]: digest(r, f.result()) for r, f in zip(f32, futures32)}
    ok, done = True, {}
    for i, run in enumerate(runs):
        entry = {"name": run["name"], "cards": run["cards"], "mesh": run["mesh"], "depth": run["depth"]}
        for side, tree in trees:
            if side == "this tree" or run["parent"]:
                entry[side] = digest(run, launch(tree, run, args, False, f"{side.split()[0]}_{i}"))
        ref = one.get(run["name"]) if run["ref"] == "one card" else done.get(run["ref"])
        if ref is not None:
            passed, what = gate(run, entry["this tree"], ref)
            if "parent" in entry:
                what += f"; the parent: {gate(run, entry['parent'], ref)[1]}"
            if run["name"] in one32:
                entry["float32 reference"] = ref32 = one32[run["name"]]
                what += "; from the float32 one-card latents: " + ", ".join(
                    f"{side} {rel_l2(entry[side], ref32)}" for side in ("this tree", "parent") if side in entry)
                what += f", one card (bf16) {rel_l2(ref, ref32)}"
            entry["reference"] = {"run": run["ref"], **ref}
        else:
            passed = "error" not in entry["this tree"] and all(map(np.isfinite, entry["this tree"].get("losses", [0])))
            what = ("depth series: finite losses" if run.get("series") else
                    "finite losses (no reference: one layer does not fit one card)")
        entry.update(passed=bool(passed), gate=what)
        done[run["name"]] = entry["this tree"]
        ok &= entry["passed"] and "error" not in entry["this tree"]
        summary["runs"].append(entry)
        print(line(entry, run), flush=True)
    summary["depth_series"] = depth_series(summary["runs"], args)
    for side, s in summary["depth_series"].items():
        print(f"depth series, {side}: {s}", flush=True)
    summary["ok"] = bool(ok)
    with open(os.path.join(args.out, "summary.json"), "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=1)
    print(summary["card"])
    print(json.dumps(summary))
    return 0 if ok else 1


def line(entry: dict, run: dict) -> str:
    parts = [f"{entry['name']} ({entry['cards']} cards, depth {entry['depth']}): {entry['gate']}, "
             f"{'PASS' if entry['passed'] else 'FAIL'}"]
    key = "s_per_step" if run["entry"] == "train" else "s_per_eval"
    for side in ("this tree", "parent", "reference", "float32 reference"):
        d = entry.get(side)
        if d is None:
            continue
        if "error" in d:
            parts.append(f"{side}: ERROR {d['error'][-300:]}")
            continue
        extra = f", losses {d['losses']}" if "losses" in d else ""
        peak = "not measured" if d["peak_gib"] is None else f"{d['peak_gib']:.2f} GiB"
        parts.append(f"{side}: {d[key]:.3f} {key.replace('_per_', '/')}, peak {peak}{extra}")
    return "; ".join(parts)


def depth_series(entries: list, args) -> dict:
    """Per tree: the 63 s tp-4 step's peak at each depth, the slope per layer, and the depth that would reach the
    card's memory on that slope (``--card-gib``)."""
    out = {}
    series = [e for e in entries if "63s tp4 depth" in e["name"]]
    for side in ("this tree", "parent"):
        pts = [(e["depth"], e[side]["peak_gib"]) for e in series if side in e and e[side].get("peak_gib")]
        if len(pts) < 2:
            continue
        (d0, p0), (d1, p1) = pts[0], pts[-1]
        slope = (p1 - p0) / (d1 - d0)
        out[side] = {"peaks_gib": pts, "slope_gib_per_layer": slope,
                     "deepest_on_the_slope": int(d0 + (args.card_gib - p0) // slope) if slope > 0 else None,
                     "s_per_step": [(e["depth"], e[side].get("s_per_step")) for e in series if side in e]}
    return out


# ------------------------------------------------------------------- worker


def worker(args, flags: list) -> None:
    """One entry run (under torchrun: this rank's); writes this rank's summary to ``<result>-<rank>.json``."""
    import torch

    from ttt_video_dit_torch.models.dit import schedule

    if args.data_ranks > 1 and "WORLD_SIZE" not in os.environ:  # one card: the multi-card run's sigma strata
        create, bounds = schedule.StratifiedSigmaBuckets.create.__func__, schedule.StratifiedSigmaBuckets.sample_bounds
        schedule.StratifiedSigmaBuckets.create = classmethod(lambda cls, s, _n: create(cls, s, args.data_ranks))
        schedule.StratifiedSigmaBuckets.sample_bounds = lambda self, g, _n: bounds(self, g, args.data_ranks)
    rank = int(os.environ.get("RANK", "0"))
    if args.entry == "train":
        from ttt_video_dit_torch import train

        s = train.main(train.parse_args(flags))
        peak = s["peak_memory_bytes"]
        out = {"losses": s["losses"], "grad_norms": s["grad_norms"], "step_seconds": s["step_seconds"]}
    else:
        from ttt_video_dit_torch import sample

        s = sample.main(sample.parse_args(flags))
        peak = s["peak_memory_bytes"].get("dit")
        latents = s["latents"][0] if s["latents"] else None
        if latents:
            kept = f"{args.worker}-latents.npy"
            shutil.copy(latents, kept)
            latents = kept
        out = {"eval_seconds": s["eval_seconds"], "latents": latents}
    out["peak_gib"] = None if peak is None or not torch.cuda.is_available() else peak / 2**30
    with open(f"{args.worker}-{rank}.json", "w", encoding="utf-8") as f:
        json.dump(out, f)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of another commit, run beside this tree")
    ap.add_argument("--depth", type=int, default=2, help="layers of every run but the depth series")
    ap.add_argument("--depths", default="2,4,8", help="the 63 s TTT-MLP tp-4 depth series (its first: --depth)")
    ap.add_argument("--eval-depth", type=int, default=4, help="layers of the sampling runs")
    ap.add_argument("--cards", type=int, default=4)
    ap.add_argument("--card-gib", type=float, default=79.19, help="the card's memory for the depth extrapolation")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--out", default=os.path.join(ROOT, "output", "sequence_parallel"),
                    help="the summary and each run's log")
    ap.add_argument("--work", default=os.path.join(ROOT, "output", "check_torch_sequence_parallel"),
                    help="the runs' files: TOML copies, storyboards, dumps, latents")
    ap.add_argument("--timeout", type=int, default=600, help="seconds a run may take")
    ap.add_argument("--only", help="comma-separated parts of the names of the runs to make (default: all)")
    ap.add_argument("--float32-reference", action="store_true",
                    help="also run each sampling reference in float32 and report every run's latents' distance from "
                         "it (a diagnostic; not gated)")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--data-ranks", type=int, default=1, help=argparse.SUPPRESS)
    ap.add_argument("--entry", help=argparse.SUPPRESS)
    argv = sys.argv[1:]
    flags = argv[argv.index("--") + 1 :] if "--" in argv else []
    args = ap.parse_args(argv[: argv.index("--")] if "--" in argv else argv)
    args.depths = [int(d) for d in args.depths.split(",")]
    if args.worker:
        worker(args, flags)
        return 0
    if args.device == "cuda":
        import torch

        if not torch.cuda.is_available() or torch.cuda.device_count() < args.cards:
            print(f"needs {args.cards} CUDA devices", file=sys.stderr)
            return 2
    return launcher(args)


if __name__ == "__main__":
    sys.exit(main())
