"""One-card training steps of this tree against another checkout of the
port (``--parent DIR``, e.g. the parent commit unpacked with ``git
archive``), and with the layers' recompute (models/recompute.py) forced on
and off: the steps of chip_smoke.py's phases 6 (3 s), 11 (9 s) and 15
(30 s at 2 layers), through the training entry at full width.

    python scripts/compare_torch_train_steps.py --parent DIR [--out DIR] [--lengths 3s]

Each pass is a process of its own with its tree's package on PYTHONPATH and
the tree as its working directory, in the order parent, this tree, this
tree with the recompute on in every layer, this tree again, parent, and
last this tree with the recompute off in every layer at 30 s (where its
layers recompute by default). ``--lengths`` keeps the configurations of the
lengths it names and only the four passes with the default recompute. A
pass runs every configuration; one that
fails (out of memory) is reported with its error. Prints one line a pass
and configuration (s/step after the first, peak, losses), the card's name
and power limit, and a JSON summary as its last line (also written to
``--out``/summary.json).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

HERE = os.path.abspath(__file__)
ROOT = os.path.dirname(os.path.dirname(HERE))
KERNELS = ("attention_forward", "attention_backward", "ttt_mlp_forward", "ttt_mlp_backward", "ttt_linear_forward",
           "ttt_linear_backward", "convert")
# (variant, length, remat policy or None for the TOML's, layers, steps): phase 6, phase 11, phase 15.
CONFIGS = [("ttt_mlp", "3s", "save_seq", 4, 3), ("ttt_mlp", "3s", "none", 4, 3),
           ("ttt_linear", "3s", "save_seq", 4, 3), ("ttt_linear", "3s", "none", 4, 3),
           ("ttt_mlp", "9s", None, 4, 3), ("ttt_linear", "9s", None, 4, 3), ("ttt_mlp", "30s", None, 2, 2)]
# (pass, tree, recompute: "default", "on" or "off", the configurations' lengths or None for all).
PASSES = [("parent", "parent", "default", None), ("this", "this", "default", None),
          ("this, recompute on", "this", "on", ("3s", "9s")), ("this", "this", "default", None),
          ("parent", "parent", "default", None), ("this, recompute off", "this", "off", ("30s",))]


def config_flags(config, work: str) -> list[str]:
    """The training entry's flags for one configuration, as chip_smoke.py's phase_train gives them."""
    sys.path.insert(0, ROOT)  # the launcher's: chip_smoke.py at the root
    import chip_smoke

    variant, length, policy, layers, steps = config
    os.chdir(ROOT)  # train_toml writes its one-card copies under output/
    flags = chip_smoke.train_args(variant, length, layers, steps)
    flags[flags.index("--job.config_file") + 1] = os.path.join(ROOT, flags[flags.index("--job.config_file") + 1])
    return flags + ["--checkpoint.interval", "0", "--job.dump_folder", os.path.join(work, "dump")] + (
        ["--remat.policy", policy] if policy else [])


def worker(out: str, recompute: str, configs: list) -> None:
    """Every configuration in this process: s/step after the first, peak, losses, or the error."""
    import torch

    from ttt_video_dit_torch import train

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if recompute != "default":
        from ttt_video_dit_torch.models import recompute as rc

        rc.binds = lambda x: recompute == "on"
    results = []
    for name, flags in configs:
        torch.cuda.empty_cache()
        try:
            s = train.main(train.parse_args(flags))
            steady = s["step_seconds"][1:]
            results.append({"config": name, "s_per_step": sum(steady) / len(steady),
                            "peak_gib": s["peak_memory_bytes"] / 2**30, "losses": s["losses"]})
            del s
        except Exception as e:  # noqa: BLE001  (out of memory, or a configuration the tree cannot run)
            results.append({"config": name, "error": f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"})
    with open(out, "w", encoding="utf-8") as f:
        json.dump(results, f)


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def prebuild(tree: str) -> float:
    t0 = time.perf_counter()
    code = ("from concurrent.futures import ThreadPoolExecutor; from ttt_video_dit_torch.ops import _build; "
            f"list(ThreadPoolExecutor({len(KERNELS)}).map(_build.load, {KERNELS!r}))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tree, env={**os.environ, "PYTHONPATH": tree},
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"the kernels of {tree} did not build: {proc.stderr[-2000:]}")
    return time.perf_counter() - t0


def launcher(args) -> int:
    out, work = os.path.abspath(args.out), os.path.abspath(args.work)
    os.makedirs(out, exist_ok=True)
    os.makedirs(work, exist_ok=True)
    trees = {"this": ROOT, "parent": os.path.abspath(args.parent)}
    with ThreadPoolExecutor(2) as pool:  # both trees' nvcc at once
        for tree, seconds in zip(trees, pool.map(prebuild, trees.values())):
            print(f"built the kernels of {tree} in {seconds:.1f} s", flush=True)
    summary = {"card": card(), "passes": []}
    print(summary["card"], flush=True)
    only = args.lengths.split(",") if args.lengths else None
    for i, (name, tree, recompute, lengths) in enumerate(PASSES):
        if only and recompute != "default":
            continue
        configs = [(f"{v} {ln} {p or 'TOML policy'} {k} layers", config_flags((v, ln, p, k, s), work))
                   for v, ln, p, k, s in CONFIGS if (lengths is None or ln in lengths) and (not only or ln in only)]
        result = os.path.join(work, f"pass_{i}.json")
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, HERE, "--worker", result, "--recompute", recompute, "--configs",
                               json.dumps(configs)], cwd=trees[tree], env={**os.environ, "PYTHONPATH": trees[tree]},
                              capture_output=True, text=True, timeout=args.timeout)
        with open(os.path.join(out, f"log_pass_{i}.txt"), "w", encoding="utf-8") as f:
            f.write(proc.stdout + "\n--- stderr ---\n" + proc.stderr)
        if proc.returncode:
            raise RuntimeError(f"pass {i} ({name}) exited {proc.returncode}: {proc.stderr[-2000:]}")
        with open(result, encoding="utf-8") as f:
            runs = json.load(f)
        summary["passes"].append({"pass": name, "seconds": time.perf_counter() - t0, "runs": runs})
        for r in runs:
            what = r["error"] if "error" in r else (f"{r['s_per_step']:.4f} s/step after the first, peak "
                                                    f"{r['peak_gib']:.2f} GiB, losses {r['losses']}")
            print(f"pass {i} ({name}): {r['config']}: {what}", flush=True)
    with open(os.path.join(out, "summary.json"), "w", encoding="utf-8") as f:
        json.dump(summary, f, indent=1)
    print(summary["card"])
    print(json.dumps(summary))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", help="an unpacked checkout of another commit")
    ap.add_argument("--out", default=os.path.join(ROOT, "output", "train_steps"), help="the summary and logs")
    ap.add_argument("--work", default=os.path.join(ROOT, "output", "compare_torch_train_steps"),
                    help="the passes' files")
    ap.add_argument("--timeout", type=int, default=600, help="seconds a pass may take")
    ap.add_argument("--lengths", help="only these lengths (e.g. 3s or 3s,9s), in the default-recompute passes")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    ap.add_argument("--recompute", default="default", help=argparse.SUPPRESS)
    ap.add_argument("--configs", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(args.worker, args.recompute, json.loads(args.configs))
        return 0
    import torch

    if not torch.cuda.is_available() or not args.parent:
        print("needs a CUDA device and --parent", file=sys.stderr)
        return 2
    return launcher(args)


if __name__ == "__main__":
    sys.exit(main())
