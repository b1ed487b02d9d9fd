"""One rank's peak in the sampling or the training entry under a mesh of
``--world`` ranks, measured on one card.

The entry runs as rank 0 of a process group of ``--world`` ranks on torch's
``fake`` backend: its collectives move no data, so the values mean nothing
(a training run's losses come out non-finite), but every tensor the rank
allocates has a real rank's shape, so the peak
(``torch.cuda.max_memory_allocated``, as the entry reports it: the DiT
stage's in sampling, the run's in training) is what a rank of a real group
allocates, NCCL's own buffers aside. ``--world 1`` runs the entry as it is.
Smoke mode: random weights, random text embeddings or synthetic latents; a
storyboard of ``--scenes`` scenes for sampling. ``--recompute on|off``
forces the layers' recompute (models/recompute.py) on or off in every
layer.

    python scripts/measure_torch_rank_peak.py --world 2 --scenes 21 -- --job.config_file configs/eval/ttt-mlp/63s.toml \\
        --parallelism.tp_sharding 2 --model.num_layers 4 --eval.num_denoising_steps 2 --guider.num_steps 2
    python scripts/measure_torch_rank_peak.py --entry train --world 4 -- --job.config_file configs/train/ttt-mlp/63s.toml \\
        --parallelism.tp_sharding 4 --parallelism.dp_sharding 1 --parallelism.dp_replicate 1 --model.num_layers 2 \\
        --training.steps 2 --training.global_batch_size 1 --training.grad_accum_steps 1 --checkpoint.interval 0
    PYTHONPATH=OTHER_CHECKOUT python scripts/measure_torch_rank_peak.py ...   # another checkout's port

Prints one line: the card, the entry, the peak in GiB and, for sampling,
s/eval after the first (with a fake group, not a real rank's time).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--entry", choices=("sample", "train"), default="sample")
    ap.add_argument("--world", type=int, default=2, help="ranks of the mesh the flags describe (1: no group)")
    ap.add_argument("--scenes", type=int, default=1, help="scenes of the sampling storyboard")
    ap.add_argument("--recompute", choices=("default", "on", "off"), default="default",
                    help="force the layers' recompute on or off")
    ap.add_argument("--work", default="output/measure_torch_rank_peak", help="the storyboard and the entry's output")
    argv = sys.argv[1:]
    flags = argv[argv.index("--") + 1 :] if "--" in argv else []
    args = ap.parse_args(argv[: argv.index("--")] if "--" in argv else argv)

    import torch
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from ttt_video_dit_torch import sample, train

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    if args.recompute != "default":
        from ttt_video_dit_torch.models import recompute

        recompute.binds = lambda x: args.recompute == "on"
    if args.world > 1:  # the entry joins a group under torchrun: make it rank 0 of a fake one
        os.environ.update(WORLD_SIZE=str(args.world), RANK="0", LOCAL_RANK="0")
        dist.init_process_group = lambda *a, _init=dist.init_process_group, **k: _init(
            "fake", store=FakeStore(), rank=0, world_size=args.world)
    os.makedirs(args.work, exist_ok=True)
    what = ""
    if args.entry == "sample":
        board = os.path.join(args.work, f"storyboard_{args.scenes}.json")
        with open(board, "w", encoding="utf-8") as f:
            json.dump([[{"text": f"scene {i}", "neg_text": None} for i in range(args.scenes)]], f)
        s = sample.main(sample.parse_args(flags + ["--eval.input_file", board, "--eval.output_dir",
                                                   os.path.join(args.work, "out")]))
        evals = s["eval_seconds"][1:] or s["eval_seconds"]
        peak = s["peak_memory_bytes"]["dit"]
        what = f"{s['seq_len']} tokens, {s['model_config'].num_layers} layers, DiT stage"
        after = f", {sum(evals) / len(evals):.3f} s/eval after the first"
    else:
        try:
            s = train.main(train.parse_args(flags + ["--job.dump_folder", os.path.join(args.work, "out")]))
            what = f"{s['model_config'].num_layers} layers, the run"
        except FloatingPointError:  # the fake group's values
            what = "the run (losses not finite: a fake group's)"
        peak = torch.cuda.max_memory_allocated()
        after = ""
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(f"{card}; {args.entry}, world {args.world}{' (rank 0 of a fake group)' if args.world > 1 else ''}, "
          f"recompute {args.recompute}: {what}: peak {peak / 2**30:.2f} GiB{after}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
