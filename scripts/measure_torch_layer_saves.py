"""The bytes one transformer layer's training forward keeps for its
backward, per tensor rank, as a multiple of the bf16 stream U = L x D x 2
bytes: what a layer's recompute under remat policy "none" holds at once,
so what decides whether a layer fits a card.

Every tensor autograd saves during the forward is packed through
``saved_tensors_hooks``; each storage counts once, at its full size (a
view keeps its whole storage alive), attributed to the port's source line
that saved it. The layer runs on the CPU at a narrow width (d256, 4 heads
of 64, bf16) on the 9 s train TOML's geometry (3 scenes, 37 frames, 2,880
tokens at 6 x 6 latents); the ratio to U carries to full width, where
every saved tensor is a multiple of the stream but the TTT state
checkpoints, which scale with the heads, as D does. With ``--tp N`` the
model takes the tensor plan of N ranks on a fake process group (its
collectives move no data: only the sizes mean anything) and the numbers
are one rank's. ``--recompute on`` (the default) has the layer recompute
its elementwise chains (models/recompute.py) as it does where its saves
would bind a card, ``off`` as it does elsewhere.

    python scripts/measure_torch_layer_saves.py [--tp 4] [--recompute off]
    PYTHONPATH=OTHER_CHECKOUT python scripts/measure_torch_layer_saves.py   # another checkout's port
"""

from __future__ import annotations

import argparse
import collections
import traceback

import torch
import torch.distributed as dist
import torch.utils.checkpoint
from torch.testing._internal.distributed.fake_pg import FakeStore

from ttt_video_dit_torch import train
from ttt_video_dit_torch.models import recompute

FLAGS = ["--job.config_file", "configs/train/ttt-mlp/9s.toml", "--model.num_layers", "1", "--model.model_dim", "256",
         "--model.num_heads", "4", "--model.latent_height", "6", "--model.latent_width", "6", "--job.platform", "cpu",
         "--parallelism.tp_sharding", "1", "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1",
         "--remat.policy", "none", "--training.global_batch_size", "1"]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tp", type=int, default=1, help="tensor ranks (a fake process group)")
    ap.add_argument("--recompute", choices=("on", "off"), default="on",
                    help="the layer recomputes its elementwise chains (models/recompute.py)")
    args = ap.parse_args()
    recompute.binds = lambda x: args.recompute == "on"
    torch.set_num_threads(4)
    job = train.parse_args(FLAGS)
    cfg = train.model_config(job)
    model = train.build_model(cfg, torch.device("cpu"), 0)
    if args.tp > 1:
        from ttt_video_dit_torch.parallel.mesh import build_mesh
        from ttt_video_dit_torch.parallel.sharding import apply_tensor_parallel

        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=args.tp)
        apply_tensor_parallel(model, build_mesh(1, 1, args.tp, "cpu"))
    data, tl = train.build_data(job, cfg)
    stream = data.batches(1)
    host = next(stream)
    stream.close()
    L = cfg.num_chunks * tl + cfg.compressed_num_frames * cfg.tokens_per_frame
    U = L * cfg.model_dim * 2
    by_line, seen = collections.Counter(), set()

    def pack(t):
        ptr = t.untyped_storage().data_ptr()
        if ptr not in seen:
            seen.add(ptr)
            frames = traceback.extract_stack(limit=10)
            where = next((f"{f.filename.split('ttt_video_dit_torch/')[-1]}:{f.lineno}" for f in reversed(frames)
                          if "ttt_video_dit_torch" in f.filename), "?")
            by_line[where] += t.untyped_storage().nbytes()
        return t

    def layer_group(fn, *inputs, **kwargs):  # in place of the per-layer checkpoint: count what it would recompute
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            return fn(*inputs)

    torch.utils.checkpoint.checkpoint = layer_group
    bounds = (torch.zeros(1, dtype=torch.long), torch.full((1,), 1000, dtype=torch.long))
    model(torch.from_numpy(host["vid"]), torch.from_numpy(host["text"]), bounds, torch.Generator().manual_seed(0))
    print(f"tp {args.tp}, L {L}, d{cfg.model_dim}, {cfg.dtype}, recompute {args.recompute}: one layer keeps {sum(by_line.values()) / U:.2f} U "
          f"for its backward (U = L x D x 2 bytes)")
    for where, n in by_line.most_common():
        print(f"  {n / U:6.2f} U  {where}")
    if dist.is_initialized():
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
