"""The VAE split over H across the ranks of a torchrun group, against one device.

Every rank builds the CogVideoX VAE 1.0 (encoder and decoder at the
published widths, PyTorch's default initialisation from seed 19 on the
CPU, so every rank holds the same weights), seeded uint8 frames
[--frames, --height, --width, 3] and seeded latents [(frames - 1) / 4 + 1,
16, height / 8, width / 8]. It encodes the frames (the unregularized
posterior, as ``precompute_video`` does) and decodes the latents (as the
sampling entry does) with ``VideoAutoencoder(group=WORLD)``, twice each,
timing every call and its peak memory per rank. Then rank 0 runs the same
two calls on one device with ``group=None`` and holds the split outputs to
them within the VAE tolerances of ``chip_smoke.py`` (1e-4 relative L2, 1e-3
of the largest value at most). With ``--long-decode N`` the split then
decodes N seeded latent frames once more (253 for a 63 s video), timed, with
no one-device run beside it. NCCL on ``cuda:LOCAL_RANK``; gloo with
``--device cpu``.

    torchrun --standalone --nproc_per_node 4 scripts/check_torch_vae_split.py [--long-decode 253]
    torchrun --standalone --nproc_per_node 4 scripts/check_torch_vae_split.py --device cpu --height 64 --width 96

Prints, on rank 0, one line per call, the card's name and power limit, and a
JSON summary as the last line; exits 1 when the split disagrees.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ttt_video_dit_torch.config.model_config import VaeModelConfig  # noqa: E402
from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder  # noqa: E402
from ttt_video_dit_torch.parallel import mesh as pmesh  # noqa: E402

REL_L2_TOL, MAX_TOL = 1e-4, 1e-3


def timed(device, fn):
    """(output on the host, seconds, peak GiB on this rank)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    out = fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(device) / 2**30 if device.type == "cuda" else None  # not measured
    return out.cpu().numpy(), seconds, peak


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--frames", type=int, default=49)
    parser.add_argument("--height", type=int, default=480)
    parser.add_argument("--width", type=int, default=720)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--long-decode", type=int, default=0, help="latent frames of one more split decode")
    args = parser.parse_args(argv)
    device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))) if args.device == "cuda" else \
        torch.device("cpu")
    if not pmesh.init_distributed(device):
        raise SystemExit("run under torchrun")
    rank, world = dist.get_rank(), dist.get_world_size()
    card = "cpu"
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    torch.manual_seed(19)
    split = VideoAutoencoder(VaeModelConfig.get_encoder_config(), VaeModelConfig.get_decoder_config(),
                             group=dist.group.WORLD).eval()
    weights = {k: v.clone() for k, v in split.state_dict().items()}
    split.to(device)
    gen = torch.Generator().manual_seed(20)
    frames = torch.randint(0, 256, (args.frames, args.height, args.width, 3), generator=gen, dtype=torch.uint8)
    x = (frames.float() / 255.0 * 2.0 - 1.0).permute(3, 0, 1, 2)[None]  # [1, 3, T, H, W]
    z = torch.randn(1, 16, (args.frames - 1) // 4 + 1, args.height // 8, args.width // 8, generator=gen)
    calls = {"encode": lambda vae: vae.encode_first_stage(x.to(device), unregularized=True),
             "decode": lambda vae: vae.decode_first_stage(z.to(device))}
    got, rows = {}, []
    for name, call in calls.items():
        for i in range(2):
            out, seconds, peak = timed(device, lambda: call(split))
            got[name] = out
            per_rank = [None] * world
            dist.all_gather_object(per_rank, (seconds, peak))
            rows.append({"call": name, "run": i, "world": world, "seconds": [s for s, _ in per_rank],
                         "peak_gib": [p for _, p in per_rank]})
            if rank == 0:
                print(f"split over {world} ranks, {name} {list(out.shape)} run {i}: "
                      f"{max(s for s, _ in per_rank):.3f} s (slowest rank), peak GiB by rank "
                      f"{[p if p is None else round(p, 2) for _, p in per_rank]} ({card})", flush=True)
    ok = True
    if rank == 0:
        split.cpu()
        one = VideoAutoencoder(VaeModelConfig.get_encoder_config(), VaeModelConfig.get_decoder_config()).eval()
        one.load_state_dict(weights)
        one.to(device)
        for name, call in calls.items():
            for i in range(2):
                want, seconds, peak = timed(device, lambda: call(one))
                rows.append({"call": name, "run": i, "world": 1, "seconds": [seconds], "peak_gib": [peak]})
                print(f"one device, {name} {list(want.shape)} run {i}: {seconds:.3f} s, peak "
                      f"{'not measured' if peak is None else f'{peak:.2f} GiB'} ({card})", flush=True)
            a = got[name]
            rel = float(np.linalg.norm(a - want) / np.linalg.norm(want))
            err, scale = float(np.abs(a - want).max()), float(np.abs(want).max())
            good = a.shape == want.shape and rel <= REL_L2_TOL and err <= MAX_TOL * scale
            ok &= good
            rows.append({"call": name, "rel_l2": rel, "max_abs_err": err, "max_abs": scale, "ok": good})
            print(f"{name}: split over {world} vs one device: relative L2 {rel:.4g} (tol {REL_L2_TOL}), max_abs_err "
                  f"{err:.4g} (tol {MAX_TOL} x {scale:.4g}) {'ok' if good else 'DISAGREES'}", flush=True)
    flag = [ok]
    dist.broadcast_object_list(flag, src=0)
    if flag[0] and args.long_decode:
        z = torch.randn(1, 16, args.long_decode, args.height // 8, args.width // 8, generator=gen)
        out, seconds, peak = timed(device, lambda: split.to(device).decode_first_stage(z.to(device)))
        per_rank = [None] * world
        dist.all_gather_object(per_rank, (seconds, peak))
        rows.append({"call": "long decode", "run": 0, "world": world, "seconds": [s for s, _ in per_rank],
                     "peak_gib": [p for _, p in per_rank], "finite": bool(np.isfinite(out).all())})
        if rank == 0:
            print(f"split over {world} ranks, decode {list(z.shape)} -> {list(out.shape)}: "
                  f"{max(s for s, _ in per_rank):.3f} s (slowest rank), peak GiB by rank "
                  f"{[p if p is None else round(p, 2) for _, p in per_rank]}, finite {rows[-1]['finite']} ({card})",
                  flush=True)
    pmesh.end_distributed()
    if rank == 0:
        print(card)
        print(json.dumps({"card": card, "world": world, "frames": args.frames, "height": args.height,
                          "width": args.width, "rows": rows, "ok": ok}))
    return 0 if flag[0] else 1


if __name__ == "__main__":
    sys.exit(main())
