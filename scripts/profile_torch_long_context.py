"""Peak device memory of one long-context DiT forward, chunked and not.

Builds the DiT of an eval TOML (default configs/eval/ttt-mlp/63s.toml: 253
latent frames of 60 x 90, 21 scenes of 458 text tokens, L = 351,168, CFG
batch 2) at full width and ``--layers`` layers (default 1: layer 0), random
weights, and runs one forward under inference mode for each variant:

- ``chunked``: the port as it stands, every chunked site bounded by
  ``models/dit/dit.py:CHUNK_BYTES``;
- ``without <site>``: one site in one piece (its ``in_chunks`` call runs
  ``fn(x)``), the other chunked; the sites are the MLP and the attention's
  q/k LayerNorm + rope;
- ``unchunked``: both in one piece (the computation before chunking).

For each it prints the peak allocation above what the weights and inputs
hold, and the seconds of the forward (or the size of the failed allocation).
With --layers 42 it also gives the sampling stage's peak for one eval.

    python scripts/profile_torch_long_context.py [--job.config_file TOML] [--layers N] [--variants a,b,...]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SITES = {"mlp": "MLP.forward", "qk_norm_rope": "SegmentLocalAttention.forward"}
CHUNKED = {}  # the port's own in_chunks, kept across patches


def patch_in_chunks(whole: set[str]) -> None:
    """Make the ``in_chunks`` calls made from the functions in ``whole``
    (qualified names) run in one piece."""
    from ttt_video_dit_torch.models.dit import dit

    chunked = CHUNKED.setdefault("in_chunks", dit.in_chunks)

    def in_chunks(fn, x, row_bytes, dim=1):
        if sys._getframe(1).f_code.co_qualname in whole:
            return fn(x)
        return chunked(fn, x, row_bytes, dim)

    dit.in_chunks = in_chunks


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--job.config_file", dest="config", default="configs/eval/ttt-mlp/63s.toml")
    p.add_argument("--layers", type=int, default=1)
    p.add_argument("--variants", default="chunked," + ",".join(f"without {s}" for s in SITES) + ",unchunked")
    args = p.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    from ttt_video_dit_torch.models.dit.dit import sequence_metadata
    from ttt_video_dit_torch.sample import build_model, model_config, parse_args

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    job = parse_args(["--job.config_file", args.config, "--model.num_layers", str(args.layers)])
    cfg, ev = model_config(job), job.eval
    device = torch.device("cuda", 0)
    from concurrent.futures import ThreadPoolExecutor

    from ttt_video_dit_torch.ops import _build

    with ThreadPoolExecutor(2) as pool:  # one nvcc per kernel library, before any forward is timed
        list(pool.map(_build.load, ("attention_forward", f"{cfg.ssm_layer}_forward")))
    model = build_model(cfg, device)
    scenes, T, h, w = cfg.num_chunks, ev.sampling_num_frames, ev.image_height // 8, ev.image_width // 8
    meta = sequence_metadata(cfg, T, h, w, scenes, ev.txt_maxlen)
    gen = torch.Generator(device).manual_seed(0)
    video = torch.randn(2, T, ev.latent_channels, h, w, generator=gen, device=device).to(torch.bfloat16)
    text = torch.randn(2, scenes, ev.txt_maxlen, cfg.text_dim, generator=gen, device=device)
    timesteps = torch.tensor([999.0, 500.0], device=device)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(device)
    print(f"{cfg.ssm_layer} d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers, "
          f"L = {meta.seq_text_length + meta.num_video_tokens} ({scenes} scenes x {ev.txt_maxlen} + {T} frames x "
          f"{meta.tokens_per_frame}), CFG batch 2; weights and inputs {base / 2**30:.2f} GiB ({card})", flush=True)
    for variant in args.variants.split(","):
        if variant == "chunked":
            whole = set()
        elif variant == "unchunked":
            whole = set(SITES.values())
        else:
            whole = {SITES[variant.removeprefix("without ")]}
        patch_in_chunks(whole)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        try:
            with torch.inference_mode():
                out = model.dit(video, text, timesteps)
            torch.cuda.synchronize()
            result = f"{time.perf_counter() - t0:.3f} s, output {list(out.shape)} finite {bool(torch.isfinite(out).all())}"
            del out
        except torch.OutOfMemoryError as e:
            result = f"out of memory ({str(e).splitlines()[0][:120]})"
        peak = torch.cuda.max_memory_allocated(device)
        print(f"  {variant:24s} peak {peak / 2**30:7.2f} GiB, {(peak - base) / 2**30:7.2f} GiB above the weights and "
              f"inputs: {result}", flush=True)


if __name__ == "__main__":
    main()
