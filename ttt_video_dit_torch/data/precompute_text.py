"""Offline T5 precompute: scene annotations -> fixed-length text embeddings
(port of data/precompute_text.py at the repo root).

T5 (with the <start_scene>/<end_scene> tokens registered) encodes every
annotation of a JSONL file to ``--max-length`` tokens, in four token-mode
variants ("", "both", "start", "end": the scene tokens around the text) so
each curriculum stage can pick the framing it needs. Each embedding is
written in float32 as ``<output-path>/<video-length>s-<max-length>[-<mode>]/
<name>_txt_emb.npy``, ``<name>`` the annotation's ``--name-key`` field.

The encoder is the port's (``models/t5.py:load_text_encoder``, float32, its
own tokenizer: no ``transformers``). The device is CUDA; without a GPU the
tool raises unless ``--device cpu`` asks for the CPU.

Usage:
    python -m ttt_video_dit_torch.data.precompute_text --t5-dir /ckpts/t5 --input-jsonl ann.jsonl \\
        --output-path /data/textemb --max-length 493 --video-length 3
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from ttt_video_dit_torch.models.dit.sampler import SCENE_END_TOKEN, SCENE_START_TOKEN

TOKEN_MODES = ("", "both", "start", "end")


def apply_token_mode(text: str, mode: str) -> str:
    if mode in ("both", "start"):
        text = SCENE_START_TOKEN + text
    if mode in ("both", "end"):
        text = text + SCENE_END_TOKEN
    return text


def parse_args(argv=None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--t5-dir", required=True)
    parser.add_argument("--t5-backend", default="auto", choices=["auto", "flax", "torch"],
                        help="accepted for the JAX tool's command lines: every value runs the port's one PyTorch "
                        "encoder (the JAX tool picks flax or HF torch)")
    parser.add_argument("--input-jsonl", required=True)
    parser.add_argument("--output-path", required=True)
    parser.add_argument("--max-length", type=int, default=493)
    parser.add_argument("--video-length", type=int, default=3)
    parser.add_argument("--batch-size", type=int, default=8)
    parser.add_argument("--text-key", default="text", help="annotation field holding the prompt")
    parser.add_argument("--name-key", default="name", help="annotation field holding the output file stem")
    parser.add_argument("--device", default="cuda", help="cuda (the default; raises without a GPU) or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    """Write every annotation's embedding in the four token modes. Returns
    the directories written, the file count and the seconds of each batch's
    encode (to the embeddings on the host)."""
    from ttt_video_dit_torch.models.t5 import load_text_encoder
    from ttt_video_dit_torch.sample import resolve_device

    args = parse_args(argv)
    device = resolve_device(args.device, "--device")
    encoder = load_text_encoder(args.t5_dir, device=device)
    with open(args.input_jsonl, encoding="utf-8") as f:
        annotations = [json.loads(line) for line in f if line.strip()]

    out_dirs, batch_seconds, files = [], [], 0
    for mode in TOKEN_MODES:
        suffix = f"-{mode}" if mode else ""
        out_dir = os.path.join(args.output_path, f"{args.video_length}s-{args.max_length}{suffix}")
        os.makedirs(out_dir, exist_ok=True)
        for start in range(0, len(annotations), args.batch_size):
            chunk = annotations[start : start + args.batch_size]
            t0 = time.perf_counter()
            embs = encoder.encode([apply_token_mode(a[args.text_key], mode) for a in chunk], args.max_length)
            embs = embs.float().cpu().numpy()  # [B, max_length, E]
            batch_seconds.append(time.perf_counter() - t0)
            for ann, emb in zip(chunk, embs):
                assert emb.shape[0] == args.max_length
                np.save(os.path.join(out_dir, f"{ann[args.name_key]}_txt_emb.npy"), emb)
                files += 1
        out_dirs.append(out_dir)
        print(f"token_mode={mode!r}: wrote {len(annotations)} embeddings to {out_dir}", flush=True)
    return {"dirs": out_dirs, "files": files, "batch_seconds": batch_seconds, "device": str(device)}


if __name__ == "__main__":
    main()
