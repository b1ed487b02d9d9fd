#!/usr/bin/env bash
# Offline precompute with the PyTorch port (counterpart of precompute.sh):
# video latents, then text embeddings, on the card. Set PROCESS_INDEX and
# PROCESS_COUNT per process to partition the episodes.
set -euo pipefail
cd "$(dirname "$0")/.."
EPISODE_DIR="${EPISODE_DIR:?set EPISODE_DIR (mp4 episodes)}"
SAVE_DIR="${SAVE_DIR:?set SAVE_DIR (latent + text output root)}"
VAE_CHECKPOINT="${VAE_CHECKPOINT:?set VAE_CHECKPOINT (torch VAE .pt)}"
T5_DIR="${T5_DIR:?set T5_DIR (T5 model dir)}"
ANNOTATIONS="${ANNOTATIONS:?set ANNOTATIONS (jsonl of episode texts)}"
VIDEO_LENGTH="${VIDEO_LENGTH:-3}"

PYTHONPATH=. python -m ttt_video_dit_torch.data.precompute_video \
    --episode-dir "$EPISODE_DIR" --save-dir "$SAVE_DIR/video" \
    --vae-checkpoint "$VAE_CHECKPOINT" --video-length "$VIDEO_LENGTH" \
    --process-index "${PROCESS_INDEX:-0}" --process-count "${PROCESS_COUNT:-1}" "$@"
PYTHONPATH=. python -m ttt_video_dit_torch.data.precompute_text \
    --t5-dir "$T5_DIR" --input-jsonl "$ANNOTATIONS" \
    --output-path "$SAVE_DIR/text" --video-length "$VIDEO_LENGTH"
