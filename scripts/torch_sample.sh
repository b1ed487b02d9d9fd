#!/usr/bin/env bash
# Sampling with the PyTorch port (counterpart of sample.sh): torchrun on
# NPROC_PER_NODE of this host's cards (default 1; the eval TOML's tp_sharding
# ranks decode together, the others sample their share of the storyboards).
set -euo pipefail
cd "$(dirname "$0")/.."
CONFIG="${1:?usage: torch_sample.sh <eval-config.toml> <storyboard.json> [extra args...]}"
STORY="${2:?usage: torch_sample.sh <eval-config.toml> <storyboard.json> [extra args...]}"
shift 2
PYTHONPATH=. torchrun --standalone --nproc_per_node "${NPROC_PER_NODE:-1}" -m ttt_video_dit_torch.sample \
    --job.config_file "$CONFIG" --eval.input_file "$STORY" "$@"
