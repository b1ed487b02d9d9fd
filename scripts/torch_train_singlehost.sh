#!/usr/bin/env bash
# Single-host training with the PyTorch port (counterpart of train_singlehost.sh):
# torchrun on NPROC_PER_NODE of this host's cards (default 1), the 3 s TTT-MLP
# stage unless a config is given. The --parallelism.* sizes must multiply to the
# card count, e.g. on one card:
#   scripts/torch_train_singlehost.sh configs/train/ttt-mlp/3s.toml --model.num_layers 4 \
#       --training.global_batch_size 1 --parallelism.dp_replicate 1 --parallelism.dp_sharding 1
set -euo pipefail
cd "$(dirname "$0")/.."
CONFIG="${1:-configs/train/ttt-mlp/3s.toml}"
shift $(( $# > 0 ? 1 : 0 ))
PYTHONPATH=. torchrun --standalone --nproc_per_node "${NPROC_PER_NODE:-1}" -m ttt_video_dit_torch.train \
    --job.config_file "$CONFIG" "$@"
