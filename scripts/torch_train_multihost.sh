#!/usr/bin/env bash
# Multi-node training with the PyTorch port (counterpart of train_multihost.sh):
# run this script on EVERY node, with the same MASTER_ADDR (node 0's address),
# MASTER_PORT, NNODES, and each node's NODE_RANK (0 .. NNODES - 1). torchrun
# starts NPROC_PER_NODE ranks (default 8, one a card) on each node. Under
# Slurm, python -m ttt_video_dit_torch.train_submitit submits and requeues the
# job instead.
set -euo pipefail
cd "$(dirname "$0")/.."
CONFIG="${1:?usage: torch_train_multihost.sh <config.toml> [extra args...]}"
shift
PYTHONPATH=. torchrun --nnodes "${NNODES:?set NNODES}" --node_rank "${NODE_RANK:?set NODE_RANK}" \
    --nproc_per_node "${NPROC_PER_NODE:-8}" --rdzv_backend c10d \
    --rdzv_endpoint "${MASTER_ADDR:?set MASTER_ADDR}:${MASTER_PORT:-29500}" \
    -m ttt_video_dit_torch.train --job.config_file "$CONFIG" "$@"
