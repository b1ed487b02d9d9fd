"""Synthetic training data (port of ttt_video_dit_tpu/data/dataset.py:
SyntheticDataModule). The real-data loader (jsonl + precomputed latents) is
not ported yet. The fault-tolerant sampler of the JAX module only counts
samples here (no resume is ported)."""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np


class SyntheticDataModule:
    """Random latents and text embeddings with the right geometry, drawn from
    a numpy generator seeded with ``seed`` (the same numbers as the JAX
    module's for the same seed and shapes)."""

    def __init__(self, vid_shape, text_shape, seed: int = 0, process_count: int = 1):
        self.vid_shape = vid_shape
        self.text_shape = text_shape
        self.samples_seen = 0
        self._rng = np.random.default_rng(seed)
        self.process_count = process_count

    def batches(self, global_batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yields this process's shard (global / process_count)."""
        assert global_batch_size % self.process_count == 0
        local = global_batch_size // self.process_count
        while True:
            self.samples_seen += global_batch_size
            yield {
                "vid": self._rng.standard_normal((local, *self.vid_shape)).astype(np.float32),
                "text": self._rng.standard_normal((local, *self.text_shape)).astype(np.float32),
            }
