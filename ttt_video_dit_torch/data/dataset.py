"""Precomputed-embedding dataset, fault-tolerant deterministic sampling, and
synthetic data (port of ttt_video_dit_tpu/data/dataset.py).

JSONL metadata points at precomputed VAE latent posteriors (mean and logvar
concatenated on the channel axis, [T, 2C, H, W]) and per-scene T5 text
embeddings; the posterior is sampled at load time and scaled. The sampler
draws one shared permutation per epoch (seed 0, then 1, ...), tracks an
exact-resume ``counter``, and is checkpointable. Tensor files may be
``.npy``, ``.npz`` (its first array) or a ``torch.save``d ``.pt`` tensor.

Batches are numpy; the training entry moves them to the device. Files are
read through the native reader (``data/native.py``, the JAX package's C++
reader built with g++ at first use) where it builds and the file is one it
reads: ``load_tensor`` for ``.npy``, ``.npz`` and single-tensor ``.pt``
files, and in ``DataModule`` a pool of 4 C++ threads to which each batch's
reads are submitted up front. Without it the Python path reads the same
arrays, so the batches are bit-equal either way.
"""

from __future__ import annotations

import json
import os.path as osp
import queue
import threading
import time
from typing import Dict, Iterator, List, Optional

import numpy as np


_NATIVE_SUFFIXES = (".npy", ".npz", ".pt")


def _finish(path: str, arr: np.ndarray) -> np.ndarray:
    """The Python path's dtype for a natively read array: ``.pt`` payloads
    cast to float32 as ``torch.load(...).to(torch.float32)``; array formats
    as stored."""
    return arr.astype(np.float32) if path.endswith(".pt") and arr.dtype != np.float32 else arr


def load_tensor(path: str) -> np.ndarray:
    """A tensor file as numpy: ``.npz`` its first array, ``.npy`` as stored,
    anything else a ``torch.save``d tensor read with ``weights_only`` and
    cast to float32. Where the native reader builds it reads what it can
    (byte-equal to the Python path); the rest (a dict ``.pt``, zip64, other
    layouts) is read in Python."""
    if path.endswith(_NATIVE_SUFFIXES):
        from ttt_video_dit_torch.data import native as reader

        if reader.available():
            try:
                return _finish(path, reader.load_npy(path))
            except IOError:
                pass
    if path.endswith(".npz"):
        data = np.load(path)
        return data[list(data.keys())[0]]
    if path.endswith(".npy"):
        return np.load(path)
    import torch

    return torch.load(path, map_location="cpu", weights_only=True).to(torch.float32).numpy()


def sample_diagonal_gaussian(parameters: np.ndarray, rng: np.random.Generator, channel_axis: int = 1) -> np.ndarray:
    """A draw from the diagonal Gaussian stored as concat(mean, logvar) on
    ``channel_axis``, logvar clipped to [-30, 20]; the normals come from
    ``rng`` in sample order, so the draws equal the JAX package's."""
    mean, logvar = np.split(parameters, 2, axis=channel_axis)
    logvar = np.clip(logvar, -30.0, 20.0)
    std = np.exp(0.5 * logvar)
    return (mean + std * rng.standard_normal(mean.shape)).astype(np.float32)


class PreembeddingDataset:
    """JSONL-described dataset of precomputed latents and text embeddings:
    each line names ``vid_emb`` (a posterior) and ``text_chunk_emb`` (one
    file per scene), relative to ``dataset_path`` unless absolute."""

    RETRIES = 10

    def __init__(self, dataset_path: Optional[str], scale_factor: float, jsonl_paths, seed: int = 0):
        self.dataset_path = dataset_path or ""
        self.scale_factor = scale_factor
        self.metadata_list: List[dict] = []
        self._rng = np.random.default_rng(seed)
        if isinstance(jsonl_paths, str):
            jsonl_paths = jsonl_paths.split(",")
        for jsonl_path in jsonl_paths:
            with open(jsonl_path, encoding="utf-8") as f:
                self.metadata_list += [json.loads(line) for line in f if line.strip()]

    def __len__(self) -> int:
        return len(self.metadata_list)

    def abs_path(self, path: str) -> str:
        return path if osp.isabs(path) else osp.join(self.dataset_path, path)

    def __getitem__(self, index: int) -> Dict[str, np.ndarray]:
        err: Optional[Exception] = None
        for _ in range(self.RETRIES):  # data-level fault tolerance, as in the reference
            try:
                return self._load(index)
            except Exception as e:  # noqa: BLE001 -- deliberately broad, like the reference
                err = e
        raise RuntimeError(f"Failed to load sample {index} after {self.RETRIES} retries") from err

    def _load(self, index: int) -> Dict[str, np.ndarray]:
        metadata = self.metadata_list[index]
        posterior = load_tensor(self.abs_path(metadata["vid_emb"]))  # [T, 2C, H, W]
        txt = np.stack([load_tensor(self.abs_path(p)) for p in metadata["text_chunk_emb"]], axis=0)
        vae_emb = self.scale_factor * sample_diagonal_gaussian(posterior, self._rng, channel_axis=1)
        return {"vid": vae_emb, "text": txt.astype(np.float32)}

    def load_batch(self, indices, pool=None) -> List[Dict[str, np.ndarray]]:
        """The samples of ``indices``, in order. With a native ``PrefetchPool``
        every read of the batch is submitted up front, so the files are read
        concurrently off the GIL; each sample's posterior is drawn after its
        reads, in sample order, so the generator is consumed as by
        ``self[i]`` one at a time and the batch is bit-equal. A sample whose
        read fails has its outstanding reads drained, then takes the
        retrying path of ``self[i]`` (the generator untouched until then)."""
        if pool is None:
            return [self[i] for i in indices]
        fetch = lambda p: pool.fetch(p) if p.endswith(_NATIVE_SUFFIXES) else None  # noqa: E731
        plan = []
        for i in indices:
            md = self.metadata_list[i]
            vid = self.abs_path(md["vid_emb"])
            texts = [self.abs_path(p) for p in md["text_chunk_emb"]]
            plan.append((i, vid, fetch(vid), texts, [fetch(p) for p in texts]))
        read = lambda p, j: load_tensor(p) if j is None else _finish(p, pool.wait(j))  # noqa: E731
        out = []
        for i, vid, vid_job, texts, text_jobs in plan:
            try:
                posterior = read(vid, vid_job)
                txt = np.stack([read(p, j) for p, j in zip(texts, text_jobs)], axis=0)
            except Exception:  # noqa: BLE001 -- any failure takes the retrying path, as in the JAX package
                for j in (vid_job, *text_jobs):
                    if j is not None:
                        pool.discard(j)
                out.append(self[i])
                continue
            vae_emb = self.scale_factor * sample_diagonal_gaussian(posterior, self._rng, channel_axis=1)
            out.append({"vid": vae_emb, "text": txt.astype(np.float32)})
        return out


class FaultTolerantSampler:
    """Deterministic shuffled index stream with exact-resume state: one
    permutation per epoch shared by every process (``epoch_permutation``),
    ``counter``, the samples of the current epoch consumed so far, and
    ``rng_state``, the posterior draws' generator after the consumed samples
    (the JAX package's state has no such key, and its resumed run draws
    other posterior samples; with it, a resumed run yields the batches of an
    uninterrupted one)."""

    def __init__(self, num_samples: int, seed: int = 0):
        self.num_samples = num_samples
        self._epoch_seed = seed
        self.counter = 0
        self.rng_state: Optional[dict] = None

    def state_dict(self) -> dict:
        state = {"epoch_seed": int(self._epoch_seed), "counter": int(self.counter)}
        return state if self.rng_state is None else {**state, "rng": self.rng_state}

    def load_state_dict(self, state: dict) -> None:
        self._epoch_seed = int(state["epoch_seed"])
        self.counter = int(state.get("counter", 0))
        self.rng_state = state.get("rng")

    def commit(self, epoch_seed: int, counter: int, rng_state: Optional[dict] = None) -> None:
        """Record the consumed position (called by the consumer as a batch is
        yielded, so a checkpointed state never runs ahead of training)."""
        self._epoch_seed = int(epoch_seed)
        self.counter = int(counter)
        self.rng_state = rng_state

    @staticmethod
    def epoch_permutation(epoch_seed: int, num_samples: int) -> np.ndarray:
        return np.random.default_rng(epoch_seed).permutation(num_samples)


class DataModule:
    """Global batches with a background prefetch thread. Each process loads
    its contiguous shard (``process_index`` of ``process_count``) of every
    global batch. An epoch's tail shorter than a global batch is dropped and
    the next epoch's permutation begins, so every batch maps to exactly one
    (epoch_seed, counter). ``load_seconds`` holds the worker's seconds per
    batch (file reads and the posterior draw). Where the native reader
    builds, the worker reads each batch through a native ``PrefetchPool`` of
    4 threads; ``native_reader`` says whether it does."""

    PREFETCH = 2  # batches loaded ahead of the consumer

    def __init__(self, dataset_path: Optional[str], scale_factor: float, jsonl_paths, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        self.dataset = PreembeddingDataset(dataset_path, scale_factor, jsonl_paths, seed=seed)
        self.sampler = FaultTolerantSampler(len(self.dataset), seed=0)
        self.process_index = process_index
        self.process_count = process_count
        self.load_seconds: List[float] = []

    @property
    def native_reader(self) -> bool:
        """Whether batches are read through the native pool (the reader builds)."""
        from ttt_video_dit_torch.data import native

        return native.available()

    def batches(self, global_batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Infinite stream of this process's batch shards (global / process_count)."""
        _check_divides(global_batch_size, self.process_count)
        if len(self.dataset) < global_batch_size:
            raise ValueError(f"{len(self.dataset)} samples cannot fill a global batch of {global_batch_size}")
        local = global_batch_size // self.process_count
        q: "queue.Queue" = queue.Queue(maxsize=self.PREFETCH)
        stop = threading.Event()
        n = len(self.dataset)

        def worker():
            # Worker-local position: the shared sampler is only read here; the consumer commits.
            epoch_seed, counter = self.sampler._epoch_seed, self.sampler.counter
            rng = self.dataset._rng
            if self.sampler.rng_state is not None:
                rng.bit_generator.state = self.sampler.rng_state
            remaining = FaultTolerantSampler.epoch_permutation(epoch_seed, n)[counter:].tolist()
            pool = None
            if self.native_reader:
                from ttt_video_dit_torch.data import native

                pool = native.PrefetchPool(num_threads=4)
            try:
                produce(epoch_seed, counter, rng, remaining, pool)
            finally:
                if pool is not None:
                    pool.close()

        def produce(epoch_seed, counter, rng, remaining, pool):
            while not stop.is_set():
                try:
                    if len(remaining) < global_batch_size:
                        epoch_seed, counter = epoch_seed + 1, 0
                        remaining = FaultTolerantSampler.epoch_permutation(epoch_seed, n).tolist()
                    idxs, remaining = remaining[:global_batch_size], remaining[global_batch_size:]
                    counter += global_batch_size
                    t0 = time.perf_counter()
                    shard = idxs[self.process_index * local : (self.process_index + 1) * local]
                    samples = self.dataset.load_batch(shard, pool)
                    item = ({k: np.stack([s[k] for s in samples]) for k in samples[0]},
                            (epoch_seed, counter, rng.bit_generator.state), time.perf_counter() - t0)
                except Exception as e:  # noqa: BLE001 -- handed to the consumer, which raises it
                    item = e
                while not stop.is_set():
                    try:
                        q.put(item, timeout=0.2)
                        break
                    except queue.Full:
                        continue
                if isinstance(item, Exception):
                    return

        thread = threading.Thread(target=worker, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, Exception):
                    raise item
                batch, position, seconds = item
                self.sampler.commit(*position)
                self.load_seconds.append(seconds)
                yield batch
        finally:
            stop.set()
            thread.join()


def _check_divides(global_batch_size: int, process_count: int) -> None:
    if global_batch_size % process_count:
        raise ValueError(f"global batch {global_batch_size} is not divisible by {process_count} processes")


class SyntheticSampler:
    """The synthetic stream's exact-resume state: the samples drawn so far and
    the numpy generator's state after them."""

    def __init__(self, seed: int):
        self.counter = 0
        self.rng = np.random.default_rng(seed)

    def state_dict(self) -> dict:
        return {"counter": int(self.counter), "rng": self.rng.bit_generator.state}

    def load_state_dict(self, state: dict) -> None:
        self.counter = int(state["counter"])
        self.rng.bit_generator.state = state["rng"]


class SyntheticDataModule:
    """Random latents and text embeddings with the right geometry, drawn from
    a numpy generator seeded with ``seed`` (the same numbers as the JAX
    module's for the same seed and shapes, in one process). Its sampler's
    state carries the generator, so a resumed run draws what an
    uninterrupted one draws. Every process draws the whole global batch and
    keeps its contiguous shard (``process_index`` of ``process_count``), so
    N processes train on the batch one process draws; the JAX module draws
    only a shard's worth in each process, the same samples everywhere."""

    def __init__(self, vid_shape, text_shape, seed: int = 0, process_index: int = 0, process_count: int = 1):
        self.vid_shape = vid_shape
        self.text_shape = text_shape
        self.sampler = SyntheticSampler(seed)
        self.process_index = process_index
        self.process_count = process_count

    def batches(self, global_batch_size: int) -> Iterator[Dict[str, np.ndarray]]:
        """Yields this process's shard (global / process_count)."""
        _check_divides(global_batch_size, self.process_count)
        local = global_batch_size // self.process_count
        shard = slice(self.process_index * local, (self.process_index + 1) * local)
        rng = self.sampler.rng
        while True:
            batch = {"vid": rng.standard_normal((global_batch_size, *self.vid_shape))[shard].astype(np.float32),
                     "text": rng.standard_normal((global_batch_size, *self.text_shape))[shard].astype(np.float32)}
            self.sampler.counter += global_batch_size
            yield batch
