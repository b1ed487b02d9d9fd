"""Seconds per batch of the port's loader, through the native pool and in Python, warm and cold.

Writes ``--samples`` seeded samples at the 3 s train TOML's geometry (a
posterior [13, 32, 60, 90] float32 and one [498, 4096] float32 text
embedding each, a JSONL naming them), then reads batches of ``--batch``
(the TOML's global batch, 64) through ``PreembeddingDataset.load_batch``
as the ``DataModule`` worker does: with a 4-thread native ``PrefetchPool``,
and in Python with the native reader switched off. Each read is timed
warm (the files in the page cache) and cold (every file of the dataset
dropped from the page cache first with ``posix_fadvise(POSIX_FADV_DONTNEED)``
after an fsync), ``--rounds`` times each way in the order native, Python,
Python, native. The file reads alone (the batch's files through the pool,
or ``np.load`` one after another) are timed cold the same way, to part the
reads from the posterior draw. The first batches of both paths must be
bit-equal.

    python scripts/profile_torch_loader.py [--samples 64] [--batch 64] [--rounds 3] [--dir output/profile_loader]

Prints one line per timing, the file system of ``--dir``, the card's name
and power limit where ``nvidia-smi`` answers (the reads run on the host),
and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from unittest import mock

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ttt_video_dit_torch.data import dataset, native  # noqa: E402

POSTERIOR = (13, 32, 60, 90)  # the 3 s episode's posterior
TEXT = (498, 4096)  # one scene's embedding at the length the 3 s train TOML's CS 64 tiles


def fabricate(root: str, samples: int, seed: int) -> tuple[str, list[str]]:
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    paths, lines = [], []
    for i in range(samples):
        vid, txt = f"vid_{i}.npy", f"txt_{i}.npy"
        np.save(os.path.join(root, vid), rng.standard_normal(POSTERIOR, dtype=np.float32))
        np.save(os.path.join(root, txt), rng.standard_normal(TEXT, dtype=np.float32))
        paths += [os.path.join(root, vid), os.path.join(root, txt)]
        lines.append(json.dumps({"vid_emb": vid, "text_chunk_emb": [txt]}))
    meta = os.path.join(root, "meta.jsonl")
    with open(meta, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    os.sync()
    return meta, paths


def evict(paths: list[str]) -> None:
    for p in paths:
        fd = os.open(p, os.O_RDONLY)
        try:
            os.fsync(fd)
            os.posix_fadvise(fd, 0, 0, os.POSIX_FADV_DONTNEED)
        finally:
            os.close(fd)


def file_system(path: str) -> str:
    path, best = os.path.realpath(path), ("?", "")
    with open("/proc/mounts", encoding="utf-8") as f:
        for line in f:
            _, mount, fs = line.split()[:3]
            if (path == mount or path.startswith(mount.rstrip("/") + "/")) and len(mount) > len(best[1]):
                best = (fs, mount)
    return f"{best[0]} mounted at {best[1]}"


def read_batch(root: str, meta: str, indices: list[int], pooled: bool) -> tuple[float, list]:
    """One batch as the DataModule worker reads it: seconds and the samples."""
    data = dataset.PreembeddingDataset(root, 0.7, meta, seed=0)
    if pooled:
        pool = native.PrefetchPool(num_threads=4)
        try:
            t0 = time.perf_counter()
            out = data.load_batch(indices, pool)
            return time.perf_counter() - t0, out
        finally:
            pool.close()
    with mock.patch.object(native, "available", return_value=False):
        t0 = time.perf_counter()
        out = data.load_batch(indices)
        return time.perf_counter() - t0, out


def read_files(paths: list[str], pooled: bool) -> float:
    """Seconds to read ``paths`` into arrays: through a 4-thread pool, or with np.load one after another."""
    if not pooled:
        t0 = time.perf_counter()
        for p in paths:
            np.load(p)
        return time.perf_counter() - t0
    pool = native.PrefetchPool(num_threads=4)
    try:
        t0 = time.perf_counter()
        for job in [pool.fetch(p) for p in paths]:
            pool.wait(job)
        return time.perf_counter() - t0
    finally:
        pool.close()


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--samples", type=int, default=64)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--dir", default="output/profile_loader")
    args = parser.parse_args(argv)
    if not native.available():
        raise RuntimeError(f"the native reader did not build: {native.build_error()}")
    try:
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.CalledProcessError, IndexError):
        smi = "no nvidia-smi"
    t0 = time.perf_counter()
    meta, paths = fabricate(args.dir, args.samples, args.seed)
    nbytes = sum(os.path.getsize(p) for p in paths)
    print(f"{args.samples} samples, {nbytes / 2**30:.3f} GiB in {len(paths)} files written to "
          f"{file_system(args.dir)} in {time.perf_counter() - t0:.1f} s", flush=True)
    rng = np.random.default_rng(args.seed)
    batch_bytes = (np.prod(POSTERIOR) + np.prod(TEXT)) * 4 * args.batch
    times = {(path, state): [] for path in ("native", "python") for state in ("cold", "warm", "reads_cold")}
    first = {}
    try:
        for r in range(args.rounds):
            for pooled in (True, False, False, True):
                name = "native" if pooled else "python"
                indices = rng.permutation(args.samples)[: args.batch].tolist()
                for state in ("cold", "warm"):
                    if state == "cold":
                        evict(paths)
                    seconds, out = read_batch(args.dir, meta, indices, pooled)
                    times[name, state].append(seconds)
                    if pooled and "native" not in first:
                        first["native"] = (indices, out)
                    print(f"  round {r} {name} {state}: {seconds:.4f} s ({batch_bytes / seconds / 2**30:.2f} GiB/s)",
                          flush=True)
                evict(paths)
                files = [f"{args.dir}/{k}_{i}.npy" for i in indices for k in ("vid", "txt")]
                seconds = read_files(files, pooled)
                times[name, "reads_cold"].append(seconds)
                print(f"  round {r} {name} reads alone, cold: {seconds:.4f} s "
                      f"({batch_bytes / seconds / 2**30:.2f} GiB/s)", flush=True)
        # Both paths on the same indices from the same seed: the batches must be bit-equal.
        indices = first["native"][0]
        _, python = read_batch(args.dir, meta, indices, False)
        same = all(np.array_equal(a[k], b[k]) for a, b in zip(first["native"][1], python) for k in ("vid", "text"))
        if not same:
            raise AssertionError("the pooled and the Python batches differ")
    finally:
        shutil.rmtree(args.dir, ignore_errors=True)
    summary = {"card": smi, "samples": args.samples, "batch": args.batch, "batch_gib": batch_bytes / 2**30,
               "file_system": file_system(os.path.dirname(os.path.abspath(args.dir))), "bit_equal": same,
               **{f"{p}_{s}_s": v for (p, s), v in times.items()},
               **{f"{p}_{s}_median_s": float(np.median(v)) for (p, s), v in times.items()}}
    for state in ("cold", "warm", "reads_cold"):
        n, p = summary[f"native_{state}_median_s"], summary[f"python_{state}_median_s"]
        print(f"{state}: native pool {n:.4f} s a batch of {args.batch}, Python {p:.4f} s, Python / native "
              f"{p / n:.3f} ({smi})")
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
