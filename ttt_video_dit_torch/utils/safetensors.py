"""Reader and writer of the safetensors layout, without the ``safetensors`` package.

A file is an 8-byte little-endian header length N, N bytes of JSON, then the
raw tensor bytes. The JSON maps each tensor name to its ``dtype``, ``shape``
and ``data_offsets`` ([begin, end) in bytes from the start of the data) and
may hold a ``__metadata__`` map of strings. A checkpoint is one such file or a
directory of shards, listed by a ``*.safetensors.index.json`` (its
``weight_map`` names the shard of each tensor) or else every
``*.safetensors`` file in name order.

:func:`iter_tensors` yields one tensor at a time, read straight from its
bytes, so converting a checkpoint never holds the whole source in memory.
:func:`load_into` copies such a stream into a module's state dict, strictly
checked, and :class:`LazyFile` looks tensors up by name one at a time; every loader of the port (its own checkpoints, HF's DiT shards,
T5) is built on it. :func:`save_file` writes the same layout, one tensor at
a time. Sharded parameters (DTensors, parallel/sharding.py) are written and
read as their full tensors.
"""

from __future__ import annotations

import glob
import json
import os
import struct
from collections.abc import Mapping
from typing import Callable, Iterable, Iterator, Optional

import torch

from ttt_video_dit_torch.parallel.sharded import copy_full_, full

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16, "I64": torch.int64}
_NAMES = {v: k for k, v in DTYPES.items()}
_MAX_HEADER = 100 << 20  # a header larger than this is not a safetensors file


def read_header(path: str) -> tuple[dict, int]:
    """(the JSON header without ``__metadata__``, the byte offset of the data)."""
    with open(path, "rb") as f:
        head = f.read(8)
        if len(head) != 8:
            raise ValueError(f"{path}: too short for a safetensors file")
        (n,) = struct.unpack("<Q", head)
        if n > _MAX_HEADER:
            raise ValueError(f"{path}: header length {n} is not plausible for a safetensors file")
        header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def shard_files(path: str) -> list[str]:
    """The files of a checkpoint: ``path`` itself, or a directory's shards
    (those its ``*.safetensors.index.json`` names, else all ``*.safetensors``)."""
    if os.path.isfile(path):
        return [path]
    indexes = sorted(glob.glob(os.path.join(path, "*.safetensors.index.json")))
    if indexes:
        files = []
        for index in indexes:
            with open(index, encoding="utf-8") as f:
                weight_map = json.load(f)["weight_map"]
            files += [os.path.join(path, name) for name in sorted(set(weight_map.values()))]
        return files
    files = sorted(glob.glob(os.path.join(path, "*.safetensors")))
    if not files:
        raise FileNotFoundError(f"no *.safetensors file under {path}")
    return files


def _read_tensor(f, name: str, entry: dict, data_start: int, path: str) -> torch.Tensor:
    dtype = DTYPES.get(entry["dtype"])
    if dtype is None:
        raise ValueError(f"{path}: tensor {name!r} has dtype {entry['dtype']}; supported: {sorted(DTYPES)}")
    shape = [int(s) for s in entry["shape"]]
    begin, end = (int(o) for o in entry["data_offsets"])
    count = 1
    for s in shape:
        count *= s
    if end - begin != count * dtype.itemsize:
        raise ValueError(f"{path}: tensor {name!r} holds {end - begin} bytes, {shape} {entry['dtype']} needs "
                         f"{count * dtype.itemsize}")
    f.seek(data_start + begin)
    buf = bytearray(end - begin)
    if f.readinto(buf) != len(buf):
        raise ValueError(f"{path}: tensor {name!r} runs past the end of the file")
    if not buf:
        return torch.empty(shape, dtype=dtype)
    return torch.frombuffer(buf, dtype=dtype).reshape(shape)


def iter_tensors(path: str) -> Iterator[tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` pairs of a file or a directory of shards, one
    tensor at a time, in each file's data order (CPU tensors of the stored
    dtype)."""
    for fn in shard_files(path):
        header, data_start = read_header(fn)
        with open(fn, "rb") as f:
            for name in sorted(header, key=lambda k: header[k]["data_offsets"][0]):
                yield name, _read_tensor(f, name, header[name], data_start, fn)


class LazyFile(Mapping):
    """The tensors of one file whose names start with ``prefix``, by the name
    after it, each read from disk when it is looked up (so a consumer that
    copies them one at a time never holds the file in memory)."""

    def __init__(self, path: str, prefix: str = ""):
        self.path = path
        header, self._data_start = read_header(path)
        self._entries = {k[len(prefix):]: (k, v) for k, v in header.items() if k.startswith(prefix)}

    def __getitem__(self, name: str) -> torch.Tensor:
        key, entry = self._entries[name]
        with open(self.path, "rb") as f:
            return _read_tensor(f, key, entry, self._data_start, self.path)

    def __iter__(self) -> Iterator[str]:
        return iter(self._entries)

    def __len__(self) -> int:
        return len(self._entries)


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of a file or a directory of shards, as a dict."""
    return dict(iter_tensors(path))


@torch.no_grad()
def load_into(module: torch.nn.Module, source: str | Iterable[tuple[str, torch.Tensor]],
              rename: Optional[Callable[[str], Optional[str]]] = None, strict: bool = True) -> int:
    """Copy the tensors of ``source`` (a file or a directory of shards, or an
    iterable of ``(name, tensor)``) into ``module``'s state dict in place, one
    tensor at a time, cast to each entry's dtype and device (a DTensor entry
    takes its shard of the full tensor). ``rename`` maps a
    source name to the module's name, or to None to skip the tensor. Every
    name kept must be one of the module's, at its shape; with ``strict``,
    every entry of the state dict must be loaded. Returns the count of
    tensors copied."""
    where = source if isinstance(source, str) else "checkpoint"
    params = module.state_dict()
    missing = set(params)
    n = 0
    for key, value in iter_tensors(source) if isinstance(source, str) else source:
        name = rename(key) if rename is not None else key
        if name is None:
            continue
        if name not in params:
            raise KeyError(f"{where}: unexpected key {key!r}" + (f" (as {name!r})" if name != key else "")
                           + ", not in the module")
        if params[name].shape != value.shape:
            raise ValueError(f"{where}: {key} has shape {tuple(value.shape)}, the module's {name} "
                             f"{tuple(params[name].shape)}")
        copy_full_(params[name], value)
        missing.discard(name)
        n += 1
    if strict and missing:
        raise KeyError(f"{where}: missing {len(missing)} keys, e.g. {sorted(missing)[:4]}")
    return n


def save_file(tensors: dict[str, torch.Tensor], path: str) -> None:
    """Write ``tensors`` (F32, F16, BF16 or I64, any device) to ``path`` in the
    safetensors layout, one tensor at a time: only one tensor's host copy is
    alive at once. A DTensor is written as its full tensor, gathered when its
    turn comes (a collective: every rank of its mesh must gather it too,
    :func:`gather_only`). The header is padded with spaces to 8 bytes, as the
    ``safetensors`` package pads it."""
    header, offset = {}, 0
    for name, t in tensors.items():
        if t.dtype not in _NAMES:
            raise ValueError(f"tensor {name!r} has dtype {t.dtype}; supported: {sorted(DTYPES)}")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape), "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for t in tensors.values():
            if t.numel():
                f.write(full(t).detach().to("cpu").contiguous().reshape(-1).view(torch.uint8).numpy().data)
    os.replace(tmp, path)


def gather_only(tensors: dict[str, torch.Tensor]) -> None:
    """What :func:`save_file` gathers, in its order, writing nothing: the
    part of the ranks that do not write."""
    for t in tensors.values():
        if t.numel():
            full(t)
