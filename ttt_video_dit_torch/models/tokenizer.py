"""A T5 tokenizer in plain Python: SentencePiece unigram segmentation read
from a T5 model directory, with no ``transformers``, ``tokenizers``,
``sentencepiece`` or ``google.protobuf`` import.

It reproduces what ``transformers``' ``T5TokenizerFast`` does with the same
directory (its ``tokenizer.json``, or the fast tokenizer its converter builds
from ``spiece.model``), as the JAX package's ``models/t5.py:_tokenize``
calls it:

1. added tokens (the model's control and user-defined pieces, T5's 100
   ``<extra_id_N>`` and the scene tokens added by :meth:`add_special_tokens`)
   are matched whole, leftmost-longest, before anything else;
2. every other segment is normalised: by the model's precompiled character
   map (SentencePiece's ``nmt_nfkc`` rules, :class:`PrecompiledCharsMap`,
   applied as ``tokenizers``' ``Precompiled`` normaliser applies it: per
   extended grapheme cluster, a cluster of under 6 UTF-8 bytes whose
   shortest prefix the map holds replaced whole) where the model has one
   (a ``tokenizer.json`` of type ``NFKC`` gets Unicode NFKC through
   ``unicodedata``, and a model with neither nothing), then trailing spaces
   are stripped and runs of two or more spaces collapsed;
3. spaces become ``▁``, a ``▁`` is prepended (the prepend scheme: "always"
   before every segment, "first" only at the start of the text) and the
   segment is split before every ``▁``;
4. each piece is segmented by Viterbi over the unigram scores, unknown
   characters scoring the lowest piece score minus 10 and consecutive ones
   fused into one ``<unk>``;
5. ``</s>`` is appended after truncation to ``maxlen - 1`` and the ids are
   right-padded with ``<pad>`` to ``maxlen``.

``spiece.model`` is a ``ModelProto`` read from its protobuf wire format by
:func:`read_sentencepiece_model`: the pieces (piece, score, type), the
trainer's unk/eos/pad ids and the ``normalizer_spec`` flags. As
``transformers``' converter does, T5's 100 extra ids are appended to its
pieces counting down (``<extra_id_0>`` is the last id, ``vocab_size + 99``),
and steps 2 and 3 ignore the flags: the strip, the collapse, ``▁`` and the
"always" scheme apply whatever they say.
``tokenizer.json`` is HF's serialisation; only its Unigram model is read
(:func:`is_unigram_tokenizer_json` says whether a file holds one).
"""

from __future__ import annotations

import base64
import json
import os
import re
import struct
import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from ttt_video_dit_torch.models import graphemes

SPACE = "▁"
UNK_PENALTY = 10.0  # tokenizers' K_UNK_PENALTY: an unknown character scores min_score - 10
EXTRA_IDS = 100  # T5's sentinel tokens <extra_id_0> .. <extra_id_99>
# SentencePiece piece types (sentencepiece_model.proto) that the tokenizer tells apart.
NORMAL, CONTROL, USER_DEFINED = 1, 3, 4


# ------------------------------------------------------------ protobuf wire format


def _varint(buf: bytes, pos: int) -> Tuple[int, int]:
    value = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, pos
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of each field of one message: an int
    for varint and fixed fields, bytes for length-delimited ones."""
    pos = 0
    while pos < len(buf):
        key, pos = _varint(buf, pos)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, pos = _varint(buf, pos)
        elif wire == 1:
            value, pos = buf[pos : pos + 8], pos + 8
        elif wire == 2:
            n, pos = _varint(buf, pos)
            value, pos = buf[pos : pos + n], pos + n
        elif wire == 5:
            value, pos = buf[pos : pos + 4], pos + 4
        else:
            raise ValueError(f"protobuf wire type {wire} (field {num}) is not supported")
        yield num, wire, value


def _int32(v: int) -> int:
    """A varint-encoded int32 (negative values are 10-byte two's complement)."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def read_sentencepiece_model(path: str) -> dict:
    """The fields of a SentencePiece ``ModelProto`` the tokenizer needs:
    ``pieces`` [(piece, score, type)], ``model_type``, ``unk_id``,
    ``pad_id``, and the normalizer's ``name``, ``precompiled_charsmap``,
    ``add_dummy_prefix``, ``remove_extra_whitespaces``,
    ``escape_whitespaces`` (proto2 defaults where a field is absent)."""
    with open(path, "rb") as f:
        buf = f.read()
    out = dict(pieces=[], model_type=1, unk_id=0, pad_id=-1, name="", precompiled_charsmap=b"",
               add_dummy_prefix=True, remove_extra_whitespaces=True, escape_whitespaces=True)
    for num, _, value in _fields(buf):
        if num == 1:  # SentencePiece: piece = 1, score = 2 (float), type = 3
            piece, score, kind = "", 0.0, NORMAL
            for n, _, v in _fields(value):
                if n == 1:
                    piece = v.decode("utf-8")
                elif n == 2:
                    score = struct.unpack("<f", v)[0]
                elif n == 3:
                    kind = v
            out["pieces"].append((piece, score, kind))
        elif num == 2:  # TrainerSpec
            names = {3: "model_type", 40: "unk_id", 43: "pad_id"}
            for n, _, v in _fields(value):
                if n in names:
                    out[names[n]] = _int32(v)
        elif num == 3:  # NormalizerSpec
            for n, _, v in _fields(value):
                if n == 1:
                    out["name"] = v.decode("utf-8")
                elif n == 2:
                    out["precompiled_charsmap"] = bytes(v)
                elif n in (3, 4, 5):
                    out[("add_dummy_prefix", "remove_extra_whitespaces", "escape_whitespaces")[n - 3]] = bool(v)
    return out


# ------------------------------------------------------------ the precompiled character map


def _offset(unit: int) -> int:
    """The offset a darts-clone double-array unit holds."""
    return (unit >> 10) << ((unit & 0x200) >> 6)


class PrecompiledCharsMap:
    """SentencePiece's precompiled character map (``normalizer_spec.
    precompiled_charsmap``; ``tokenizers``' ``Precompiled`` normaliser), as
    ``tokenizers`` applies it.

    The blob is a little-endian u32 trie size in bytes, that many bytes of
    darts-clone double-array units (u32: has-leaf bit 8, label
    ``unit & 0x800000FF``, offset ``(unit >> 10) << ((unit & 0x200) >> 6)``,
    a leaf's value ``unit & 0x7FFFFFFF``), then the NUL-separated normalised
    strings the leaves point into. A text is looked up one extended grapheme
    cluster at a time: a cluster of fewer than 6 UTF-8 bytes that has a
    match becomes the string of its shortest matching prefix, whole (so
    ``Ａ`` + U+0301 becomes ``A`` where the map holds ``Ａ``); any other
    cluster is looked up one code point at a time, each kept as it is where
    the map holds no prefix of it."""

    def __init__(self, blob: bytes):
        if len(blob) < 4:
            raise ValueError(f"a precompiled character map of {len(blob)} bytes has no trie size")
        (size,) = struct.unpack_from("<I", blob)
        if size % 4 or 4 + size > len(blob):
            raise ValueError(f"a precompiled character map of {len(blob)} bytes cannot hold a {size}-byte trie")
        self.units = struct.unpack_from(f"<{size // 4}I", blob, 4)
        self.normalized = bytes(blob[4 + size :])
        self.normalized.decode("utf-8")  # tokenizers refuses a map whose strings are not UTF-8
        self._cache: Dict[str, Optional[str]] = {}

    def lookup(self, chunk: str) -> Optional[str]:
        """The normalised string of the shortest prefix of ``chunk``'s UTF-8
        bytes that the map holds (a NUL byte ends the key), or None."""
        if chunk in self._cache:
            return self._cache[chunk]
        units, out = self.units, None
        pos = _offset(units[0])
        for c in chunk.encode("utf-8"):
            if c == 0:
                break
            pos ^= c
            unit = units[pos]
            if unit & 0x800000FF != c:
                break
            pos ^= _offset(unit)
            if unit >> 8 & 1:
                start = units[pos] & 0x7FFFFFFF
                end = self.normalized.find(b"\0", start)
                out = self.normalized[start : end if end >= 0 else len(self.normalized)].decode("utf-8")
                break
        self._cache[chunk] = out
        return out

    def __call__(self, text: str) -> str:
        out = []
        for cluster in graphemes.clusters(text):
            norm = self.lookup(cluster) if len(cluster.encode("utf-8")) < 6 else None
            if norm is not None:
                out.append(norm)
                continue
            for ch in cluster:
                norm = self.lookup(ch)
                out.append(ch if norm is None else norm)
        return "".join(out)


# ------------------------------------------------------------ the tokenizer


class UnigramTokenizer:
    """T5's tokenizer: see the module docstring for the pipeline.

    ``pieces``: (piece, score) by id; ``added``: token -> id of the tokens
    matched whole before normalisation; ``normalizers``: callables applied in
    order to each segment; ``prepend``: "always", "first" or "never";
    ``whitespace_split``: split on whitespace before the ``▁`` rule (older
    tokenizer.json files); ``suffix``: the ids appended to every text."""

    def __init__(self, pieces: Sequence[Tuple[str, float]], unk_id: int, added: Dict[str, int], normalizers,
                 prepend: str = "always", whitespace_split: bool = False, suffix: Sequence[int] = (),
                 pad_id: int = 0, replacement: str = SPACE):
        self.pieces = list(pieces)
        self.vocab = {}
        for i, (p, _) in enumerate(self.pieces):
            self.vocab.setdefault(p, i)
        self.scores = [s for _, s in self.pieces]
        self.unk_id = unk_id
        self.unk_score = min(self.scores) - UNK_PENALTY
        self.max_piece = max(len(p) for p, _ in self.pieces)
        self.added = dict(added)
        self.normalizers = list(normalizers)
        self.prepend = prepend
        self.whitespace_split = whitespace_split
        self.suffix = list(suffix)
        self.pad_id = pad_id
        self.replacement = replacement
        self._added_re = None

    def __len__(self) -> int:
        return len(set(self.vocab.values()) | set(self.added.values()))

    def add_special_tokens(self, tokens: Iterable[str]) -> None:
        """Match ``tokens`` whole from now on; a token that is new gets the next
        id (``len(self)``), as ``transformers``' ``add_special_tokens`` gives it."""
        for t in tokens:
            if t not in self.added:
                self.added[t] = self.vocab[t] if t in self.vocab else len(self)
        self._added_re = None

    # -- the pipeline

    def _split_added(self, text: str) -> List[Tuple[str, int, Optional[int]]]:
        """(segment, offset in text, id or None) in order: added tokens
        leftmost-longest, the text between them as segments without an id."""
        if not self.added:
            return [(text, 0, None)]
        if self._added_re is None:
            alternatives = sorted(self.added, key=lambda t: (-len(t), t))  # longest first: leftmost-longest
            self._added_re = re.compile("|".join(map(re.escape, alternatives)))
        out, pos = [], 0
        for m in self._added_re.finditer(text):
            if m.start() > pos:
                out.append((text[pos : m.start()], pos, None))
            out.append((m.group(), m.start(), self.added[m.group()]))
            pos = m.end()
        if pos < len(text):
            out.append((text[pos:], pos, None))
        return out

    def _pre_tokenize(self, text: str, offset: int) -> List[str]:
        words = text.split() if self.whitespace_split else [text]
        out = []
        for k, w in enumerate(words):
            w = w.replace(" ", self.replacement)
            if not w:
                continue
            first = offset == 0 and k == 0
            if not w.startswith(self.replacement) and (self.prepend == "always" or
                                                       (self.prepend == "first" and first)):
                w = self.replacement + w
            # Split before every replacement character (tokenizers' MergedWithNext).
            starts = [i for i, c in enumerate(w) if c == self.replacement and i > 0]
            bounds = [0] + starts + [len(w)]
            out += [w[a:b] for a, b in zip(bounds[:-1], bounds[1:]) if b > a]
        return out

    def _viterbi(self, word: str) -> List[int]:
        """The best-scoring segmentation of ``word`` (tokenizers' optimized
        unigram encode: the first candidate wins a tie), unknown runs fused."""
        n = len(word)
        best = [0.0] * (n + 1)
        start: List[Optional[int]] = [None] * (n + 1)
        ids = [0] * (n + 1)
        start[0] = 0
        for s in range(n):
            base = best[s]
            single = False
            for e in range(s + 1, min(n, s + self.max_piece) + 1):
                i = self.vocab.get(word[s:e])
                if i is None:
                    continue
                cand = base + self.scores[i]
                if start[e] is None or cand > best[e]:
                    best[e], start[e], ids[e] = cand, s, i
                single |= e == s + 1
            if not single:
                cand = base + self.unk_score
                if start[s + 1] is None or cand > best[s + 1]:
                    best[s + 1], start[s + 1], ids[s + 1] = cand, s, self.unk_id
        out, e, unk = [], n, False
        while e > 0:
            i = ids[e]
            if i == self.unk_id:
                if not unk:
                    out.append(i)
                unk = True
            else:
                out.append(i)
                unk = False
            e = start[e]
        return out[::-1]

    def encode(self, text: str) -> List[int]:
        """The ids of ``text`` without the suffix."""
        out = []
        for seg, offset, i in self._split_added(text):
            if i is not None:
                out.append(i)
                continue
            for f in self.normalizers:
                seg = f(seg)
            for word in self._pre_tokenize(seg, offset):
                out += self._viterbi(word)
        return out

    def __call__(self, prompts: Sequence[Optional[str]], maxlen: int) -> np.ndarray:
        """int64 [len(prompts), maxlen]: each prompt's ids truncated to leave
        room for the suffix, the suffix, then padding; ``None`` encodes as ""."""
        out = np.full((len(prompts), maxlen), self.pad_id, np.int64)
        keep = maxlen - len(self.suffix)
        for r, p in enumerate(prompts):
            ids = (self.encode(p if p is not None else "")[: max(keep, 0)] + self.suffix)[:maxlen]
            out[r, : len(ids)] = ids
        return out

    # -- loading

    @classmethod
    def from_sentencepiece(cls, path: str, extra_ids: int = EXTRA_IDS) -> "UnigramTokenizer":
        """The tokenizer ``transformers``' T5 converter builds from
        ``spiece.model``. As its ``SpmConverter`` does, it ignores the
        normalizer_spec's ``add_dummy_prefix``, ``remove_extra_whitespaces``
        and ``escape_whitespaces``: it always strips trailing whitespace,
        replaces runs of spaces by one ``▁``, pre-tokenizes with ``▁`` and
        prepends it ("always", the slow tokenizer's default
        ``add_prefix_space=True``)."""
        m = read_sentencepiece_model(path)
        if m["model_type"] != 1:
            raise ValueError(f"{path}: model_type {m['model_type']} is not unigram (1)")
        pieces = [(p, s) for p, s, _ in m["pieces"]]
        pieces += [(f"<extra_id_{i}>", 0.0) for i in range(extra_ids - 1, -1, -1)]
        added = {p: i for i, (p, _, t) in enumerate(m["pieces"]) if t in (CONTROL, USER_DEFINED)}
        added.update({p: i for i, (p, _) in enumerate(pieces) if p.startswith("<extra_id_")})
        norms = [PrecompiledCharsMap(m["precompiled_charsmap"])] if m["precompiled_charsmap"] else []
        norms += [_rstrip_spaces, _collapse_spaces]
        eos = next(i for i, (p, _) in enumerate(pieces) if p == "</s>")
        pad = m["pad_id"] if m["pad_id"] >= 0 else 0
        return cls(pieces, m["unk_id"], added, norms, prepend="always", suffix=[eos], pad_id=pad, replacement=SPACE)

    @classmethod
    def from_tokenizer_json(cls, path: str) -> "UnigramTokenizer":
        """HF's ``tokenizer.json`` with a Unigram model."""
        with open(path, encoding="utf-8") as f:
            spec = json.load(f)
        model = spec["model"]
        if model.get("type") != "Unigram":
            raise ValueError(f"{path}: model type {model.get('type')!r} is not Unigram")
        pieces = [(p, float(s)) for p, s in model["vocab"]]
        added = {t["content"]: t["id"] for t in spec.get("added_tokens", [])}
        for t in spec.get("added_tokens", []):
            if t.get("normalized") or t.get("lstrip") or t.get("rstrip") or t.get("single_word"):
                raise ValueError(f"{path}: added token {t['content']!r} needs options this tokenizer lacks")
        norms = _json_normalizers(spec.get("normalizer"))
        replacement, prepend, wsplit = _json_pre_tokenizer(spec.get("pre_tokenizer"))
        suffix = _json_suffix(spec.get("post_processor"))
        pad = added.get("<pad>", 0)
        return cls(pieces, model.get("unk_id", 0), added, norms, prepend=prepend, whitespace_split=wsplit,
                   suffix=suffix, pad_id=pad, replacement=replacement)


def _nfkc(s: str) -> str:
    return unicodedata.normalize("NFKC", s)


def _rstrip_spaces(s: str) -> str:
    """tokenizers' Strip(right): trailing whitespace."""
    return s.rstrip()


def _collapse_spaces(s: str) -> str:
    return re.sub(" {2,}", SPACE, s)


def _json_normalizers(spec) -> list:
    if spec is None:
        return []
    kind = spec["type"]
    if kind == "Sequence":
        return [f for s in spec["normalizers"] for f in _json_normalizers(s)]
    if kind == "Precompiled":
        return [PrecompiledCharsMap(base64.b64decode(spec["precompiled_charsmap"]))]
    if kind == "NFKC":
        return [_nfkc]
    if kind == "Strip":
        left, right = spec.get("strip_left", False), spec.get("strip_right", False)

        def strip(s: str) -> str:
            s = s.lstrip() if left else s
            return s.rstrip() if right else s

        return [strip]
    if kind == "Replace":
        pattern, content = spec["pattern"], spec["content"]
        rx = re.compile(pattern["Regex"] if "Regex" in pattern else re.escape(pattern["String"]))
        return [lambda s: rx.sub(lambda _: content, s)]
    raise ValueError(f"tokenizer.json normalizer {kind!r} is not supported")


def _json_pre_tokenizer(spec) -> Tuple[str, str, bool]:
    """(replacement, prepend scheme, whitespace split first)."""
    if spec is None:
        return " ", "never", False
    kinds = spec["pretokenizers"] if spec["type"] == "Sequence" else [spec]
    names = [k["type"] for k in kinds]
    if names not in (["Metaspace"], ["WhitespaceSplit", "Metaspace"]):
        raise ValueError(f"tokenizer.json pre-tokenizer {names} is not supported")
    meta = kinds[-1]
    if meta.get("split", True) is False:
        raise ValueError("tokenizer.json Metaspace without split is not supported")
    prepend = meta.get("prepend_scheme") or ("always" if meta.get("add_prefix_space", True) else "never")
    return meta.get("replacement", SPACE), prepend, names[0] == "WhitespaceSplit"


def _json_suffix(spec) -> List[int]:
    """The special-token ids a TemplateProcessing appends after the text."""
    if spec is None:
        return []
    if spec["type"] != "TemplateProcessing":
        raise ValueError(f"tokenizer.json post-processor {spec['type']!r} is not supported")
    single = spec["single"]
    if not single or "Sequence" not in single[0]:
        raise ValueError("tokenizer.json template must start with the text")
    out = []
    for item in single[1:]:
        name = item["SpecialToken"]["id"]
        out += spec["special_tokens"][name]["ids"]
    return out


def is_unigram_tokenizer_json(path: str) -> bool:
    with open(path, encoding="utf-8") as f:
        return (json.load(f).get("model") or {}).get("type") == "Unigram"


def find_tokenizer(model_dir: str) -> Optional[str]:
    """The file :func:`load` reads in ``model_dir``: a Unigram
    ``tokenizer.json`` (preferred, as ``transformers`` prefers it), else
    ``spiece.model``; None when there is neither."""
    path = os.path.join(model_dir, "tokenizer.json")
    if os.path.exists(path) and is_unigram_tokenizer_json(path):
        return path
    path = os.path.join(model_dir, "spiece.model")
    return path if os.path.exists(path) else None


def load(model_dir: str) -> UnigramTokenizer:
    path = find_tokenizer(model_dir)
    if path is None:
        raise FileNotFoundError(f"{model_dir}: no Unigram tokenizer.json and no spiece.model")
    if path.endswith(".json"):
        return UnigramTokenizer.from_tokenizer_json(path)
    return UnigramTokenizer.from_sentencepiece(path)
