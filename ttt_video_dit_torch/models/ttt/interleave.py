"""Interleaved text/video sequence layout for the global TTT scan (port of
ttt_video_dit_tpu/models/ttt/interleave.py).

The DiT keeps the sequence as [all text scenes || all video tokens]; the TTT
scan wants [text_0, video_0, text_1, video_1, ...] so the fast weights see
each scene's prompt right before its frames. The first scene absorbs the
remainder frames. With ``reverse=True`` the reverse-direction prep (text
scenes in reverse order, video token-flipped) is composed into the same
permutation. Both directions are one index gather over the token axis (-2),
with the index built once per (SequenceMetadata, direction, device).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ttt_video_dit_torch.models.sequence import SequenceMetadata


def _interleave_order(meta: SequenceMetadata, reverse: bool) -> np.ndarray:
    """Source token index of every output slot of interleave(x, meta, reverse)."""
    stl = meta.seq_text_length
    L = stl + meta.num_video_tokens
    text, video = np.arange(stl), np.arange(stl, L)
    if not meta.is_multiscene:
        return np.concatenate([text, video[::-1] if reverse else video])
    TL, C = meta.text_length, meta.num_chunks
    Lv = L - stl
    video_init = meta.init_offset - TL  # video tokens in the first scene
    video_base = meta.base_offset - TL  # video tokens per later scene
    pieces = []
    for i in range(C):
        ti = (C - 1 - i) if reverse else i
        n = video_init if i == 0 else video_base
        start = 0 if i == 0 else video_init + (i - 1) * video_base
        # Scene i of the reversed layout holds flip(video)[start:start+n].
        v = video[Lv - start - n : Lv - start][::-1] if reverse else video[start : start + n]
        pieces += [text[ti * TL : (ti + 1) * TL], v]
    return np.concatenate(pieces)


@functools.lru_cache(maxsize=64)
def _index(meta: SequenceMetadata, reverse: bool, inverse: bool, device: torch.device) -> torch.Tensor:
    """The gather index on ``device`` (read-only: shared by every caller; a
    normal tensor even when first built under inference mode, so that
    training after sampling in one process can save it for backward)."""
    order = _interleave_order(meta, reverse)
    if inverse:
        order = np.argsort(order)
    with torch.inference_mode(False):
        return torch.from_numpy(order.astype(np.int64)).to(device)


def interleave(x, meta: SequenceMetadata, reverse: bool = False):
    """[..., L, E] in [text_0..text_{C-1}, video] layout -> the TTT scan order
    (with the reverse-direction prep composed in when ``reverse``)."""
    if not (meta.is_multiscene or reverse):
        return x
    return x.index_select(-2, _index(meta, reverse, False, x.device))


def undo_interleave(x, meta: SequenceMetadata, reverse: bool = False):
    """Inverse of :func:`interleave` for the same ``reverse`` flag: back to
    the original [text_0..text_{C-1}, video] layout."""
    if not (meta.is_multiscene or reverse):
        return x
    return x.index_select(-2, _index(meta, reverse, True, x.device))


def reverse_text_chunks(text, num_chunks: int):
    """Reverse the order of the per-scene text blocks of [B, L, E], keeping
    the token order within a scene: the text that mirrors the reversed video
    of the reverse TTT direction (reference: ttt/models/cogvideo/dit.py:213-217)."""
    B, L, E = text.shape
    return text.reshape(B, num_chunks, L // num_chunks, E).flip(1).reshape(B, L, E)
