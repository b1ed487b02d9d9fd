"""Extended grapheme clusters (Unicode Standard Annex #29) in plain Python.

The tokenizer's character map (models/tokenizer.py, SentencePiece's
``Precompiled`` normaliser as ``tokenizers`` applies it) looks text up one
extended grapheme cluster at a time, so the port cuts text where
``tokenizers`` does (its ``unicode-segmentation``) and where ``regex``'s
``\\X`` does, without either: the rules GB3-GB13, GB9c (Indic conjuncts)
included, over the property tables of :mod:`grapheme_table` (Unicode
:data:`UNICODE_VERSION`, written by ``scripts/gen_torch_grapheme_table.py``).
"""

from __future__ import annotations

from bisect import bisect_right
from functools import lru_cache
from typing import List, Tuple

from ttt_video_dit_torch.models import grapheme_table as table

UNICODE_VERSION = table.UNICODE_VERSION
(OTHER, CR, LF, CONTROL, EXTEND, ZWJ, RI, PREPEND, SPACING_MARK, L, V, T, LV, LVT,
 SYLLABLE) = range(len(table.GCB_NAMES))
INCB_CONSONANT, INCB_EXTEND, INCB_LINKER = (table.INCB_NAMES.index(n) for n in ("Consonant", "Extend", "Linker"))
_BREAKS_AROUND = (CR, LF, CONTROL)  # GB4, GB5


@lru_cache(maxsize=8192)
def properties(ch: str) -> Tuple[int, bool, int]:
    """(Grapheme_Cluster_Break, Extended_Pictographic, InCB) of one character."""
    cp = ord(ch)
    gcb = table.GCB_VALUES[bisect_right(table.GCB_STARTS, cp) - 1]
    if gcb == SYLLABLE:
        gcb = LV if (cp - 0xAC00) % 28 == 0 else LVT
    pict = bisect_right(table.EXT_PICT_STARTS, cp) % 2 == 1
    return gcb, pict, table.INCB_VALUES[bisect_right(table.INCB_STARTS, cp) - 1]


def clusters(text: str) -> List[str]:
    """``text`` cut into its extended grapheme clusters."""
    out: List[str] = []
    start = 0
    ri = 0  # regional indicators ending at the previous character
    pict = False  # the text so far ends in Extended_Pictographic Extend* (GB11)
    pict_zwj = False  # ... or in Extended_Pictographic Extend* ZWJ
    conjunct = 0  # 1: it ends in InCB Consonant [Extend Linker]*; 2: with a Linker among them (GB9c)
    prev = None
    for i, ch in enumerate(text):
        gcb, is_pict, incb = properties(ch)
        if prev is not None and _breaks(prev, gcb, is_pict, incb, ri, pict_zwj, conjunct):
            out.append(text[start:i])
            start = i
        ri = ri + 1 if gcb == RI else 0
        pict_zwj = pict and gcb == ZWJ
        pict = is_pict or (pict and gcb == EXTEND)
        if incb == INCB_CONSONANT:
            conjunct = 1
        elif conjunct and incb == INCB_LINKER:
            conjunct = 2
        elif incb != INCB_EXTEND:
            conjunct = 0
        prev = gcb
    if text:
        out.append(text[start:])
    return out


def _breaks(prev: int, gcb: int, is_pict: bool, incb: int, ri: int, pict_zwj: bool, conjunct: int) -> bool:
    """Whether a cluster ends between a character of break property ``prev`` and the next one."""
    if prev == CR and gcb == LF:  # GB3
        return False
    if prev in _BREAKS_AROUND or gcb in _BREAKS_AROUND:  # GB4, GB5
        return True
    if prev == L and gcb in (L, V, LV, LVT):  # GB6
        return False
    if prev in (LV, V) and gcb in (V, T):  # GB7
        return False
    if prev in (LVT, T) and gcb == T:  # GB8
        return False
    if gcb in (EXTEND, ZWJ, SPACING_MARK) or prev == PREPEND:  # GB9, GB9a, GB9b
        return False
    if conjunct == 2 and incb == INCB_CONSONANT:  # GB9c
        return False
    if pict_zwj and is_pict:  # GB11
        return False
    if prev == RI and gcb == RI and ri % 2 == 1:  # GB12, GB13
        return False
    return True  # GB999
