"""Write ttt_video_dit_torch/models/grapheme_table.py: the Unicode properties
that extended grapheme clusters (Unicode Standard Annex #29) are cut by, as
range tables, for the port's tokenizer (models/graphemes.py), which must run
where neither ``regex`` nor ``tokenizers`` is installed.

The properties are read from the ``regex`` package: Grapheme_Cluster_Break,
Extended_Pictographic and Indic_Conjunct_Break (InCB, for rule GB9c). The
Hangul syllables U+AC00..U+D7A3 are one run in the table: a syllable is LV
when (code point - 0xAC00) % 28 == 0, else LVT, which this script checks
against ``regex`` for every syllable. Run it on a host that has ``regex``
(the table's Unicode version is that of the ``regex`` release, named in
UNICODE_VERSIONS):

    python scripts/gen_torch_grapheme_table.py [--out PATH]
"""

from __future__ import annotations

import argparse
import os

import regex

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "ttt_video_dit_torch", "models", "grapheme_table.py")
# The Unicode version of each regex release this script has been run with.
UNICODE_VERSIONS = {"2026.7.19": "17.0.0"}
# Grapheme_Cluster_Break values in the table's numbering; SYLLABLE stands for the Hangul LV / LVT block.
GCB = ("Other", "CR", "LF", "Control", "Extend", "ZWJ", "Regional_Indicator", "Prepend", "SpacingMark", "L", "V",
       "T", "LV", "LVT", "SYLLABLE")
INCB = ("None", "Consonant", "Extend", "Linker")
SYLLABLES = (0xAC00, 0xD7A4)
N = 0x110000


def runs(values: bytearray) -> tuple[list[int], list[int]]:
    """(starts, values) of the maximal runs of equal values."""
    starts, vals = [0], [values[0]]
    for cp in range(1, N):
        if values[cp] != vals[-1]:
            starts.append(cp)
            vals.append(values[cp])
    return starts, vals


def table(chars: str, prop: str, names: tuple) -> bytearray:
    out = bytearray(N)
    for i, name in enumerate(names):
        if i == 0 or name == "SYLLABLE":
            continue
        for m in regex.finditer(r"\p{%s=%s}+" % (prop, name), chars):
            out[m.start() : m.end()] = bytes([i]) * (m.end() - m.start())
    return out


def tuple_lines(name: str, values) -> str:
    lines, line = [], "    "
    for v in values:
        item = f"{v!r},"
        if len(line) + len(item) + 1 > 100:
            lines.append(line.rstrip())
            line = "    "
        line += item + " "
    lines.append(line.rstrip())
    return f"{name} = (\n" + "\n".join(lines) + "\n)\n"


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()
    version = UNICODE_VERSIONS.get(regex.__version__)
    if version is None:
        raise SystemExit(f"regex {regex.__version__}: add its Unicode version to UNICODE_VERSIONS first")
    chars = "".join(map(chr, range(N)))
    gcb = table(chars, "Grapheme_Cluster_Break", GCB)
    lv, lvt = GCB.index("LV"), GCB.index("LVT")
    for cp in range(*SYLLABLES):
        assert gcb[cp] == (lv if (cp - SYLLABLES[0]) % 28 == 0 else lvt), hex(cp)
    assert lv not in gcb[: SYLLABLES[0]] + gcb[SYLLABLES[1] :] and lvt not in gcb[: SYLLABLES[0]] + gcb[SYLLABLES[1] :]
    gcb[SYLLABLES[0] : SYLLABLES[1]] = bytes([GCB.index("SYLLABLE")]) * (SYLLABLES[1] - SYLLABLES[0])
    pict = bytearray(N)
    for m in regex.finditer(r"\p{Extended_Pictographic}+", chars):
        pict[m.start() : m.end()] = b"\1" * (m.end() - m.start())
    incb = table(chars, "InCB", INCB)
    gcb_starts, gcb_values = runs(gcb)
    pict_starts, pict_values = runs(pict)
    incb_starts, incb_values = runs(incb)
    assert pict_values[0] == 0 and all(a != b for a, b in zip(pict_values, pict_values[1:]))
    text = (
        f'"""Unicode {version} properties of extended grapheme clusters (UAX #29), as\n'
        f"range tables: generated by scripts/gen_torch_grapheme_table.py from regex\n"
        f'{regex.__version__}; do not edit by hand.\n\n'
        "A property's value at code point c is VALUES[bisect_right(STARTS, c) - 1].\n"
        "Grapheme_Cluster_Break values are indices into GCB_NAMES; SYLLABLE is the\n"
        "Hangul block U+AC00..U+D7A3 (LV where (c - 0xAC00) % 28 == 0, else LVT).\n"
        "EXT_PICT_STARTS alternate: Extended_Pictographic from an even index's start,\n"
        "not from an odd one's. InCB values are indices into INCB_NAMES.\n"
        '"""\n\n'
        f'UNICODE_VERSION = "{version}"\n'
        + tuple_lines("GCB_NAMES", GCB) + tuple_lines("INCB_NAMES", INCB)
        + tuple_lines("GCB_STARTS", gcb_starts) + tuple_lines("GCB_VALUES", gcb_values)
        + tuple_lines("EXT_PICT_STARTS", pict_starts[1:])
        + tuple_lines("INCB_STARTS", incb_starts) + tuple_lines("INCB_VALUES", incb_values)
    )
    with open(args.out, "w", encoding="utf-8") as f:
        f.write(text)
    print(f"{args.out}: Unicode {version}, {len(gcb_starts)} Grapheme_Cluster_Break runs, {len(pict_starts) - 1} "
          f"Extended_Pictographic boundaries, {len(incb_starts)} InCB runs")


if __name__ == "__main__":
    main()
