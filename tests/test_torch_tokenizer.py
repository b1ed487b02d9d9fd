"""The port's T5 tokenizer (ttt_video_dit_torch/models/tokenizer.py) against
``transformers``, through the JAX package's own ``_tokenize(_load_tokenizer(dir))``
(ttt_video_dit_tpu/models/t5.py:36-56), on fabricated unigram vocabularies
written two ways:

- ``tokenizer.json``: a ``tokenizers.models.Unigram`` (T5's pieces, then its
  100 extra ids counting down) wrapped in ``transformers.T5TokenizerFast`` and
  saved with ``save_pretrained``, its normaliser T5's: a ``Precompiled``
  character map (or NFKC), a right strip and the ``" {2,}"`` replace;
- ``spiece.model``: a ``ModelProto`` built with the protobuf classes that
  ``transformers`` bundles. Without ``sentencepiece`` on this host,
  ``AutoTokenizer`` cannot build the slow tokenizer it converts, so the test
  hands ``transformers``' own ``T5Converter`` the file (it reads it with
  protobuf) in place of that conversion; the converter is not patched
  otherwise.

Both carry a precompiled character map built here from a dict of rules
(chip_smoke.py's darts-clone writer, :func:`_charsmap`), which
``tokenizers``' ``Precompiled`` reads; one case writes an ``nmt_nfkc``
``spiece.model`` without a map, which ``transformers`` normalises with no
NFKC. Ids must be equal, exactly.
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")
pytest.importorskip("tokenizers")
pytest.importorskip("google.protobuf")

from ttt_video_dit_torch.models import t5 as port_t5  # noqa: E402
from ttt_video_dit_torch.models import tokenizer as port_tok  # noqa: E402
from ttt_video_dit_torch.models.dit.sampler import SCENE_END_TOKEN, SCENE_START_TOKEN  # noqa: E402

import chip_smoke  # noqa: E402

torch.set_num_threads(1)
ROUTES = ["tokenizer_json", "spiece_model"]
BLOCKED = ("transformers", "tokenizers", "sentencepiece", "google.protobuf", "google", "regex")
# The fabricated vocabularies' character map: chip_smoke.py's rules (whitespace and control characters, the
# zero-width space, fullwidth letters) and rules for ligatures, decomposed accents, the variation selector,
# a regional indicator, a compatibility jamo, Hangul jamo pairs (6 bytes: never looked up whole) and the
# prefixes of longer keys (Ａ before Ａ + U+0301).
RULES = {**chip_smoke.CHARSMAP_RULES, "ﬁ": "fi", "ﬂ": "fl", "e\u0301": "é", "a\u0301": "á", "\ufe0f": "",
         "\u3000": " ", "Ａ\u0301": "Á", "\U0001F1FA": "U", "\u3131": "\u1100", "\u1100\u1161": "가", "Ⅳ": "IV"}
WORDS = ["the", "cat", "walk", "walks", "kitchen", "sun", "lit", "sunlit", "food", "look", "ing", "for", "through",
         "orange", "fluffy", "a", "an", "in", "on", "of", "and", "scene", "fi", "fine", "café", "dog", "runs", "park",
         "rain", "bow", "rainbow", "over", "city", "night", "light", "s"]
CHARS = "abcdefghijklmnopqrstuvwxyzéèàçñüö,.!?'-0123456789ABCDEFGT"
# Prompt groups: each is one test case per route.
PROMPTS = {
    "plain": ["A fluffy orange cat walks through a sunlit kitchen, looking for food.", "the dog runs in the park"],
    "whitespace": ["  the   cat  ", " x", "a  b   c    d", "   ", "the cat 　 walks"],
    "empty_and_none": ["", None, "the"],
    "overlong": [" ".join(["the cat walks through the rainbow"] * 8)],
    "multiscene": [f"the cat walks{SCENE_END_TOKEN}", f"{SCENE_START_TOKEN}a dog runs{SCENE_END_TOKEN}",
                   f"{SCENE_START_TOKEN} rain over the city", f"a {SCENE_END_TOKEN}   {SCENE_START_TOKEN} b",
                   f"{SCENE_END_TOKEN}{SCENE_START_TOKEN}"],
    "ascii": ["Night light!", "GATE 42, fine?", "it's a-ok"],
    "latin_accents": ["café crème", "niño über öl", "e\u0301te\u0301"],  # the last decomposed: NFKC composes it
    "full_width": ["Ｃａｔ ｗａｌｋｓ", "ＡＢＣ１２"],
    "ligatures": ["ﬁne ﬂow", "Ⅳ ½ ™ ㎏"],  # fi, fl ligatures; IV, 1/2, TM, kg
    "extra_ids": ["<extra_id_0> the <extra_id_99>", "a<extra_id_7>b", "<extra_id_100>"],
    "unknown": ["q#w##", "世界 cat", "a\tb"],
    # The character map's cases (the first four lie where NFKC alone gave other ids).
    "newlines_and_tabs": ["a\nb", "x\ty", "a\rb", "a\r\nb", "the cat\nwalks\n\n", "\tthe\t cat"],
    "control_characters": ["a\x01b", "\x07the\x1f cat\x7f", "\x00a"],
    "zero_width_space": ["a\u200bb", "the\u200b cat", "\u200b"],
    "short_cluster": ["Ａ\u0301", "Ａ\u0301Ｂ", "a\u0301", "ｃａｆe\u0301"],  # under 6 bytes: replaced whole
    "long_cluster": ["Ａ\u0301\u0301", "e\u0301\u0301\u0301", "a\u0301\u0308"],  # 6 bytes or more: per code point
    "emoji": ["a 👨\u200d👩\u200d👧 b", "❤\ufe0f cat", "1\ufe0f", "👍🏽"],
    "regional_indicators": ["🇺🇸 city", "🇺 a", "🇺🇸🇺"],
    "hangul": ["가 ㄱ", "\u1100\u1161 cat", "한국 cat", "\u1100\u1161\u11a8"],
}
MAXLEN = {"overlong": 17, "multiscene": 9}


def _pieces(seed=0):
    """(piece, score, type): the three T5 control/unknown pieces, then every
    char and word with and without the ``▁`` prefix, float32 scores."""
    rng = np.random.default_rng(seed)
    v = {"▁"}
    for w in list(CHARS) + WORDS:
        v |= {w, "▁" + w}
    out = [("<pad>", 0.0, 3), ("</s>", 0.0, 3), ("<unk>", 0.0, 2)]
    return out + [(p, float(np.float32(-rng.uniform(1, 12))), 1) for p in sorted(v)]


def _write_spiece(d, pieces, **normalizer):
    from transformers.utils import sentencepiece_model_pb2_new as pb

    m = pb.ModelProto()
    for p, s, t in pieces:
        sp = m.pieces.add()
        sp.piece, sp.score, sp.type = p, s, t
    m.trainer_spec.model_type = 1
    m.trainer_spec.unk_id, m.trainer_spec.bos_id, m.trainer_spec.eos_id, m.trainer_spec.pad_id = 2, -1, 1, 0
    m.normalizer_spec.name = "nmt_nfkc"
    for k, v in normalizer.items():  # precompiled_charsmap=blob gives it a character map
        setattr(m.normalizer_spec, k, v)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "spiece.model"), "wb") as f:
        f.write(m.SerializeToString())
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "t5"}, f)
    return d


def _charsmap(rules=None) -> bytes:
    """A precompiled character map of ``rules`` (default RULES): chip_smoke.py's darts-clone writer."""
    return chip_smoke.precompiled_charsmap(RULES if rules is None else rules)


def _write_tokenizer_json(d, pieces, prepend_scheme="always", whitespace_split=False, charsmap=None):
    """T5's tokenizer.json: a Precompiled normaliser of ``charsmap`` first, or NFKC without one."""
    from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
    from transformers import T5TokenizerFast

    vocab = [(p, s) for p, s, _ in pieces] + [(f"<extra_id_{i}>", 0.0) for i in range(99, -1, -1)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    first = normalizers.Precompiled(charsmap) if charsmap else normalizers.NFKC()
    tok.normalizer = normalizers.Sequence([first, normalizers.Strip(left=False, right=True),
                                           normalizers.Replace(Regex(" {2,}"), "▁")])
    meta = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme=prepend_scheme)
    tok.pre_tokenizer = pre_tokenizers.Sequence([pre_tokenizers.WhitespaceSplit(), meta]) if whitespace_split else meta
    tok.post_processor = processors.TemplateProcessing(single=["$A", "</s>"], pair=["$A", "</s>", "$B", "</s>"],
                                                       special_tokens=[("</s>", 1)])
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True) for t in ("<pad>", "</s>", "<unk>")])
    hf = T5TokenizerFast(tokenizer_object=tok, extra_ids=100, eos_token="</s>", unk_token="<unk>", pad_token="<pad>")
    hf.save_pretrained(d)
    return d


@pytest.fixture
def converter_for_spiece(monkeypatch):
    """Let ``AutoTokenizer`` load a ``spiece.model`` directory without
    ``sentencepiece``: ``transformers``' T5 converter reads the file with
    protobuf, as it would after building the slow tokenizer."""
    from transformers import tokenization_utils_fast
    from transformers.convert_slow_tokenizer import T5Converter

    class Slow:
        _extra_ids, legacy = 100, True

        def __init__(self, path):
            self.vocab_file = path

        def convert_tokens_to_ids(self, token):
            return {"</s>": 1}[token]

    def convert(fast, from_tiktoken=False):
        return T5Converter(Slow(fast.vocab_file)).converted()

    monkeypatch.setattr(tokenization_utils_fast, "convert_slow_tokenizer", convert)


def _directory(tmp_path, route, **kw):
    """The fabricated vocabulary with RULES' character map, written the ``route``'s way."""
    d, blob = str(tmp_path / route), _charsmap()
    if route == "spiece_model":
        return _write_spiece(d, _pieces(), precompiled_charsmap=blob)
    return _write_tokenizer_json(d, _pieces(), charsmap=blob, **kw)


def _jax_ids(d, prompts, maxlen):
    from ttt_video_dit_tpu.models.t5 import _load_tokenizer, _tokenize

    tok = _load_tokenizer(d)
    return np.asarray(_tokenize(tok, prompts, maxlen), np.int64), len(tok)


@pytest.mark.parametrize("group", sorted(PROMPTS))
@pytest.mark.parametrize("route", ROUTES)
def test_ids_match_the_jax_tokenize(tmp_path, converter_for_spiece, route, group):
    """Ids, truncation to maxlen - 1 plus </s>, right padding, the scene and
    extra-id tokens, unknown characters and the character map's cases: port
    == JAX's ``_tokenize(_load_tokenizer(dir))`` on the same directory."""
    d = _directory(tmp_path, route)
    maxlen = MAXLEN.get(group, 24)
    want, n = _jax_ids(d, PROMPTS[group], maxlen)
    tok = port_t5._load_tokenizer(d)
    assert isinstance(tok, port_tok.UnigramTokenizer)
    got = tok(PROMPTS[group], maxlen)
    assert got.dtype == np.int64 and got.shape == (len(PROMPTS[group]), maxlen)
    np.testing.assert_array_equal(got, want)
    assert len(tok) == n == len(_pieces()) + 100 + 2
    if group == "overlong":
        assert got[0, -1] == 1 and (got[0] != 0).all()  # truncated, then </s>
    if group == "multiscene":
        assert {len(_pieces()) + 100, len(_pieces()) + 101} <= set(got.ravel().tolist())
    if group == "extra_ids":
        assert got[0, 0] == len(_pieces()) + 99  # <extra_id_0> is the last of the hundred


@pytest.mark.parametrize("pre", [("first", False), ("never", False), ("always", True)],
                         ids=["prepend_first", "prepend_never", "whitespace_split"])
def test_tokenizer_json_pre_tokenizer_variants(tmp_path, pre):
    """The Metaspace prepend schemes and the older WhitespaceSplit + Metaspace pre-tokenizer."""
    d = _write_tokenizer_json(str(tmp_path / "tj"), _pieces(1), prepend_scheme=pre[0], whitespace_split=pre[1])
    prompts = [p for group in ("plain", "whitespace", "multiscene", "empty_and_none") for p in PROMPTS[group]]
    want, _ = _jax_ids(d, prompts, 20)
    np.testing.assert_array_equal(port_t5._load_tokenizer(d)(prompts, 20), want)


# normalizer_spec flags set false; transformers' converter ignores them all (SpmConverter.normalizer and
# .converted: the right strip, the " {2,}" replace, "▁" and the "always" prepend scheme whatever they say).
FLAGS = {"no_dummy_prefix": dict(add_dummy_prefix=False), "keep_whitespace": dict(remove_extra_whitespaces=False),
         "neither": dict(add_dummy_prefix=False, remove_extra_whitespaces=False),
         "no_escape": dict(escape_whitespaces=False)}
# Runs of spaces, leading and trailing spaces, whitespace the map turns into spaces.
SPACES = ["the  cat ", "  the cat   ", "a \t b  ", "the\u3000 cat", " "]


@pytest.mark.parametrize("flags", list(FLAGS.values()), ids=list(FLAGS))
def test_spiece_normalizer_flags_are_read(tmp_path, converter_for_spiece, flags):
    """The normalizer_spec flags, read from the wire, and then ignored as
    ``transformers``' converter ignores them: on a ``spiece.model`` that sets
    them false, the ids of every prompt group equal the JAX package's
    ``_tokenize`` on the same file."""
    d = _write_spiece(str(tmp_path / "sp"), _pieces(), precompiled_charsmap=_charsmap(), **flags)
    m = port_tok.read_sentencepiece_model(os.path.join(d, "spiece.model"))
    assert all(m[k] == v for k, v in flags.items())
    tok = port_t5._load_tokenizer(d)
    for group, prompts in [*PROMPTS.items(), ("spaces", SPACES)]:
        maxlen = MAXLEN.get(group, 24)
        want, _ = _jax_ids(d, prompts, maxlen)
        np.testing.assert_array_equal(tok(prompts, maxlen), want, err_msg=group)


def test_wire_reader_matches_protobuf(tmp_path):
    """read_sentencepiece_model against protobuf's own parse, negative ids
    (two's-complement varints) and absent fields (proto2 defaults) included."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    d = _write_spiece(str(tmp_path / "sp"), _pieces(2), escape_whitespaces=False, precompiled_charsmap=b"\x00\x01")
    path = os.path.join(d, "spiece.model")
    got = port_tok.read_sentencepiece_model(path)
    m = pb.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    assert got["pieces"] == [(p.piece, p.score, p.type) for p in m.pieces]
    for k in ("model_type", "unk_id", "pad_id"):
        assert got[k] == getattr(m.trainer_spec, k), k
    assert got["pad_id"] == 0 and got["unk_id"] == 2
    for k in ("name", "precompiled_charsmap", "add_dummy_prefix", "remove_extra_whitespaces", "escape_whitespaces"):
        assert got[k] == getattr(m.normalizer_spec, k), k
    m = pb.ModelProto()
    m.trainer_spec.pad_id = -1
    bare = tmp_path / "bare.model"
    bare.write_bytes(m.SerializeToString())
    got = port_tok.read_sentencepiece_model(str(bare))
    assert (got["pad_id"], got["unk_id"], got["add_dummy_prefix"], got["escape_whitespaces"]) == (-1, 0, True, True)


def test_a_wordlevel_tokenizer_json_is_refused(tmp_path):
    """A tokenizer.json that is not Unigram is not a T5 tokenizer: the port
    finds none in its directory and says so."""
    from tokenizers import Tokenizer
    from tokenizers.models import WordLevel

    Tokenizer(WordLevel({"<pad>": 0, "a": 1}, unk_token="<pad>")).save(str(tmp_path / "tokenizer.json"))
    assert port_tok.find_tokenizer(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError, match="no Unigram tokenizer.json and no spiece.model"):
        port_t5._load_tokenizer(str(tmp_path))


def _tiny_t5(d, vocab):
    """config.json and model.safetensors (the port's writer) of a tiny T5 encoder beside the tokenizer."""
    from dataclasses import asdict

    from ttt_video_dit_torch.utils import safetensors

    cfg = port_t5.T5Config(vocab_size=vocab, d_model=16, d_kv=4, d_ff=32, num_layers=2, num_heads=4,
                           relative_attention_num_buckets=8, relative_attention_max_distance=20,
                           feed_forward_proj="gated-gelu")
    enc = port_t5.T5Encoder(cfg).init_weights_(torch.Generator().manual_seed(0))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({**asdict(cfg), "model_type": "t5"}, f)
    safetensors.save_file(enc.state_dict(), os.path.join(d, "model.safetensors"))


@pytest.mark.parametrize("route", ROUTES)
def test_encode_runs_with_transformers_blocked(tmp_path, converter_for_spiece, monkeypatch, route):
    """With transformers, tokenizers, sentencepiece, google.protobuf and
    regex blocked from import, T5TextEncoder.encode turns storyboard text
    (the character map's cases among it) into the JAX package's ids and
    encodes them as encode_ids does."""
    d = _directory(tmp_path, route)
    _tiny_t5(d, len(_pieces()) + 100)
    prompts = PROMPTS["multiscene"] + PROMPTS["plain"] + PROMPTS["newlines_and_tabs"] + ["Ａ\u0301 a\u200bb", None]
    want, _ = _jax_ids(d, prompts, 16)
    for name in BLOCKED:
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import transformers  # noqa: F401
    enc = port_t5.T5TextEncoder(d)
    got = enc.encode(prompts, 16)
    np.testing.assert_array_equal(enc.tokenizer(prompts, 16), want)
    assert got.shape == (len(prompts), 16, 16) and torch.isfinite(got).all()
    assert enc.model.shared.weight.shape[0] == len(_pieces()) + 102  # the two scene rows
    assert torch.equal(got, enc.encode_ids(want))


def test_chip_smoke_spiece_writer_reads_back(tmp_path, converter_for_spiece):
    """chip_smoke.py's wire-format writer (no protobuf on the card's machine)
    writes a spiece.model, with its character map, that protobuf parses, the
    port reads back, and ``transformers`` tokenises as the port does."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    path = str(tmp_path / "spiece.model")
    pieces = chip_smoke.fabricated_spiece(path, size=600, seed=3)
    m = pb.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    assert [(p.piece, p.score, p.type) for p in m.pieces] == pieces
    assert (m.trainer_spec.unk_id, m.trainer_spec.eos_id, m.trainer_spec.pad_id) == (2, 1, 0)
    assert m.normalizer_spec.precompiled_charsmap == chip_smoke.precompiled_charsmap(chip_smoke.CHARSMAP_RULES)
    tok = port_tok.load(str(tmp_path))
    assert len(tok) == 600 + 100
    ids = tok.encode("a fluffy orange cat walks through a sunlit kitchen")
    assert ids and 2 not in ids  # every character has a piece
    with open(tmp_path / "config.json", "w") as f:
        json.dump({"model_type": "t5"}, f)
    prompts = ["a fluffy orange cat\nwalks", "a\u200bb ab", "the\tcat\r\n", "Ｃａｔ\x07 １２", "a\nb a b"]
    want, _ = _jax_ids(str(tmp_path), prompts, 32)
    np.testing.assert_array_equal(tok(prompts, 32), want)
    assert tok.encode("a\nb") == tok.encode("a b") and tok.encode("a\u200bb") == tok.encode("ab")


def test_an_nmt_nfkc_spiece_model_without_a_map_applies_no_nfkc(tmp_path, converter_for_spiece):
    """An ``nmt_nfkc`` spiece.model that carries no character map: the
    reference normalises it with no NFKC (SpmConverter.normalizer), so
    fullwidth letters, ligatures, decomposed accents and newlines keep their
    own ids, as in the port."""
    d = _write_spiece(str(tmp_path / "sp"), _pieces())
    prompts = PROMPTS["full_width"] + PROMPTS["ligatures"] + PROMPTS["latin_accents"] + PROMPTS["newlines_and_tabs"]
    want, _ = _jax_ids(d, prompts, 24)
    np.testing.assert_array_equal(port_t5._load_tokenizer(d)(prompts, 24), want)
    assert port_tok.load(d).normalizers[0] is port_tok._rstrip_spaces  # no character map, no NFKC


# Code point ranges of the random strings: ASCII, C0 and C1 controls, combining marks, Hangul jamo and
# syllables, regional indicators, emoji and skin tones, the zero-width characters, variation selectors,
# Devanagari consonants, nukta and virama (GB9c), Arabic prepended marks, Devanagari spacing marks, fullwidth
# forms, ligatures, the Thai block, and the map's own keys.
RANGES = [(0x20, 0x7E), (0x01, 0x1F), (0x7F, 0x9F), (0x300, 0x36F), (0x1100, 0x1112), (0x1161, 0x1175),
          (0x11A8, 0x11C2), (0xAC00, 0xAC40), (0x1F1E6, 0x1F1FF), (0x1F600, 0x1F64F), (0x1F3FB, 0x1F3FF),
          (0x200B, 0x200D), (0xFE00, 0xFE0F), (0x915, 0x939), (0x93C, 0x94D), (0x600, 0x605), (0x900, 0x903),
          (0xFF01, 0xFF5E), (0xFB00, 0xFB06), (0xE01, 0xE3A), (0x3131, 0x3133), (0x2160, 0x2163)]


def _random_texts(seed: int, n: int = 200) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        picks = rng.integers(0, len(RANGES), int(rng.integers(1, 13)))
        out.append("".join(chr(int(rng.integers(RANGES[i][0], RANGES[i][1] + 1))) for i in picks))
    return out


def test_grapheme_clusters_match_regex():
    """The port's segmenter (models/graphemes.py, plain Python) against
    ``regex``'s ``\\X`` on 200 seeded strings drawn from RANGES and on the
    rules' edge cases: CR LF, Hangul L V T, emoji ZWJ sequences, regional
    indicator pairs, prepended marks, Indic conjuncts (GB9c)."""
    regex = pytest.importorskip("regex")
    from ttt_video_dit_torch.models import graphemes

    edges = ["a\r\nb\n\r", "\u1100\u1161\u11a8\uac00\u11a8", "👨\u200d👩\u200d👧x", "🇺🇸🇺🇸🇺", "\u0600a",
             "क\u094d\u0937", "क\u093c\u094d\u200dष", "a\u0903\u0301", ""]
    for text in _random_texts(0) + edges:
        assert graphemes.clusters(text) == regex.findall(r"\X", text), [hex(ord(c)) for c in text]
    assert graphemes.UNICODE_VERSION == "17.0.0"


def test_character_map_matches_tokenizers_precompiled():
    """The port's PrecompiledCharsMap against ``tokenizers``'
    ``Precompiled(blob).normalize_str`` on 200 seeded strings drawn from
    RANGES, with RULES' map; a blob too short for its trie is refused."""
    from tokenizers import normalizers

    blob = _charsmap()
    want, port = normalizers.Precompiled(blob), port_tok.PrecompiledCharsMap(blob)
    for text in _random_texts(1) + ["\x00a\x01", "Ａ\u0301", "Ａ\u0301\u0301", "\r\n"]:
        assert port(text) == want.normalize_str(text), [hex(ord(c)) for c in text]
    for bad in (b"", blob[:-len(blob) // 2]):
        with pytest.raises(ValueError):
            port_tok.PrecompiledCharsMap(bad)
