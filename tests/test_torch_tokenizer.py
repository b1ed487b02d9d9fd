"""The port's T5 tokenizer (ttt_video_dit_torch/models/tokenizer.py) against
``transformers``, through the JAX package's own ``_tokenize(_load_tokenizer(dir))``
(ttt_video_dit_tpu/models/t5.py:36-56), on fabricated unigram vocabularies
written two ways:

- ``tokenizer.json``: a ``tokenizers.models.Unigram`` (T5's pieces, then its
  100 extra ids counting down) wrapped in ``transformers.T5TokenizerFast`` and
  saved with ``save_pretrained``;
- ``spiece.model``: a ``ModelProto`` built with the protobuf classes that
  ``transformers`` bundles. Without ``sentencepiece`` on this host,
  ``AutoTokenizer`` cannot build the slow tokenizer it converts, so the test
  hands ``transformers``' own ``T5Converter`` the file (it reads it with
  protobuf) in place of that conversion.

A fabricated ``spiece.model`` carries no precompiled character map (building
one needs SentencePiece's trainer); the reference gets NFKC in its place when
the normaliser's name says ``nmt_nfkc``, which is what the port reproduces
for a ``Precompiled`` map. Ids must be equal, exactly.
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

torch.set_num_threads(1)
ROUTES = ["tokenizer_json", "spiece_model"]
BLOCKED = ("transformers", "tokenizers", "sentencepiece", "google.protobuf", "google")
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
    for k, v in normalizer.items():
        setattr(m.normalizer_spec, k, v)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "spiece.model"), "wb") as f:
        f.write(m.SerializeToString())
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"model_type": "t5"}, f)
    return d


def _write_tokenizer_json(d, pieces, prepend_scheme="always", whitespace_split=False):
    from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers, processors
    from transformers import T5TokenizerFast

    vocab = [(p, s) for p, s, _ in pieces] + [(f"<extra_id_{i}>", 0.0) for i in range(99, -1, -1)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.normalizer = normalizers.Sequence([normalizers.NFKC(), normalizers.Strip(left=False, right=True),
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
    from tokenizers import normalizers
    from transformers import tokenization_utils_fast
    from transformers.convert_slow_tokenizer import T5Converter

    class Slow:
        _extra_ids, legacy = 100, True

        def __init__(self, path):
            self.vocab_file = path

        def convert_tokens_to_ids(self, token):
            return {"</s>": 1}[token]

    def convert(fast, from_tiktoken=False):
        conv = T5Converter(Slow(fast.vocab_file))
        tok = conv.converted()
        if "nfkc" in conv.proto.normalizer_spec.name and not conv.proto.normalizer_spec.precompiled_charsmap:
            tok.normalizer = normalizers.Sequence([normalizers.NFKC(), tok.normalizer])
        return tok

    monkeypatch.setattr(tokenization_utils_fast, "convert_slow_tokenizer", convert)


def _directory(tmp_path, route, **kw):
    d = str(tmp_path / route)
    return _write_spiece(d, _pieces()) if route == "spiece_model" else _write_tokenizer_json(d, _pieces(), **kw)


def _jax_ids(d, prompts, maxlen):
    from ttt_video_dit_tpu.models.t5 import _load_tokenizer, _tokenize

    tok = _load_tokenizer(d)
    return np.asarray(_tokenize(tok, prompts, maxlen), np.int64), len(tok)


@pytest.mark.parametrize("group", sorted(PROMPTS))
@pytest.mark.parametrize("route", ROUTES)
def test_ids_match_the_jax_tokenize(tmp_path, converter_for_spiece, route, group):
    """Ids, truncation to maxlen - 1 plus </s>, right padding, the scene and
    extra-id tokens, unknown characters and the NFKC range: port == JAX's
    ``_tokenize(_load_tokenizer(dir))`` on the same directory."""
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


@pytest.mark.parametrize("flags", [dict(add_dummy_prefix=False), dict(remove_extra_whitespaces=False)],
                         ids=["no_dummy_prefix", "keep_whitespace"])
def test_spiece_normalizer_flags_are_read(tmp_path, flags):
    """The normalizer_spec flags, read from the wire: no dummy prefix means no
    leading ``▁``; without whitespace removal, runs of spaces stay."""
    d = _write_spiece(str(tmp_path / "sp"), _pieces(), **flags)
    tok = port_tok.load(d)
    m = port_tok.read_sentencepiece_model(os.path.join(d, "spiece.model"))
    assert all(m[k] == v for k, v in flags.items())
    ids = tok.encode("the  cat ")
    pieces = [tok.pieces[i][0] for i in ids]
    if "add_dummy_prefix" in flags:
        assert pieces[0] == "the"
    else:
        assert pieces[0] == "▁the" and pieces.count("▁") >= 2


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
    """With transformers, tokenizers, sentencepiece and google.protobuf
    blocked from import, T5TextEncoder.encode turns storyboard text into the
    JAX package's ids and encodes them as encode_ids does."""
    d = _directory(tmp_path, route)
    _tiny_t5(d, len(_pieces()) + 100)
    prompts = PROMPTS["multiscene"] + PROMPTS["plain"] + [None]
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


def test_chip_smoke_spiece_writer_reads_back(tmp_path):
    """chip_smoke.py's wire-format writer (no protobuf on the card's machine)
    writes a spiece.model that protobuf parses and the port reads back."""
    from transformers.utils import sentencepiece_model_pb2_new as pb

    import chip_smoke

    path = str(tmp_path / "spiece.model")
    pieces = chip_smoke.fabricated_spiece(path, size=600, seed=3)
    m = pb.ModelProto()
    with open(path, "rb") as f:
        m.ParseFromString(f.read())
    assert [(p.piece, p.score, p.type) for p in m.pieces] == pieces
    assert (m.trainer_spec.unk_id, m.trainer_spec.eos_id, m.trainer_spec.pad_id) == (2, 1, 0)
    tok = port_tok.load(str(tmp_path))
    assert len(tok) == 600 + 100
    ids = tok.encode("a fluffy orange cat walks through a sunlit kitchen")
    assert ids and 2 not in ids  # every character has a piece
