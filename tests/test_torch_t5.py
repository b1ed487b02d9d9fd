"""The port's T5 encoder (ttt_video_dit_torch/models/t5.py) against HF's
torch ``T5EncoderModel`` and the JAX package's ``FlaxT5TextEncoder``, on a
tiny random T5 saved to disk with a Unigram fast tokenizer (the port reads
its ``tokenizer.json``, the JAX package ``transformers``' reading of it), for
both feed-forwards ("gated-gelu", "relu").

Tolerance, float32: relative L2 error <= 1e-5 and |port - ref| <= 1e-5 +
1e-5 |ref| elementwise (the same products and reductions in another order).
The scene tokens' embedding rows are random in every backend, drawn
differently, so ids that use them are compared after the port's rows are
copied into the other backend.
"""

import json
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("transformers")

from ttt_video_dit_torch.models import t5 as port_t5  # noqa: E402
from ttt_video_dit_torch.models.dit.sampler import SCENE_END_TOKEN, SCENE_START_TOKEN  # noqa: E402

torch.set_num_threads(1)
WORDS = ["<pad>", "</s>", "<unk>", "a", "cat", "sat", "on", "the", "mat", "dog", "ran"]
REL_L2 = 1e-5
FEED_FORWARDS = ["gated-gelu", "relu"]


def write_unigram_tokenizer(d, words):
    """A T5-style Unigram ``tokenizer.json`` over ``words`` (the control pieces
    <pad>, </s>, <unk> at ids 0-2, then one ``▁word`` piece a word; Metaspace
    prefix, </s> appended, no extra ids) and a ``tokenizer_config.json``: read
    by the port's tokenizer and by ``transformers.AutoTokenizer`` alike."""
    from tokenizers import AddedToken, Tokenizer, models, pre_tokenizers, processors

    vocab = [(w, 0.0) if w.startswith("<") else ("▁" + w, -float(i)) for i, w in enumerate(words)]
    tok = Tokenizer(models.Unigram(vocab, unk_id=2))
    tok.pre_tokenizer = pre_tokenizers.Metaspace(replacement="▁", prepend_scheme="always")
    tok.post_processor = processors.TemplateProcessing(single=["$A", "</s>"], special_tokens=[("</s>", 1)])
    tok.add_special_tokens([AddedToken(t, normalized=False, special=True) for t in words[:3]])
    tok.save(str(d / "tokenizer.json"))
    (d / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>", "eos_token": "</s>", "unk_token": "<unk>"}))


def _make_tiny_t5_dir(root, feed_forward_proj, **save_kw):
    from transformers import T5Config, T5EncoderModel

    d = root / f"tiny-t5-{feed_forward_proj}"
    d.mkdir()
    write_unigram_tokenizer(d, WORDS)
    torch.manual_seed(0)
    cfg = T5Config(vocab_size=len(WORDS), d_model=32, d_kv=8, d_ff=64, num_layers=3, num_heads=4, dropout_rate=0.0,
                   feed_forward_proj=feed_forward_proj, relative_attention_num_buckets=8,
                   relative_attention_max_distance=20)
    model = T5EncoderModel(cfg)
    with torch.no_grad():  # T5's init leaves the relative bias near zero; make it matter
        for p in model.parameters():
            p.add_(0.3 * torch.randn_like(p) * p.std().clamp_min(0.1))
    model.save_pretrained(d, **save_kw)
    return d


def _hf(d, dtype=torch.float32):
    from transformers import T5EncoderModel

    return T5EncoderModel.from_pretrained(d, torch_dtype=dtype).eval()


def _close(got, want, rel=REL_L2):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    err = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert err <= rel, f"relative L2 error {err:.3g} > {rel}"
    if rel == REL_L2:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _ids(rng, n, length, high=len(WORDS)):
    return rng.integers(0, high, size=(n, length)).astype(np.int64)


@pytest.mark.parametrize("ffn", FEED_FORWARDS)
def test_encode_ids_matches_hf_torch_and_flax(tmp_path, rng, ffn):
    """Ids below the base vocabulary (no scene rows), lengths past the bucket
    function's max distance: port == HF torch == JAX flax."""
    from ttt_video_dit_tpu.models.t5 import FlaxT5TextEncoder

    d = _make_tiny_t5_dir(tmp_path, ffn)
    enc = port_t5.load_text_encoder(str(d))
    ids = _ids(rng, 3, 45)
    got = enc.encode_ids(ids).numpy()
    with torch.no_grad():
        want = _hf(d)(input_ids=torch.from_numpy(ids)).last_hidden_state.numpy()
    _close(got, want)
    flax = FlaxT5TextEncoder(str(d)).encode_ids(ids)
    _close(got, flax)
    assert got.shape == (3, 45, 32) and got.dtype == np.float32


@pytest.mark.parametrize("ffn", FEED_FORWARDS)
def test_encode_with_scene_tokens_matches_hf_torch_and_flax(tmp_path, ffn):
    """Prompts through the tokenizer (scene tokens, a None prompt, padding and
    truncation), with the port's two fresh rows copied into the others."""
    from ttt_video_dit_tpu.models.t5 import FlaxT5TextEncoder, _load_tokenizer, _tokenize

    d = _make_tiny_t5_dir(tmp_path, ffn)
    enc = port_t5.load_text_encoder(str(d))
    prompts = [f"the cat sat on the mat{SCENE_END_TOKEN}", f"{SCENE_START_TOKEN}a dog ran on the mat the cat sat", None]
    maxlen = 8
    got = enc.encode(prompts, maxlen).numpy()
    rows = enc.model.shared.weight.detach().numpy()
    assert rows.shape == (len(WORDS) + 2, 32)
    ids = enc.tokenizer(prompts, maxlen)
    np.testing.assert_array_equal(ids, _tokenize(_load_tokenizer(str(d)), prompts, maxlen))
    assert ids.max() == len(WORDS) + 1 and (ids == len(WORDS)).any()  # both scene rows used
    assert np.isfinite(got).all() and got.shape == (3, maxlen, 32)

    hf = _hf(d)
    hf.resize_token_embeddings(len(rows))
    with torch.no_grad():
        hf.shared.weight.copy_(torch.from_numpy(rows))
        want = hf(input_ids=torch.from_numpy(ids.astype(np.int64))).last_hidden_state.numpy()
    _close(got, want)

    flax = FlaxT5TextEncoder(str(d))
    params = flax.model.params
    params["shared"]["embedding"] = np.asarray(rows)
    flax.model.params = params
    _close(got, flax.encode(prompts, maxlen))


def test_scene_rows_come_from_the_generator(tmp_path):
    """The fresh rows are normal(0, initializer_factor) from the encoder's
    seeded generator: the same seed gives the same rows, another seed others;
    the base rows are the checkpoint's."""
    d = _make_tiny_t5_dir(tmp_path, "gated-gelu")
    a, b, c = (port_t5.T5TextEncoder(str(d), seed=s) for s in (0, 0, 1))
    for enc in (a, b, c):
        enc.encode(["a cat"], 4)
    wa, wb, wc = (e.model.shared.weight.detach() for e in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa[-2:], wc[-2:]) and torch.equal(wa[:-2], wc[:-2])
    want = torch.randn(2, 32, generator=torch.Generator().manual_seed(0))
    assert torch.equal(wa[-2:], want)


@pytest.mark.parametrize("buckets,max_distance", [(32, 128), (8, 20), (16, 10)])
def test_relative_position_bucket_matches_hf(buckets, max_distance):
    from transformers.models.t5.modeling_t5 import T5Attention

    rel = torch.arange(-600, 601)[None, :] + torch.zeros(3, 1, dtype=torch.long)
    got = port_t5.relative_position_bucket(rel, buckets, max_distance)
    want = T5Attention._relative_position_bucket(rel, bidirectional=True, num_buckets=buckets,
                                                 max_distance=max_distance)
    assert torch.equal(got, want)


def test_bfloat16_matches_hf_bfloat16(tmp_path, rng):
    """In bf16 both hold every weight in bf16 (HF keeps ``wo`` in float32 only
    for float16) and the norms' variance in float32; the port follows HF's
    casts, so only the summation order can differ (relative L2 <= 1e-2 against
    HF bf16, and within 3e-2 of the float32 output)."""
    d = _make_tiny_t5_dir(tmp_path, "gated-gelu")
    enc = port_t5.load_text_encoder(str(d), dtype="bfloat16")
    assert {p.dtype for p in enc.model.parameters()} == {torch.bfloat16}
    ids = _ids(rng, 2, 30)
    got = enc.encode_ids(ids).numpy()
    with torch.no_grad():
        hf = _hf(d, torch.bfloat16)
        assert {p.dtype for p in hf.parameters()} == {torch.bfloat16}
        want = hf(input_ids=torch.from_numpy(ids)).last_hidden_state.float().numpy()
    _close(got, want, rel=1e-2)
    f32 = port_t5.load_text_encoder(str(d)).encode_ids(ids).numpy()
    _close(got, f32, rel=3e-2)


@pytest.mark.parametrize("layout", ["sharded_safetensors", "pytorch_model_bin"])
def test_loads_shards_and_pytorch_model_bin(tmp_path, rng, layout):
    kw = {"max_shard_size": "20KB"} if layout == "sharded_safetensors" else {"safe_serialization": False}
    d = _make_tiny_t5_dir(tmp_path, "relu", **kw)
    if layout == "sharded_safetensors":
        assert (d / "model.safetensors.index.json").exists() and len(list(d.glob("*.safetensors"))) > 1
    else:
        assert (d / "pytorch_model.bin").exists() and not list(d.glob("*.safetensors"))
    ids = _ids(rng, 2, 12)
    with torch.no_grad():
        want = _hf(d)(input_ids=torch.from_numpy(ids)).last_hidden_state.numpy()
    _close(port_t5.load_text_encoder(str(d)).encode_ids(ids).numpy(), want)


def test_encode_without_transformers_names_it(tmp_path, monkeypatch):
    """With ``transformers`` blocked, ``encode`` tokenises with the port's own
    tokenizer; a directory with neither a Unigram tokenizer.json nor a
    spiece.model is refused, naming both."""
    d = _make_tiny_t5_dir(tmp_path, "relu")
    enc = port_t5.load_text_encoder(str(d))
    monkeypatch.setitem(sys.modules, "transformers", None)
    assert enc.encode_ids(np.zeros((1, 4), np.int64)).shape == (1, 4, 32)
    ids = np.array([[3, 4, 1, 0]])  # ▁a ▁cat </s> <pad>
    assert torch.equal(enc.encode(["a cat"], 4), enc.encode_ids(ids))
    (d / "tokenizer.json").unlink()
    with pytest.raises(FileNotFoundError, match="tokenizer.json and no spiece.model"):
        port_t5.load_text_encoder(str(d)).encode(["a cat"], 4)
