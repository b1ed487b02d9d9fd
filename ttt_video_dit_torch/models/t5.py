"""T5 text encoding with the scene special tokens (port of
ttt_video_dit_tpu/models/t5.py).

The encoder is plain ``nn.Module``s: no ``transformers`` model class, so it
runs wherever torch does. Its sizes come from the model directory's
``config.json`` (HF's T5 fields) and its weights from ``model.safetensors``
(or shards, read by ``utils/safetensors.py``) or ``pytorch_model.bin``, under
HF's key names, which the submodules carry (``shared``,
``encoder.block.<i>.layer.0.SelfAttention.q``, ...), so the state dict loads
as it is. Numerics follow HF's ``T5EncoderModel``:

- RMS ``T5LayerNorm``: the variance in float32, no mean, no bias; the
  normalised value is cast to the weight's dtype when that is 16-bit;
- self-attention without the 1/sqrt(d) scale, softmax in float32, plus a
  relative-position bias that block 0 computes from the bidirectional bucket
  function and every block shares;
- the feed-forward is gated-GELU (tanh GELU, "gated-gelu") or ReLU, as
  ``feed_forward_proj`` says;
- a final RMS norm; the output is cast to float32.

Every weight is held in the run's dtype. HF keeps ``wo`` in float32 only
for float16 (``_keep_in_fp32_modules``; transformers 4.57 no longer applies
it to bf16), and the port runs float32 or bf16, so in bf16 ``wo`` is bf16 as
in HF.

The two scene tokens (``<end_scene>``, ``<start_scene>``) get fresh embedding
rows, normal(0, ``initializer_factor``) from an explicit generator, when the
tokenizer grows past the embedding (the JAX package's flax backend does the
same; a vocabulary that already has room, as T5-v1.1's 32,128 rows for
32,102 tokens, keeps its rows).

Conventions of the reference, kept: pad to ``max_length``, truncate at
``maxlen``, no attention mask (padded positions attend), ``None`` prompts
encode as empty strings. ``encode`` loads the port's own tokenizer
(``models/tokenizer.py``, plain Python) on first use, from the Unigram
``tokenizer.json`` or ``spiece.model`` a T5 directory holds; nothing here
needs ``transformers``. The port has one T5 backend, this one, whatever
``--eval.t5_backend`` says.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as Fn
from torch import nn

from ttt_video_dit_torch.models import tokenizer
from ttt_video_dit_torch.models.dit.sampler import SCENE_END_TOKEN, SCENE_START_TOKEN
from ttt_video_dit_torch.ops.ln import gelu_tanh
from ttt_video_dit_torch.utils import safetensors


@dataclass
class T5Config:
    """The ``config.json`` fields the encoder reads (HF's names and defaults)."""

    vocab_size: int = 32128
    d_model: int = 512
    d_kv: int = 64
    d_ff: int = 2048
    num_layers: int = 6
    num_heads: int = 8
    relative_attention_num_buckets: int = 32
    relative_attention_max_distance: int = 128
    layer_norm_epsilon: float = 1e-6
    feed_forward_proj: str = "relu"
    initializer_factor: float = 1.0

    @classmethod
    def from_dir(cls, model_dir: str) -> "T5Config":
        with open(os.path.join(model_dir, "config.json"), encoding="utf-8") as f:
            raw = json.load(f)
        return cls(**{k: raw[k] for k in cls.__dataclass_fields__ if k in raw})

    @property
    def gated(self) -> bool:
        """True for "gated-gelu" (T5 v1.1), False for "relu" (the original T5)."""
        if self.feed_forward_proj not in ("relu", "gated-gelu"):
            raise ValueError(f"feed_forward_proj {self.feed_forward_proj!r}: expected relu or gated-gelu")
        return self.feed_forward_proj == "gated-gelu"


class T5LayerNorm(nn.Module):
    def __init__(self, d: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d))
        self.eps = eps

    def forward(self, x):
        variance = x.float().pow(2).mean(-1, keepdim=True)
        x = x * torch.rsqrt(variance + self.eps)
        if self.weight.dtype in (torch.float16, torch.bfloat16):
            x = x.to(self.weight.dtype)
        return self.weight * x


def relative_position_bucket(relative_position: torch.Tensor, num_buckets: int, max_distance: int) -> torch.Tensor:
    """HF's bidirectional T5 bucket: half the buckets for each sign; within a
    half, exact buckets below num_buckets / 4, logarithmic ones up to
    ``max_distance``, the last bucket beyond."""
    num_buckets //= 2
    buckets = (relative_position > 0).long() * num_buckets
    relative_position = relative_position.abs()
    max_exact = num_buckets // 2
    large = max_exact + (torch.log(relative_position.float() / max_exact) / math.log(max_distance / max_exact)
                         * (num_buckets - max_exact)).long()
    large = torch.clamp(large, max=num_buckets - 1)
    return buckets + torch.where(relative_position < max_exact, relative_position, large)


class T5Attention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.cfg = cfg
        inner = cfg.num_heads * cfg.d_kv
        self.q = nn.Linear(cfg.d_model, inner, bias=False)
        self.k = nn.Linear(cfg.d_model, inner, bias=False)
        self.v = nn.Linear(cfg.d_model, inner, bias=False)
        self.o = nn.Linear(inner, cfg.d_model, bias=False)
        if has_relative_attention_bias:
            self.relative_attention_bias = nn.Embedding(cfg.relative_attention_num_buckets, cfg.num_heads)

    def compute_bias(self, length: int) -> torch.Tensor:
        """[1, heads, length, length] bias of key position minus query position."""
        pos = torch.arange(length, device=self.relative_attention_bias.weight.device)
        bucket = relative_position_bucket(pos[None, :] - pos[:, None], self.cfg.relative_attention_num_buckets,
                                          self.cfg.relative_attention_max_distance)
        return self.relative_attention_bias(bucket).permute(2, 0, 1)[None]

    def forward(self, x, position_bias):
        B, S, _ = x.shape
        H, Dk = self.cfg.num_heads, self.cfg.d_kv
        q, k, v = (proj(x).reshape(B, S, H, Dk).transpose(1, 2) for proj in (self.q, self.k, self.v))
        scores = q @ k.transpose(2, 3) + position_bias
        weights = torch.softmax(scores.float(), dim=-1).type_as(scores)
        return self.o((weights @ v).transpose(1, 2).reshape(B, S, H * Dk))


class T5LayerSelfAttention(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.SelfAttention = T5Attention(cfg, has_relative_attention_bias)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x, position_bias):
        return x + self.SelfAttention(self.layer_norm(x), position_bias)


class T5DenseReluDense(nn.Module):
    """``wi`` -> ReLU -> ``wo``, or tanh-GELU(``wi_0``) * ``wi_1`` -> ``wo`` when gated."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.gated = cfg.gated
        if self.gated:
            self.wi_0 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
            self.wi_1 = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        else:
            self.wi = nn.Linear(cfg.d_model, cfg.d_ff, bias=False)
        self.wo = nn.Linear(cfg.d_ff, cfg.d_model, bias=False)

    def forward(self, x):
        h = gelu_tanh(self.wi_0(x)) * self.wi_1(x) if self.gated else Fn.relu(self.wi(x))
        return self.wo(h)


class T5LayerFF(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.DenseReluDense = T5DenseReluDense(cfg)
        self.layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)

    def forward(self, x):
        return x + self.DenseReluDense(self.layer_norm(x))


class T5Block(nn.Module):
    def __init__(self, cfg: T5Config, has_relative_attention_bias: bool):
        super().__init__()
        self.layer = nn.ModuleList([T5LayerSelfAttention(cfg, has_relative_attention_bias), T5LayerFF(cfg)])

    def forward(self, x, position_bias):
        return self.layer[1](self.layer[0](x, position_bias))


class T5Stack(nn.Module):
    def __init__(self, cfg: T5Config):
        super().__init__()
        self.block = nn.ModuleList(T5Block(cfg, i == 0) for i in range(cfg.num_layers))
        self.final_layer_norm = T5LayerNorm(cfg.d_model, cfg.layer_norm_epsilon)


class T5Encoder(nn.Module):
    """HF's ``T5EncoderModel`` forward without a mask: token ids [B, S] ->
    float32 hidden states [B, S, d_model]."""

    def __init__(self, cfg: T5Config):
        super().__init__()
        self.config = cfg
        self.shared = nn.Embedding(cfg.vocab_size, cfg.d_model)
        self.encoder = T5Stack(cfg)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.shared(ids)
        bias = self.encoder.block[0].layer[0].SelfAttention.compute_bias(ids.shape[1]).to(x.dtype)
        for block in self.encoder.block:
            x = block(x, bias)
        return self.encoder.final_layer_norm(x).float()

    @torch.no_grad()
    def init_weights_(self, generator: torch.Generator) -> "T5Encoder":
        """Random weights with T5's own initialisation (HF's ``_init_weights``,
        ``initializer_factor`` f): embedding N(0, f), q N(0, f (d_model d_kv)^-1/2)
        (the attention's missing 1/sqrt(d_kv)), k, v, wi and the relative bias
        N(0, f d_model^-1/2), o N(0, f (heads d_kv)^-1/2), wo N(0, f d_ff^-1/2),
        norms 1; drawn from ``generator``, for smoke runs without a checkpoint."""
        c = self.config
        f, d = c.initializer_factor, c.d_model
        std = {"q": (d * c.d_kv) ** -0.5, "k": d**-0.5, "v": d**-0.5, "o": (c.num_heads * c.d_kv) ** -0.5,
               "relative_attention_bias": d**-0.5, "wi": d**-0.5, "wi_0": d**-0.5, "wi_1": d**-0.5, "wo": c.d_ff**-0.5,
               "shared": 1.0}
        for name, p in self.named_parameters():
            if name.endswith("layer_norm.weight"):
                p.fill_(1.0)
            else:
                p.normal_(0.0, f * std[name.split(".")[-2]], generator=generator)
        return self

    @torch.no_grad()
    def resize_token_embeddings(self, size: int, generator: torch.Generator) -> None:
        """Append rows up to ``size``, normal(0, initializer_factor) drawn in
        float32 from ``generator`` (on the embedding's device); no-op when the
        embedding already has ``size`` rows or more."""
        w = self.shared.weight
        if size <= w.shape[0]:
            return
        rows = torch.randn(size - w.shape[0], w.shape[1], generator=generator, device=w.device)
        rows = rows * self.config.initializer_factor
        self.shared.weight = nn.Parameter(torch.cat([w, rows.to(w.dtype)]), requires_grad=w.requires_grad)
        self.config.vocab_size = size

    def load_hf_weights(self, model_dir: str) -> "T5Encoder":
        """Load ``model.safetensors`` (or its shards) or ``pytorch_model.bin``
        under HF's names: ``shared.*`` and ``encoder.*`` (a full T5's
        ``decoder.*`` and ``lm_head`` are skipped; ``encoder.embed_tokens`` is
        ``shared``, tied). Every parameter must be found, at its shape."""
        try:
            safetensors.shard_files(model_dir)
            source = model_dir
        except FileNotFoundError:
            path = os.path.join(model_dir, "pytorch_model.bin")
            if not os.path.exists(path):
                raise FileNotFoundError(f"{model_dir}: no model.safetensors (or shards) and no pytorch_model.bin")
            source = torch.load(path, map_location="cpu", weights_only=True).items()
        names = set(self.state_dict())

        def rename(key: str):
            key = "shared.weight" if key == "encoder.embed_tokens.weight" else key
            return key if key in names else None

        safetensors.load_into(self, source, rename)
        return self


def _load_tokenizer(model_dir: str):
    """The port's tokenizer of ``model_dir`` (``models/tokenizer.py``: its
    Unigram ``tokenizer.json`` or ``spiece.model``), with the two scene tokens
    added in the JAX package's order."""
    tok = tokenizer.load(model_dir)
    tok.add_special_tokens([SCENE_END_TOKEN, SCENE_START_TOKEN])
    return tok


class T5TextEncoder:
    """The encoder of a T5 model directory on ``device`` in ``dtype``, with
    the tokenizer loaded on first :meth:`encode`. ``seed`` seeds the
    generator that draws the scene tokens' rows."""

    def __init__(self, model_dir: str, dtype: str = "float32", device: torch.device | str = "cpu", seed: int = 0):
        self.model_dir = model_dir
        self.device = torch.device(device)
        with torch.device("meta"):  # no random init: every parameter is loaded
            self.model = T5Encoder(T5Config.from_dir(model_dir))
        self.model.to({"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype])
        self.model.to_empty(device=self.device).load_hf_weights(model_dir)
        self.model.eval()
        self.generator = torch.Generator(self.device).manual_seed(seed)
        self.tokenizer = None

    def encode_ids(self, ids) -> torch.Tensor:
        """Token ids [scenes, maxlen] (any integer array) -> float32 [scenes, maxlen, d_model] on the device."""
        ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=self.device)
        with torch.inference_mode():
            return self.model(ids)

    def encode(self, prompts: List[Optional[str]], maxlen: int) -> torch.Tensor:
        """Prompts -> float32 [scenes, maxlen, d_model]; ``None`` encodes as ""."""
        if self.tokenizer is None:
            self.tokenizer = _load_tokenizer(self.model_dir)
            self.model.resize_token_embeddings(len(self.tokenizer), self.generator)
        return self.encode_ids(self.tokenizer(prompts, maxlen))


def load_text_encoder(model_dir: str, dtype: str = "float32", device: torch.device | str = "cpu") -> T5TextEncoder:
    """The port's T5 text encoder for ``model_dir`` (counterpart of the JAX
    package's ``load_text_encoder``; one backend)."""
    return T5TextEncoder(model_dir, dtype, device)
