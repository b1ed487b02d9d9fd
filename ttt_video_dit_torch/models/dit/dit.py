"""CogVideoX-style diffusion transformer with segment-local attention and
bidirectional gated TTT layers (port of ttt_video_dit_tpu/models/dit/dit.py).

Module and parameter names mirror the flax tree (``layers_i`` becomes
``layers.i``), so ``convert.py`` maps a flax checkpoint one to one. The
residual stream stays in the compute dtype (bf16 on the GPU), as in flax;
LayerNorm statistics run in float32. Parameters are float32 masters, cast
to the compute dtype at each matmul (``Linear``/``Conv2d``), as flax's
promote_dtype does; sampling casts them once instead
(:func:`cast_matmul_weights_`). The layers are always unrolled; with
``scan_layers`` (the training TOMLs) the JAX package scans them and casts
their 2-D Dense kernels through a Pallas kernel (K7), and the port casts
the layer stack's ``Linear`` weights through its CUDA counterpart
(``Linear.pin``, ops/convert.py). With autograd on, each group of
``remat_transformer_layer_group_size`` layers runs under
``torch.utils.checkpoint`` with the JAX remat policy (:func:`_ckpt_policy`):
"none" re-runs the group's forward in the backward, kernels included;
"save_seq" keeps the TTT scans' and attention's kernel outputs, so the
re-run is dense and elementwise work only.

Layouts: video latents [B, T, C, H, W]; text [B, scenes, S, text_dim];
token streams [B, L, D] with text first.

Between the layers the stream is one [B, L, D] tensor, [text; video]. Under
tensor parallelism (a group of more than one rank, parallel/sharding.py)
it is token-sharded over the group, as the JAX package's ``shard_boundary``
and ``maybe_shard`` constraints lay it out (parallel/sharded.py): each rank
holds L / tp rows (padded when tp does not divide L), runs the adaLN
modulation, LayerNorms, gates, residual adds and the MLP on them, and saves
only them at each layer-group checkpoint. Its rows may straddle the text
and the video, and each part takes its own shift, scale and gate. The
attention and the TTT layer gather every token and run on the rank's heads;
their partial sums over heads are reduce-scattered back to the rows. The
final layer runs on the rank's video rows, and its output is gathered.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as Fn
import torch.utils.checkpoint
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from ttt_video_dit_torch.config.model_config import ModelConfig
from ttt_video_dit_torch.models.dit.schedule import timestep_embedding
from ttt_video_dit_torch.models import recompute
from ttt_video_dit_torch.models.sequence import SequenceMetadata
from ttt_video_dit_torch.models.ttt.layer import Linear, TTTLayer, layer_norm
from ttt_video_dit_torch.ops import attention as attention_ops
from ttt_video_dit_torch.ops import ttt_linear_kernel, ttt_mlp_kernel  # noqa: F401  (registers their custom ops)
from ttt_video_dit_torch.ops.ln import gelu_tanh
from ttt_video_dit_torch.ops.rope import apply_rope_prefixed, precompute_rope_3d
from ttt_video_dit_torch.parallel.sharded import NO_TENSOR_PARALLEL


def compute_dtype(config: ModelConfig) -> torch.dtype:
    """The activation dtype ("bfloat16" | "float32"); parameters are float32
    until :func:`cast_matmul_weights_` rounds the matmul weights to it."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[config.dtype]


# What "save_seq" keeps (the JAX names in dit.py:_ckpt_policy): the outputs of
# the K1-train / K5-train custom ops, the TTT scans' output ("ttt_out") and
# fp32 state checkpoints ("ttt_residuals"), and of the K3-lse custom op,
# attention's output and log-sum-exp ("splash_residuals").
_OPS = torch.ops.ttt_video_dit_torch  # registered by ops/ttt_mlp_kernel.py, ttt_linear_kernel.py and attention.py
SAVE_SEQ_OPS = (_OPS.ttt_mlp_forward_train.default, _OPS.ttt_linear_forward_train.default,
                _OPS.attention_with_lse.default)


def _save_seq_policy(ctx, op, *args, **kwargs):
    if op in SAVE_SEQ_OPS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _ckpt_policy(cfg: ModelConfig):
    """The ``context_fn`` of every per-layer ``torch.utils.checkpoint``
    (config: remat.policy), None for "none" / "". "save_seq" keeps
    SAVE_SEQ_OPS' outputs across the checkpoint, so a layer's backward re-runs
    only dense matmuls and elementwise ops: the scans' and attention's
    forward kernels run once a step (K7's casts are re-run). The cost is the
    kept outputs' memory, about 0.5 GB a layer at the 3 s shape. Any other
    value raises ValueError, as in the JAX package."""
    if cfg.remat_policy == "save_seq":
        return functools.partial(create_selective_checkpoint_contexts, _save_seq_policy)
    if cfg.remat_policy not in ("none", ""):
        raise ValueError(f"Unknown remat policy: {cfg.remat_policy!r}")
    return None


def modulate(x, shift, scale):
    """adaLN modulation: x * (1 + scale) + shift, broadcast over tokens."""
    return x * (1.0 + scale[:, None, :]) + shift[:, None, :]


class Conv2d(nn.Conv2d):
    """flax Conv(dtype=compute, param_dtype=float32): weight and bias cast to
    the input's dtype at each call (see ``Linear``)."""

    def forward(self, x):
        return self._conv_forward(x, self.weight.to(x.dtype), self.bias.to(x.dtype))


class PatchEmbedding(nn.Module):
    """2x2 conv patchify of video latents + linear text projection."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        p = config.patch_size
        self.vid_proj = Conv2d(config.in_channels, config.model_dim, kernel_size=p, stride=p)
        self.text_proj = Linear(config.text_dim, config.model_dim)

    def forward(self, video, text_encoding):
        """(text [B, scenes * S, D], video [B, T * tokens a frame, D]) in the compute dtype."""
        dtype = compute_dtype(self.config)
        B, T, C, H, W = video.shape
        vid = self.vid_proj(video.reshape(B * T, C, H, W).to(dtype))  # [B*T, D, h, w]
        vid = vid.permute(0, 2, 3, 1).reshape(B, -1, self.config.model_dim)
        text = self.text_proj(text_encoding.to(dtype))
        return text.reshape(B, -1, self.config.model_dim), vid


# The transient bytes one chunk of row-wise work may hold: the MLP's hidden
# activations and GELU terms (4 x 4D values a token) and the attention's q/k
# LayerNorm + rope terms in float32 (~12 bytes a value of a window). Tokens and
# windows are independent rows, so chunking them changes no value beyond the
# rounding of matmuls of other row counts; it bounds what a long sequence holds
# at once (63 s: 351,168 tokens in 42 windows, where the eager GELU alone would
# hold ~70 GB; scripts/profile_torch_long_context.py measures each site). The
# 3 s and 9 s shapes (the MLP at L = 18,048, CFG batch 2: ~3.3 GiB; 6 windows
# of 18,052: ~3.7 GiB) run in one chunk, exactly as without chunking.
CHUNK_BYTES = 4 << 30


def in_chunks(fn, x, row_bytes: int, dim: int = 1):
    """``fn(chunk)`` over chunks of ``x`` along ``dim``, each holding at most
    CHUNK_BYTES of transients at ``row_bytes`` an index of ``dim``; the results
    are written into one tensor along ``dim``. One chunk: ``fn(x)``."""
    n = x.shape[dim]
    rows = max(1, CHUNK_BYTES // row_bytes)
    if rows >= n:
        return fn(x)
    out = None
    for i in range(0, n, rows):
        y = fn(x.narrow(dim, i, min(rows, n - i)))
        if out is None:
            out = y.new_empty(y.shape[:dim] + (n,) + y.shape[dim + 1 :])
        out.narrow(dim, i, y.shape[dim]).copy_(y)
        del y
    return out


class MLP(nn.Module):
    """4x GELU-tanh MLP, over chunks of the token axis (``in_chunks``)."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.layer1 = Linear(config.model_dim, 4 * config.model_dim)
        self.layer2 = Linear(4 * config.model_dim, config.model_dim)

    def forward(self, x):
        w1, w2 = self.layer1.pinned_weight(x.dtype), self.layer2.pinned_weight(x.dtype)  # one K7 cast, not a chunk's
        hidden_bytes = 4 * self.layer1.out_features * x.element_size() * x.shape[0]  # a token of every batch row
        # Where the layer recomputes, the GELU keeps only its input for the backward (models/recompute.py).
        return in_chunks(lambda t: self.layer2(recompute.recomputed(gelu_tanh, self.layer1(t, w1)), w2), x,
                         hidden_bytes)


class SSMGating(nn.Module):
    """Per-channel learned gate on a TTT residual branch: tanh(alpha), cast to
    the stream dtype, times x."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.alpha_init = config.gating_alpha_init
        self.gating_alpha = nn.Parameter(torch.full((config.model_dim,), config.gating_alpha_init))

    def forward(self, x):
        return torch.tanh(self.gating_alpha).to(x.dtype) * x


def gather_windows(frames, AL: int, WF: int):
    """[B, T, ...] -> [B, C, WF, ...]: window c holds frames c * AL .. c * AL + WF - 1."""
    return frames.unfold(1, WF, AL).movedim(-1, 2).contiguous()


def stitch_windows(w, T: int, AL: int):
    """[B, C, WF, ...] -> [B, T, ...], the adjoint of :func:`gather_windows`:
    each frame the sum of the windows that hold it, added in window order."""
    out = w.new_zeros((w.shape[0], T) + w.shape[3:])
    for c in range(w.shape[1]):
        out[:, c * AL : c * AL + w.shape[2]] += w[:, c]
    return out


class WindowGather(torch.autograd.Function):
    """:func:`gather_windows`, whose backward is :func:`stitch_windows`: the
    frames' gradient is a sum in a fixed order, where ``index_select``'s
    backward adds repeated indices with atomics on CUDA."""

    @staticmethod
    def forward(ctx, frames, AL: int, WF: int):
        ctx.T, ctx.AL = frames.shape[1], AL
        return gather_windows(frames, AL, WF)

    @staticmethod
    def backward(ctx, g):
        return stitch_windows(g, ctx.T, ctx.AL), None, None


class WindowStitch(torch.autograd.Function):
    """:func:`stitch_windows` (a fixed-order sum, where ``index_add_`` adds
    with atomics on CUDA), whose backward is :func:`gather_windows`."""

    @staticmethod
    def forward(ctx, w, T: int, AL: int):
        ctx.AL, ctx.WF = AL, w.shape[2]
        return stitch_windows(w, T, AL)

    @staticmethod
    def backward(ctx, g):
        return gather_windows(g, ctx.AL, ctx.WF), None, None


class FanOut(torch.autograd.Function):
    """``n`` copies of ``x``, one for each of its consumers. The backward
    receives the ``n`` gradients at once and adds them in float32 in the
    copies' order, then rounds once to ``x``'s dtype: the sum no longer
    depends on the order in which autograd delivers them (FSDP2's per-layer
    hooks change that order), and a bf16 sum is rounded once, not ``n - 1``
    times."""

    @staticmethod
    def forward(ctx, x, n: int):
        return tuple(x.clone() for _ in range(n))

    @staticmethod
    def backward(ctx, *grads):
        total = grads[0].float()
        for g in grads[1:]:
            total = total + g.float()
        return total.to(grads[0].dtype), None


class SegmentLocalAttention(nn.Module):
    """Attention over overlapping (prefix + attn_length)-frame windows, each
    window seeing its own scene's text. All windows go through one attention
    call as batch; the overlapping prefix frames are stitched back by
    slice/concat (prefix 1) or a sum over the windows in window order (other
    prefixes: :class:`WindowStitch`), then divided by their window count.
    Under head tensor parallelism (``tp``, of one by default) q/k/v are
    column-parallel, the attention kernel runs on the rank's H / tp heads
    and o is row-parallel, so the output is this rank's
    partial sums over its heads: the stitch, linear, runs on them before the
    caller's reduce-scatter (SeqModelingBlock). The q/k norms' parameters
    are replicated and see only the rank's heads: their gradients are
    partial, as every replicated parameter's is."""

    tp = NO_TENSOR_PARALLEL

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        D, F = config.model_dim, config.head_dim
        self.q, self.k, self.v, self.o = (Linear(D, D) for _ in range(4))
        self.q_norm = nn.LayerNorm(F, eps=config.layer_norm_eps)
        self.k_norm = nn.LayerNorm(F, eps=config.layer_norm_eps)

    def forward(self, vid_emb, text_emb, meta: SequenceMetadata):
        """The whole video and text streams -> [B, L, D], text first."""
        cfg = self.config
        B, D = vid_emb.shape[0], cfg.model_dim
        H, F = self.tp.local_heads(cfg.num_heads), cfg.head_dim  # this rank's heads
        C, TL, TPF = meta.num_chunks, meta.text_length, meta.tokens_per_frame
        AL, P = cfg.attn_length, cfg.prefix_temporal_length
        WF = P + AL  # frames per window
        if meta.num_frames != P + C * AL:
            raise ValueError(f"num_frames {meta.num_frames} != prefix {P} + {C} chunks * {AL} frames")
        window_idx = np.arange(C)[:, None] * AL + np.arange(WF)[None, :]

        frames = vid_emb.reshape(B, meta.num_frames, TPF, D)
        if P == 1:
            # Frames 1.. tile the window interiors; window c's 1-frame prefix is
            # the previous interior's last frame.
            interior = frames[:, 1:].reshape(B, C, AL, TPF, D)
            lead = torch.cat([frames[:, :1], interior[:, :-1, -1]], dim=1)
            win_vid = torch.cat([lead[:, :, None], interior], dim=2)
        else:
            win_vid = WindowGather.apply(frames, AL, WF)
        win_vid = win_vid.reshape(B, C, WF * TPF, D)
        win_text = text_emb.reshape(B, C, TL, D)

        S = TL + WF * TPF
        x = torch.cat([win_text, win_vid], dim=2).reshape(B * C, S, D)
        del win_vid  # x holds the windows now
        q = self.q(x).reshape(B * C, S, H, F)
        k = self.k(x).reshape(B * C, S, H, F)
        v = self.v(x).reshape(B * C, S, H, F)
        del x

        # q/k LayerNorm, then rope over local window positions (every window
        # uses 0..WF*TPF), a few windows at a time.
        cos, sin = precompute_rope_3d(F, meta.grid_height, meta.grid_width, meta.num_frames, cfg.theta)

        def norm_rope(norm):  # recomputing, the backward keeps q or k, not the LayerNorm's float32 input
            fn = lambda t, w, b: apply_rope_prefixed(Fn.layer_norm(t.float(), (F,), w, b, norm.eps).to(t.dtype), cos,
                                                     sin, TL, seq_axis=1)
            return lambda t: recompute.recomputed(fn, t, norm.weight, norm.bias)

        q = in_chunks(norm_rope(self.q_norm), q, 12 * S * H * F, dim=0)
        k = in_chunks(norm_rope(self.k_norm), k, 12 * S * H * F, dim=0)

        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        # K3 (with the log-sum-exp) and K4, or their plain versions: with use_kernel off, and where the JAX
        # package sends attention to XLA (any dtype but bf16; ops/attention.py:use_plain counts those).
        plain = attention_ops.use_plain(cfg.use_kernel, q.dtype, q.device)
        if torch.is_grad_enabled():
            attn = attention_ops.attention_train(q, k, v, plain=plain)
        else:
            attn = (attention_ops.attention_plain if plain else attention_ops.attention)(q, k, v)
        del q, k, v
        out = self.o(attn.reshape(B * C, S, H * F)).reshape(B, C, S, D)
        del attn

        out_text = out[:, :, :TL].reshape(B, C * TL, D)
        w = out[:, :, TL:].reshape(B, C, WF, TPF, D)
        if P == 1:
            # Frames 1..AL of each window tile the timeline; only each window's
            # frame 0 adds onto the previous window's last frame.
            nxt = torch.cat([w[:, 1:, 0], torch.zeros_like(w[:, :1, 0])], dim=1)
            last = w[:, :, AL] + nxt
            body = torch.cat([w[:, :, 1:AL], last[:, :, None]], dim=2)
            stitched = torch.cat([w[:, :1, 0], body.reshape(B, C * AL, TPF, D)], dim=1)
        else:
            stitched = WindowStitch.apply(w, meta.num_frames, AL)
        counts = np.zeros((meta.num_frames,), np.float32)
        np.add.at(counts, window_idx.reshape(-1), 1.0)
        stitched = stitched / torch.from_numpy(counts).to(device=out.device, dtype=out.dtype)[None, :, None, None]
        return torch.cat([out_text, stitched.reshape(B, meta.num_video_tokens, D)], dim=1)


class SeqModelingBlock(nn.Module):
    """Segment-local attention followed by bidirectional gated TTT, on this
    rank's rows of the stream (all of it without tensor parallelism). Each
    of the three head-local calls gathers the tokens first and
    reduce-scatters its partial sums over heads back to the rows after
    (``tp``, of one by default: both are then the identity)."""

    tp = NO_TENSOR_PARALLEL

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.attention = SegmentLocalAttention(config)
        self.ssm = TTTLayer(config)
        self.forward_ssm_gating_text = SSMGating(config)
        self.forward_ssm_gating_video = SSMGating(config)
        self.backward_ssm_gating_text = SSMGating(config)
        self.backward_ssm_gating_video = SSMGating(config)

    def forward(self, x, meta: SequenceMetadata, nt: int):
        """``x``: this rank's rows of [text; video], the first ``nt`` of them text."""
        stl, L = meta.seq_text_length, meta.seq_text_length + meta.num_video_tokens
        full = self.tp.all_gather(x, L)
        emb = self.tp.reduce_scatter(self.attention(full[:, stl:], full[:, :stl], meta))
        del full
        w = self.ssm.pinned_weights(emb.dtype)
        for reverse, text_gate, video_gate in ((False, self.forward_ssm_gating_text, self.forward_ssm_gating_video),
                                               (True, self.backward_ssm_gating_text, self.backward_ssm_gating_video)):
            out = self.tp.reduce_scatter(self.ssm(self.tp.all_gather(emb, L), meta, reverse=reverse, weights=w))
            emb = emb + by_part(out, nt, text_gate, video_gate)
        return emb


def by_part(x, nt: int, text_fn, video_fn):
    """``text_fn`` on the first ``nt`` rows of [B, n, D] and ``video_fn`` on
    the rest, concatenated: a rank's rows may hold text, video or both."""
    return torch.cat([text_fn(x[:, :nt]), video_fn(x[:, nt:])], dim=1)


class TransformerLayer(nn.Module):
    """adaLN-modulated sequence-modeling block + MLP, on this rank's rows of
    the stream; the text rows take the text shift, scale and gate. Where its
    saves would bind the card's memory (models/recompute.py:binds), its
    elementwise chains keep only their inputs and run again in the backward."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        D, Te, eps = config.model_dim, config.time_embed_dim, config.layer_norm_eps
        self.pre_seq_adaLN_modulation = Linear(Te, 6 * D)
        self.pre_seq_layernorm = nn.LayerNorm(D, eps=eps)
        self.seq_modeling_block = SeqModelingBlock(config)
        self.pre_mlp_adaLN_modulation = Linear(Te, 6 * D)
        self.pre_mlp_layernorm = nn.LayerNorm(D, eps=eps)
        self.mlp = MLP(config)

    def forward(self, x, t_emb, meta: SequenceMetadata, nt: int):
        """``x``: this rank's rows of [text; video], the first ``nt`` of them
        text; ``t_emb``: the time embedding's copies for the two adaLNs
        (pre-sequence-modeling, pre-MLP), from :class:`FanOut`."""
        dtype = x.dtype
        with recompute.when(recompute.binds(x)):
            for t, adaLN, norm, block in ((t_emb[0], self.pre_seq_adaLN_modulation, self.pre_seq_layernorm,
                                           lambda h: self.seq_modeling_block(h, meta, nt)),
                                          (t_emb[1], self.pre_mlp_adaLN_modulation, self.pre_mlp_layernorm, self.mlp)):
                shift, scale, gate, t_shift, t_scale, t_gate = adaLN(Fn.silu(t)).chunk(6, dim=-1)
                h = by_part(layer_norm(x, norm, dtype), nt, lambda t: modulate(t, t_shift, t_scale),
                            lambda v: modulate(v, shift, scale))
                x = x + by_part(block(h), nt, lambda t: t_gate[:, None, :] * t, lambda v: gate[:, None, :] * v)
        return x


class FinalLayer(nn.Module):
    """adaLN + linear, per video token; :func:`unpatchify` turns the tokens
    back into latent video."""

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        D, p, c = config.model_dim, config.patch_size, config.out_channels
        self.adaLN_modulation = Linear(config.time_embed_dim, 2 * D)
        self.norm = nn.LayerNorm(D, eps=config.layer_norm_eps)
        self.linear = Linear(D, p * p * c)

    def forward(self, vid_emb, t_emb):
        """[B, n, D] video tokens -> [B, n, p * p * out_channels]."""
        shift, scale = self.adaLN_modulation(Fn.silu(t_emb)).chunk(2, dim=-1)
        return self.linear(modulate(layer_norm(vid_emb, self.norm, vid_emb.dtype), shift, scale))


def unpatchify(x, meta: SequenceMetadata, out_channels: int):
    """[B, (t h w), (c p q)] -> [B, t, c, h*p, w*q]."""
    p = meta.patch_size
    B, h, w, t = x.shape[0], meta.latent_height // p, meta.latent_width // p, meta.num_frames
    x = x.reshape(B, t, h, w, out_channels, p, p).permute(0, 1, 4, 2, 5, 3, 6)
    return x.reshape(B, t, out_channels, h * p, w * p)


def sequence_metadata(config: ModelConfig, num_frames: int, latent_height: int, latent_width: int,
                      num_scenes: int, text_length: int) -> SequenceMetadata:
    """The sequence geometry the DiT builds for a [B, num_frames, C, latent_height,
    latent_width] video and [B, num_scenes, text_length, text_dim] text."""
    p = config.patch_size
    return SequenceMetadata(
        text_length=text_length, num_frames=num_frames, num_chunks=num_scenes,
        tokens_per_frame=(latent_height // p) * (latent_width // p), latent_height=latent_height,
        latent_width=latent_width, patch_size=p,
    )


class DiffusionTransformer(nn.Module):
    """The full DiT: (video [B,T,C,H,W], text [B,scenes,S,text_dim], timesteps [B])
    -> latent v-prediction [B,T,C,H,W]. ``tp``: the tensor group over whose
    ranks the stream is token-sharded between the layers (of one by
    default); the output is whole on every rank."""

    tp = NO_TENSOR_PARALLEL

    def __init__(self, config: ModelConfig):
        super().__init__()
        self.config = config
        D, Te = config.model_dim, config.time_embed_dim
        self.time_embed_0 = Linear(D, Te)
        self.time_embed_2 = Linear(Te, Te)
        self.patch_embedding = PatchEmbedding(config)
        self.layers = nn.ModuleList(TransformerLayer(config) for _ in range(config.num_layers))
        if config.scan_layers:  # the JAX pin covers the stacked layers' 2-D Dense kernels
            for m in self.layers.modules():
                if isinstance(m, Linear):
                    m.pin = config
        self.transformer_norm = nn.LayerNorm(D, eps=config.layer_norm_eps)
        self.final_layer = FinalLayer(config)

    def forward(self, video, text, timesteps):
        cfg = self.config
        dtype = compute_dtype(cfg)
        B, T, _, H_lat, W_lat = video.shape
        num_scenes, text_length = text.shape[1], text.shape[2]

        t_emb = timestep_embedding(timesteps, cfg.model_dim, dtype=dtype)
        t_emb = self.time_embed_2(Fn.silu(self.time_embed_0(t_emb)))
        # One copy for each adaLN, in layer order, the final layer's last: their gradients are summed in that order.
        t_embs = FanOut.apply(t_emb, 2 * cfg.num_layers + 1)

        text_emb, vid_emb = self.patch_embedding(video, text)
        meta = sequence_metadata(cfg, T, H_lat, W_lat, num_scenes, text_length)
        stl = meta.seq_text_length
        x = self.tp.shard(torch.cat([text_emb, vid_emb], dim=1))  # this rank's rows of [text; video]
        del text_emb, vid_emb
        nt = min(max(stl - self.tp.rank * x.shape[1], 0), x.shape[1])  # of them text
        remat = cfg.remat_transformer_layers and torch.is_grad_enabled()
        context_fn = _ckpt_policy(cfg) if remat else None
        kw = {} if context_fn is None else {"context_fn": context_fn}
        group = max(cfg.remat_transformer_layer_group_size, 1)
        for i in range(0, cfg.num_layers, group):
            def run(h, _layers=self.layers[i : i + group], _t=t_embs[2 * i : 2 * (i + group)]):
                for j, layer in enumerate(_layers):
                    h = layer(h, _t[2 * j : 2 * j + 2], meta, nt)
                return h

            x = torch.utils.checkpoint.checkpoint(run, x, use_reentrant=False, **kw) if remat else run(x)
        with recompute.when(recompute.binds(x)):
            # this rank's video rows
            out = self.final_layer(layer_norm(x[:, nt:], self.transformer_norm, dtype), t_embs[-1])
        del x
        # Every rank's rows (the text rows as zeros), then the video tokens: the output is whole on every rank.
        out = self.tp.gather(Fn.pad(out, (0, 0, nt, 0)), 1).narrow(1, stl, meta.num_video_tokens)
        return unpatchify(out, meta, cfg.out_channels)


# ------------------------------------------------------------ set-up helpers


def _lecun_normal_(weight, fan_in: int, generator):
    """flax's default kernel init: truncated normal (+-2 std), variance 1/fan_in."""
    std = (1.0 / fan_in) ** 0.5 / 0.87962566103423978
    nn.init.trunc_normal_(weight, 0.0, std, -2 * std, 2 * std, generator=generator)


@torch.no_grad()
def init_params_(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights with flax's initializers: lecun-normal Dense/Conv kernels
    and zero biases, N(0, 0.02) for the TTT projections, LR gate and fast
    weights, unit/zero LayerNorms, gating_alpha_init for the TTT gates."""
    ttt_owned = set()
    for m in model.modules():
        if isinstance(m, TTTLayer):
            for lin in (m.wq, m.wk, m.wv, m.wo):
                nn.init.normal_(lin.weight, 0.0, 0.02, generator=generator)
                nn.init.zeros_(lin.bias)
                ttt_owned.add(lin)
            mlp = m.config.ssm_layer == "ttt_mlp"
            for p in [m.learnable_ttt_lr_weight, m.W1] + ([m.W2] if mlp else []):
                nn.init.normal_(p, 0.0, 0.02, generator=generator)
            for p in [m.learnable_ttt_lr_bias, m.ttt_norm_bias, m.b1] + ([m.b2] if mlp else []):
                nn.init.zeros_(p)
            nn.init.ones_(m.ttt_norm_weight)
        elif isinstance(m, nn.Linear) and m not in ttt_owned:
            _lecun_normal_(m.weight, m.in_features, generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.Conv2d):
            _lecun_normal_(m.weight, m.weight[0].numel(), generator)
            nn.init.zeros_(m.bias)
        elif isinstance(m, nn.LayerNorm):
            nn.init.ones_(m.weight)
            nn.init.zeros_(m.bias)
        elif isinstance(m, SSMGating):
            m.gating_alpha.fill_(m.alpha_init)
    return model


def cast_matmul_weights_(model: nn.Module, dtype: torch.dtype) -> nn.Module:
    """Cast every Linear/Conv2d weight and bias to the compute dtype, once, in
    place. flax's per-call promote_dtype rounds the same fp32 masters the same
    way, so the values are identical; LayerNorm affines, the TTT fast-weight
    state, LR gate and gating alphas stay float32 as flax uses them."""
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            m.to(dtype)
    return model
