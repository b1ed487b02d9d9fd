"""TTT fast-weight layer (port of ttt_video_dit_tpu/models/ttt/layer.py:TTTLayer,
``ttt_linear`` and ``ttt_mlp``).

One direction per call; the caller runs the reverse direction with the same
parameters (``reverse=True``). The layer permutes the [B, L, D] stream once
at entry (interleave, with the reverse prep composed in), projects q/k/v and
the LR-gate logits with plain matmuls, and hands the raw token-major
projections to the fused TTT scan (ops/ttt_linear_kernel.py for
``ttt_linear``, ops/ttt_mlp_kernel.py for ``ttt_mlp``), which does the
L2-norm, rope, LN-reconstruction target and the sigmoid gate itself. With
autograd on (training), the scan is the training kernels' autograd Function
(K5-train/K6, K1-train/K2; with ``use_kernel = False``, or at a CS or F
that is not a multiple of 8, the same Function over their plain versions);
under no_grad/inference_mode (sampling), the forward-only K5 or K1, or its
plain version. The kernels run on bf16 or float32 q/k/v alike.
Under head tensor parallelism (parallel/sharding.py) the layer runs on
its rank's H / tp heads of the whole stream, which the caller gathered
(models/dit/dit.py:SeqModelingBlock): wq/wk/wv are column-parallel, the scan
runs on the local heads with the local W1/b1/W2/b2, TTT norm and LR gate,
the post-norm (a LayerNorm over all of D) normalises the heads gathered from
the group, and wo is row-parallel: the layer returns this rank's partial
sums over its heads, which the caller reduce-scatters over tokens.
Rope is applied by SLOT of the interleaved layout, never by token: the slot
tables (identity rows on text, video slot j -> angle j, forward-interleaved
when multiscene) are the same for both directions.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as Fn
from torch import nn

from ttt_video_dit_torch.config.model_config import ModelConfig
from ttt_video_dit_torch.models.recompute import recomputed
from ttt_video_dit_torch.models.sequence import SequenceMetadata
from ttt_video_dit_torch.models.ttt.interleave import interleave, undo_interleave
from ttt_video_dit_torch.ops import convert, ttt_linear_kernel, ttt_mlp_kernel
from ttt_video_dit_torch.ops.rope import interleaved_tables_prefixed, precompute_rope_3d
from ttt_video_dit_torch.parallel.sharded import NO_TENSOR_PARALLEL, local


@functools.lru_cache(maxsize=16)
def scan_rope_tables(meta: SequenceMetadata, head_dim: int, theta: float, mini_batch: int, device: torch.device):
    """By-slot rope tables [NC, CS, F] float32 for the TTT scan, on ``device``
    (read-only: shared by every caller; normal tensors even when first built
    under inference mode, see interleave._index)."""
    L = meta.seq_text_length + meta.num_video_tokens
    with torch.inference_mode(False):
        cos, sin = precompute_rope_3d(head_dim, meta.grid_height, meta.grid_width, meta.num_frames, theta)
        tables = interleaved_tables_prefixed(cos, sin, meta.seq_text_length, L)
        shape = (L // mini_batch, mini_batch, head_dim)
        return tuple(interleave(t, meta).reshape(shape).contiguous().to(device) for t in tables)


class Linear(nn.Linear):
    """flax Dense(dtype=compute, param_dtype=float32): the float32 master
    weight and bias are cast to the input's dtype at each call (flax's
    promote_dtype, one rounding; a no-op once cast_matmul_weights_ has cast
    them for sampling). A Linear of the layer stack of a ``scan_layers``
    model carries the config in ``pin``: its weight is cast through K7
    (ops/convert.py, or its plain version with ``use_kernel = False``), as
    the JAX pin (dit.py:_make_scan_param_pin) casts the stacked Dense
    kernels; its bias keeps ``.to``. Under head tensor parallelism
    (parallel/sharding.py) the weight is a DTensor whose local shard is
    used, and ``style`` is "colwise" (the weight's output rows are this
    rank's heads; it adds its slice of the replicated bias) or "rowwise"
    (the input columns are; the output is this rank's partial sums, with
    the bias added on tensor rank 0 only, and the caller reduce-scatters
    them over tokens). Either way the bias's gradient is partial, as every
    replicated parameter's is under sequence parallelism."""

    pin = None
    tp = NO_TENSOR_PARALLEL
    style = None

    def pinned_weight(self, dtype):
        """The (local) weight in ``dtype`` through K7 when pinned, else None (each call casts it)."""
        if self.pin is None:
            return None
        return convert.opaque_convert(local(self.weight), dtype, plain=not self.pin.use_kernel)

    def forward(self, x, weight=None):
        """``weight``: this layer's weight already cast (by :meth:`pinned_weight`), shared by several calls."""
        if weight is None:
            weight = local(self.weight).to(x.dtype) if self.pin is None else self.pinned_weight(x.dtype)
        bias = self.bias.to(x.dtype)
        if self.style == "colwise":
            bias = self.tp.shard(bias, 0)
        elif self.style == "rowwise" and self.tp.rank:
            bias = None  # the partial sums carry the bias once, on rank 0
        return Fn.linear(x, weight, bias)


def layer_norm(x, norm: nn.LayerNorm, out_dtype):
    """flax LayerNorm(dtype=out_dtype, param_dtype=float32): statistics and
    affine in float32, result in ``out_dtype``; where the layer recomputes,
    the backward keeps ``x``, not its float32 copy (models/recompute.py)."""
    return recomputed(lambda t, w, b: Fn.layer_norm(t.float(), norm.normalized_shape, w, b, norm.eps).to(out_dtype),
                      x, norm.weight, norm.bias)


class TTTLayer(nn.Module):
    """Bidirectional-capable TTT layer. Parameter names mirror the flax tree.
    ``tp``: the tensor group (parallel/sharding.py), of one by default."""

    tp = NO_TENSOR_PARALLEL

    def __init__(self, config: ModelConfig):
        super().__init__()
        if config.ssm_layer not in ("ttt_linear", "ttt_mlp"):
            raise ValueError(f"No ttt layer of type {config.ssm_layer}")
        self.config = config
        D, H, F = config.model_dim, config.num_heads, config.head_dim
        self.wq, self.wk, self.wv, self.wo = (Linear(D, D) for _ in range(4))
        # Per-head learned inner-loop LR gate: sigmoid(x . w + b) * base_lr / F / CS.
        self.learnable_ttt_lr_weight = nn.Parameter(torch.empty(H, 1, D))
        self.learnable_ttt_lr_bias = nn.Parameter(torch.zeros(H, 1))
        self.ttt_norm_weight = nn.Parameter(torch.ones(H, F))
        self.ttt_norm_bias = nn.Parameter(torch.zeros(H, F))
        self.post_norm = nn.LayerNorm(D, eps=1e-6)
        # Fast-weight initial states (learned, shared across the batch).
        if config.ssm_layer == "ttt_linear":
            self.W1 = nn.Parameter(torch.empty(H, F, F))
            self.b1 = nn.Parameter(torch.zeros(H, 1, F))
        else:
            self.W1 = nn.Parameter(torch.empty(H, F, 4 * F))
            self.b1 = nn.Parameter(torch.zeros(H, 1, 4 * F))
            self.W2 = nn.Parameter(torch.empty(H, 4 * F, F))
            self.b2 = nn.Parameter(torch.zeros(H, 1, F))

    @property
    def eta_scale(self) -> float:
        """sigmoid(gate) * eta_scale = the reference's eta = lr / CS."""
        cfg = self.config
        return cfg.ttt_base_lr / cfg.head_dim / cfg.mini_batch_size

    def token_gate(self, hidden_states):
        """Pre-sigmoid LR-gate logits [B, H, NC, CS] float32: x . lr_weight +
        bias, with the weight rounded to the stream dtype and the products
        accumulated in float32 (the einsum's preferred_element_type)."""
        cfg = self.config
        B, L, _ = hidden_states.shape
        H = self.tp.local_heads(cfg.num_heads)
        # Where the layer recomputes, the backward keeps the stream, not its float32 copy (models/recompute.py).
        lr = recomputed(lambda x, w, b: x.float() @ w[:, 0, :].to(x.dtype).float().t() + b.reshape(1, 1, -1),
                        hidden_states, local(self.learnable_ttt_lr_weight), local(self.learnable_ttt_lr_bias))
        return lr.permute(0, 2, 1).reshape(B, H, L // cfg.mini_batch_size, cfg.mini_batch_size).contiguous()

    def pinned_weights(self, dtype):
        """wq/wk/wv/wo's weights cast through K7 once, for both directions
        (the JAX pin casts each stacked kernel once per layer body), or Nones
        when not pinned (flax's promote_dtype casts at each call)."""
        return tuple(lin.pinned_weight(dtype) for lin in (self.wq, self.wk, self.wv, self.wo))

    def forward(self, hidden_states, meta: SequenceMetadata, reverse: bool = False, weights=None):
        """One direction over the whole [B, L, D] stream; ``weights`` from
        :meth:`pinned_weights`, shared with the other direction. Under head
        tensor parallelism the output is this rank's partial sums."""
        cfg = self.config
        wq, wk, wv, wo = weights or (None,) * 4
        B, L, D = hidden_states.shape
        H, F, CS = self.tp.local_heads(cfg.num_heads), cfg.head_dim, cfg.mini_batch_size  # this rank's heads
        if L % CS:
            raise ValueError(f"Sequence len {L} must be multiple of mini batch size {CS}.")
        NC = L // CS

        x = interleave(hidden_states, meta, reverse)
        to_tm = lambda t: t.reshape(B, NC, CS, H * F)  # token-major: a pure reshape
        XQ, XK, XV = to_tm(self.wq(x, wq)), to_tm(self.wk(x, wk)), to_tm(self.wv(x, wv))
        gate = self.token_gate(x)
        del x  # the projections hold what the scan needs; free the permuted stream before it runs
        rope_cos, rope_sin = scan_rope_tables(meta, F, cfg.rope_theta, CS, hidden_states.device)

        if cfg.ssm_layer == "ttt_linear":  # K5-train / K6, K5
            mod = ttt_linear_kernel
            train, forward, forward_plain = mod.ttt_linear_train, mod.ttt_linear_forward, mod.ttt_linear_forward_plain
            state = (local(self.W1), local(self.b1))
        else:  # K1-train / K2, K1
            mod = ttt_mlp_kernel
            train, forward, forward_plain = mod.ttt_mlp_train, mod.ttt_mlp_forward, mod.ttt_mlp_forward_plain
            state = (local(self.W1), local(self.b1), local(self.W2), local(self.b2))
        args = (XQ, XK, XV, gate, rope_cos, rope_sin, local(self.ttt_norm_weight), local(self.ttt_norm_bias), *state,
                self.eta_scale)
        # The plain versions with use_kernel off, and at a CS or F that is not a multiple of 8, where the JAX
        # layer runs the ttt_scan oracle (the ops module's use_plain counts those).
        plain = mod.use_plain(cfg.use_kernel, CS, F, XQ.device)
        if torch.is_grad_enabled():  # the training kernels, or their plain versions
            # The scan's output and state checkpoints are the outputs of one custom op (K1-train / K5-train),
            # which the save_seq policy keeps across the layer's recompute (models/dit/dit.py:_ckpt_policy),
            # as JAX names them "ttt_out" and "ttt_residuals".
            XQW = train(*args, cfg.scan_checkpoint_group_size, plain=plain)
        else:
            XQW = (forward_plain if plain else forward)(*args)
        del XQ, XK, XV, args  # before the post-norm's and wo's outputs are allocated
        # Every head: the post-norm runs over all of D. Its gradient reaches this rank's features only, so the
        # gathered features' gradient is a partial sum (reduce-scattered) and post_norm's is partial too.
        out = self.tp.all_gather(XQW.reshape(B, L, H * F), D, -1)
        out = self.wo(self.tp.shard(layer_norm(out, self.post_norm, out.dtype), -1), wo)
        return undo_interleave(out, meta, reverse)  # partial sums over heads: a permutation before their reduce-scatter
