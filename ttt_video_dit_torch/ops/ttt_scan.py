"""Per-token-eta dual-form TTT-linear and TTT-MLP scans in plain PyTorch
(port of ttt_video_dit_tpu/ops/ttt_scan.py).

Their steps, ``ttt_linear_step`` and ``ttt_mlp_step``, and their loop,
``scan_mini_batches`` (which also keeps the state at the start of every
checkpoint group of K mini-batches, the last group possibly shorter), are
the body of the fused TTT kernels' plain versions (ops/ttt_linear_kernel.py,
ops/ttt_mlp_kernel.py), which add the kernels' bf16 rounding points; the
backwards' plain versions re-run each group from its checkpoint, as the JAX
scan's per-group remat does. Inputs are head-major and already preprocessed
(L2-norm, rope, LN-reconstruction target); state and products are fp32. The
eta parameterization is the per-token vector ``lr_j / CS`` (see the JAX
module's docstring for why it equals the reference's rank-1 eta matrix).

Shapes: XQ/XK/XV [B, H, NC, CS, F]; eta [B, H, NC, CS]; ln weight/bias
[H, F]; linear: W1 [B, H, F, F], b1 [B, H, 1, F]; mlp: W1 [B, H, F, 4F],
b1 [B, H, 1, 4F], W2 [B, H, 4F, F], b2 [B, H, 1, F].
"""

from __future__ import annotations

import torch

from ttt_video_dit_torch.ops.ln import gelu_bwd, gelu_tanh, ln_fused_l2_bwd, ln_fwd


def _exact(x):
    return x


def ttt_linear_step(state, XQ, XK, target, eta, ln_weight, ln_bias, rnd=_exact):
    """One dual-form TTT-linear mini-batch step on preprocessed float32
    operands: ``state`` = (W1, b1), XQ/XK/target [..., CS, F], eta [..., CS].
    ``rnd`` rounds to the compute dtype and back; the fused kernel's plain
    version (ops/ttt_linear_kernel.py) passes a bf16 rounding, so the step
    rounds where _linear_kernel does (W.astype(dt) for Z1 and XQ @ W, the
    eta-scaled gradient Gs, attn). Returns (new_state, XQW) with XQW in
    float32."""
    W1, b1 = state
    Wc = rnd(W1)
    Z1 = XK @ Wc + b1
    grad = ln_fused_l2_bwd(Z1, target, ln_weight, ln_bias)
    G = rnd(eta[..., None] * grad)

    attn = rnd(XQ @ XK.transpose(-1, -2))
    b1_new = b1 - G.sum(dim=-2, keepdim=True)
    Z1_bar = XQ @ Wc - attn @ G + b1_new
    W1_new = W1 - XK.transpose(-1, -2) @ G

    XQW = XQ + ln_fwd(Z1_bar, ln_weight, ln_bias)
    return (W1_new, b1_new), XQW


def ttt_mlp_step(state, XQ, XK, target, eta, ln_weight, ln_bias, rnd=_exact):
    """One dual-form TTT-MLP mini-batch step (2-layer GELU fast-weight net) on
    preprocessed float32 operands: ``state`` = (W1, b1, W2, b2), XQ/XK/target
    [..., CS, F], eta [..., CS]. ``rnd`` rounds a matmul operand to the compute
    dtype and back; the default leaves everything float32, and the fused
    kernel's plain version (ops/ttt_mlp_kernel.py) passes a bf16 rounding, so
    the step rounds exactly where _mlp_kernel does (W.astype(dt), X2c,
    bf16(grad_z2), G1, G2, attn1, attn2, X2_barc). Returns (new_state, XQW)
    with XQW in float32."""
    W1, b1, W2, b2 = state
    W1c, W2c = rnd(W1), rnd(W2)

    Z1 = XK @ W1c + b1
    X2 = rnd(gelu_tanh(Z1))
    Z2 = X2 @ W2c + b2

    grad_z2 = ln_fused_l2_bwd(Z2, target, ln_weight, ln_bias)
    grad_z1 = (rnd(grad_z2) @ W2c.transpose(-1, -2)) * gelu_bwd(Z1)

    eta_f = eta[..., None]
    G1 = rnd(eta_f * grad_z1)
    G2 = rnd(eta_f * grad_z2)

    attn1 = rnd(XQ @ XK.transpose(-1, -2))
    b1_new = b1 - G1.sum(dim=-2, keepdim=True)
    Z1_bar = XQ @ W1c - attn1 @ G1 + b1_new
    X2_bar = rnd(gelu_tanh(Z1_bar))

    attn2 = rnd(X2_bar @ X2.transpose(-1, -2))
    b2_new = b2 - G2.sum(dim=-2, keepdim=True)
    Z2_bar = X2_bar @ W2c - attn2 @ G2 + b2_new

    W1_new = W1 - XK.transpose(-1, -2) @ G1
    W2_new = W2 - X2.transpose(-1, -2) @ G2

    XQW = XQ + ln_fwd(Z2_bar, ln_weight, ln_bias)
    return (W1_new, b1_new, W2_new, b2_new), XQW


def scan_mini_batches(step_fn, state, num_mini_batch: int, checkpoint_group: int | None = None):
    """Run ``step_fn(state, n) -> (state, out)`` for n = 0 .. num_mini_batch - 1.
    Returns (final_state, outs, checkpoints): with ``checkpoint_group`` K,
    checkpoints[g] is the state before mini-batch g * K (the states are
    tuples of tensors that the steps replace, never modify)."""
    outs, checkpoints = [], []
    for n in range(num_mini_batch):
        if checkpoint_group and n % checkpoint_group == 0:
            checkpoints.append(state)
        state, out = step_fn(state, n)
        outs.append(out)
    return state, outs, checkpoints


def ttt_linear_mini_batch(state, xs, ln_weight, ln_bias):
    """One float32 TTT-linear mini-batch step. ``state`` = (W1, b1) in fp32;
    ``xs`` = (XQ, XK, XV, eta) of one mini-batch, with XV - XK the
    LN-reconstruction target. Returns (new_state, XQW) with XQW in fp32."""
    XQ, XK, XV, eta = (x.float() for x in xs)
    return ttt_linear_step(state, XQ, XK, XV - XK, eta, ln_weight, ln_bias)


def ttt_mlp_mini_batch(state, xs, ln_weight, ln_bias):
    """One float32 mini-batch step. ``state`` = (W1, b1, W2, b2) in fp32;
    ``xs`` = (XQ, XK, XV, eta) of one mini-batch, with XV - XK the
    LN-reconstruction target. Returns (new_state, XQW) with XQW in fp32."""
    XQ, XK, XV, eta = (x.float() for x in xs)
    return ttt_mlp_step(state, XQ, XK, XV - XK, eta, ln_weight, ln_bias)


def _scan(mini_batch, XQ, XK, XV, eta, ttt_norm_weight, ttt_norm_bias, state):
    ln_w = ttt_norm_weight.float()[:, None, :]
    ln_b = ttt_norm_bias.float()[:, None, :]
    state = tuple(s.float() for s in state)
    step = lambda s, n: mini_batch(s, (XQ[:, :, n], XK[:, :, n], XV[:, :, n], eta[:, :, n]), ln_w, ln_b)
    _, outs, _ = scan_mini_batches(step, state, XQ.shape[2])
    return torch.stack(outs, dim=2).to(XQ.dtype)


def ttt_linear(XQ, XK, XV, eta, ttt_norm_weight, ttt_norm_bias, W1_init, b1_init):
    """Full TTT-linear scan over the NC axis. Returns XQW [B, H, NC, CS, F] in XQ.dtype."""
    return _scan(ttt_linear_mini_batch, XQ, XK, XV, eta, ttt_norm_weight, ttt_norm_bias, (W1_init, b1_init))


def ttt_mlp(XQ, XK, XV, eta, ttt_norm_weight, ttt_norm_bias, W1_init, b1_init, W2_init, b2_init):
    """Full TTT-MLP scan over the NC axis. Returns XQW [B, H, NC, CS, F] in XQ.dtype."""
    return _scan(ttt_mlp_mini_batch, XQ, XK, XV, eta, ttt_norm_weight, ttt_norm_bias,
                 (W1_init, b1_init, W2_init, b2_init))
