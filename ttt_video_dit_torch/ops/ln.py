"""Layer-norm primitives of the TTT inner loop (port of ttt_video_dit_tpu/ops/ln.py).

Parity traps kept from the JAX package: the inner layer norm adds eps to the
*biased* variance, and GELU is the tanh approximation.
"""

from __future__ import annotations

import torch


def ln_fwd(x, gamma, beta, eps: float = 1e-8):
    """LayerNorm over the last dim: gamma * (x - mu) / sqrt(var + eps) + beta."""
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    x_hat = (x - mu) / torch.sqrt(var + eps)
    return gamma * x_hat + beta


def ln_fused_l2_bwd(x, l2_target, gamma, beta, eps: float = 1e-8):
    """d/dx [ 0.5 * || LN_{gamma,beta}(x) - l2_target ||^2 ], fused: the
    inner-loop gradient of the TTT reconstruction objective."""
    D = x.shape[-1]
    mu = x.mean(dim=-1, keepdim=True)
    var = x.var(dim=-1, keepdim=True, correction=0)
    std = torch.sqrt(var + eps)
    x_hat = (x - mu) / std

    y = gamma * x_hat + beta
    grad_output = y - l2_target
    grad_x_hat = grad_output * gamma
    return (
        (1.0 / D)
        * (
            D * grad_x_hat
            - grad_x_hat.sum(dim=-1, keepdim=True)
            - x_hat * (grad_x_hat * x_hat).sum(dim=-1, keepdim=True)
        )
        / std
    )


def gelu_tanh(x):
    """GELU with the tanh approximation (F.gelu(approximate='tanh'))."""
    return 0.5 * x * (1.0 + torch.tanh(0.79788456 * x * (1.0 + 0.044715 * x * x)))


def gelu_bwd(x):
    """Closed-form derivative of the tanh-approximated GELU."""
    tanh_out = torch.tanh(0.79788456 * x * (1.0 + 0.044715 * x * x))
    return 0.5 * x * ((1.0 - tanh_out * tanh_out) * (0.79788456 + 0.1070322243 * x * x)) + 0.5 * (1.0 + tanh_out)
