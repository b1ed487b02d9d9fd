"""Layer-norm primitives of the TTT inner loop (port of ttt_video_dit_tpu/ops/ln.py).

Parity traps kept from the JAX package: the inner layer norm adds eps to the
*biased* variance, and GELU is the tanh approximation.
"""

from __future__ import annotations

import torch

from ttt_video_dit_torch.ops.rope import pair_swap


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


# ------------------------------------------------------------ closed-form VJPs
# The step VJP of the TTT-MLP backward (K2, ops/ttt_mlp_kernel.py) is written
# out by hand, as the JAX package's fused backward kernel writes it
# (ttt_video_dit_tpu/ops/ln.py:46-100, ops/pallas/ttt_backward.py:38-159).
# tests/test_torch_ttt_backward.py holds each against torch.autograd in float64.


def gelu_bwd2(x):
    """Second derivative of the tanh-approximated GELU (the derivative of gelu_bwd)."""
    a = 0.79788456
    c3 = 0.1070322243  # 3c, where u = a x + c x^3
    u = a * x + (c3 / 3.0) * x * x * x
    T = torch.tanh(u)
    up = a + c3 * x * x
    upp = 2.0 * c3 * x
    return (1.0 - T * T) * (up + 0.5 * x * (upp - 2.0 * T * up * up))


def ln_stats(x, eps: float = 1e-8):
    """(x_hat, std) of the inner layer norm (eps on the biased variance)."""
    mu = x.mean(dim=-1, keepdim=True)
    std = torch.sqrt(x.var(dim=-1, keepdim=True, correction=0) + eps)
    return (x - mu) / std, std


def ln_fused_l2(x_hat, std, target, gamma, beta):
    """ln_fused_l2_bwd from precomputed statistics (the backward's form)."""
    gx = gamma * (gamma * x_hat + beta - target)
    m2 = (gx * x_hat).mean(dim=-1, keepdim=True)
    return (gx - gx.mean(dim=-1, keepdim=True) - x_hat * m2) / std


def ln_fwd_vjp_rows(x_hat, std, gamma, u):
    """VJP of ln_fwd given its statistics and output cotangent ``u``: (dx,
    dgamma_rows, dbeta_rows), the affine cotangents left per row."""
    w = gamma * u
    dx = (w - w.mean(dim=-1, keepdim=True) - x_hat * (w * x_hat).mean(dim=-1, keepdim=True)) / std
    return dx, u * x_hat, u


def ln_fwd_vjp(x, gamma, beta, u, eps: float = 1e-8):
    """VJP of ln_fwd w.r.t. (x, gamma, beta); dgamma/dbeta summed over the row axis (-2)."""
    x_hat, std = ln_stats(x, eps)
    dx, dg, db = ln_fwd_vjp_rows(x_hat, std, gamma, u)
    return dx, dg.sum(dim=-2, keepdim=True), db.sum(dim=-2, keepdim=True)


def ln_fused_l2_vjp_rows(x_hat, std, target, gamma, beta, u):
    """VJP of the fused LN-L2 gradient (the second-order LN term) given its
    statistics: (dx, dtarget, dgamma_rows, dbeta_rows)."""
    D = x_hat.shape[-1]
    y = gamma * x_hat + beta
    gx = gamma * (y - target)
    m2 = (gx * x_hat).mean(dim=-1, keepdim=True)
    z = (gx - gx.mean(dim=-1, keepdim=True) - x_hat * m2) / std

    mean_u = u.mean(dim=-1, keepdim=True)
    mean_ux = (u * x_hat).mean(dim=-1, keepdim=True)
    dgx = (u - mean_u - x_hat * mean_ux) / std  # the row-centering map is self-adjoint
    dx_hat = -(m2 * u + gx * mean_ux) / std + gamma * gamma * dgx
    dstd = -(u * z).sum(dim=-1, keepdim=True) / std
    dx = (dx_hat - dx_hat.mean(dim=-1, keepdim=True)
          - x_hat * (dx_hat * x_hat).mean(dim=-1, keepdim=True)) / std + dstd * x_hat / D
    dtarget = -gamma * dgx
    return dx, dtarget, dgx * (y - target) + dgx * gamma * x_hat, dgx * gamma


def ln_fused_l2_bwd_vjp(x, l2_target, gamma, beta, u, eps: float = 1e-8):
    """VJP of ln_fused_l2_bwd w.r.t. (x, l2_target, gamma, beta);
    dgamma/dbeta summed over the row axis (-2)."""
    x_hat, std = ln_stats(x, eps)
    dx, dt, dg, db = ln_fused_l2_vjp_rows(x_hat, std, l2_target, gamma, beta, u)
    return dx, dt, dg.sum(dim=-2, keepdim=True), db.sum(dim=-2, keepdim=True)


def target_ln_vjp(t_hat, s, gamma, u, eps: float = 1e-8):
    """VJP of the LN-reconstruction target gamma * t_hat + beta w.r.t. t, for
    the unbiased-variance norm with eps on the std (s = sqrt(var) + eps):
    (dt, dgamma_rows, dbeta_rows). Zero-variance rows give zeros, not NaNs."""
    n = t_hat.shape[-1]
    g = gamma * u
    sqrtv = torch.clamp(s - eps, min=1e-20)
    dt = (g - g.mean(dim=-1, keepdim=True)) / s - t_hat * ((g * t_hat).sum(dim=-1, keepdim=True) / ((n - 1) * sqrtv))
    return dt, u * t_hat, u


def l2norm_vjp(x_raw, u, eps: float = 1e-12):
    """VJP of y = x / max(||x||, eps)."""
    nrm = torch.sqrt((x_raw * x_raw).sum(dim=-1, keepdim=True))
    m = torch.clamp(nrm, min=eps)
    proj = (u * x_raw).sum(dim=-1, keepdim=True)
    corr = torch.where(nrm > eps, proj / (m * m * torch.clamp(nrm, min=1e-20)), torch.zeros_like(proj))
    return u / m - x_raw * corr


def rope_vjp(u, cos, sin):
    """VJP of the interleaved-pair rope x*cos + pair_swap(x)*sin: u*cos -
    pair_swap(u)*sin (the pair swap is antisymmetric)."""
    return u * cos - pair_swap(u) * sin
