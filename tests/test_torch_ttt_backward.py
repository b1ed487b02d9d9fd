"""PyTorch port parity: the TTT-MLP training scan (K1-train: output and state
checkpoints), its backward (K2), the closed-form VJPs K2 uses, and the
autograd Function around them (ttt_video_dit_torch/ops), against the JAX
package on the CPU and against torch.autograd in float64.

The JAX side is the Pallas kernels in interpret mode, in their fused-preproc,
token-major, in-kernel-gate form (ttt_forward.ttt_mlp_forward,
ttt_backward.ttt_mlp_backward), as tests/test_pallas_kernels.py runs them.
The JAX kernels keep bias checkpoints as 8 rows x 0.125 and return
row-replicated, per-batch bias/LN gradients; the tests reduce them as
ttt_vjp.py:_mlp_bwd_pre does (and sum over the batch, as the port's shared
parameters need). NC is not a multiple of the checkpoint group K, so the
ragged last group is covered. Tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from ttt_video_dit_torch.ops import ln as t_ln  # noqa: E402
from ttt_video_dit_torch.ops import ttt_mlp_kernel as tk  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_backward, ttt_forward  # noqa: E402

torch.set_num_threads(1)
f32 = np.float32
IN = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")


def _args(rng, B, H, NC, CS, F, std=0.02):
    """Raw token-major q/k/v, gate logits, interleaved rope tables, LN affine, initial state (numpy float32)."""
    x = lambda: rng.standard_normal((B, NC, CS, H * F)).astype(f32)
    ang = rng.uniform(0, 6.3, (NC, CS, F // 2)).astype(f32)
    n = lambda *s, s_=std: (s_ * rng.standard_normal(s)).astype(f32)
    return dict(
        XQ=x(), XK=x(), XV=x(), gate=rng.standard_normal((B, H, NC, CS)).astype(f32),
        rope_cos=np.repeat(np.cos(ang), 2, -1), rope_sin=np.repeat(np.sin(ang), 2, -1),
        ln_w=(1 + n(H, F, s_=0.1)).astype(f32), ln_b=n(H, F, s_=0.1),
        W1=n(H, F, 4 * F), b1=n(H, 1, 4 * F), W2=n(H, 4 * F, F), b2=n(H, 1, F),
    )


def _torch(a, dtype=torch.float32):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    for k in ("XQ", "XK", "XV"):
        out[k] = out[k].to(dtype)
    return out


def _jax_forward(a, scale, K, dtype=jnp.float32):
    """Pallas K1 (interpret): (out, W1_ck, b1_ck, W2_ck, b2_ck) with the 8-row bias checkpoints summed."""
    B = a["XQ"].shape[0]
    tile = lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (B,) + p.shape)
    out, w1, b1, w2, b2 = ttt_forward.ttt_mlp_forward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")),
        tile(a["W1"]), tile(a["b1"]), tile(a["W2"]), tile(a["b2"]), K, interpret=True,
        rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=scale, token_major=True,
    )
    return out, w1, b1, w2, b2


def _jax_backward(a, ckpts, dout, scale, K, dtype=jnp.float32):
    """Pallas K2 (interpret), reduced as _mlp_bwd_pre and summed over the batch:
    (dXQ, dXK, dXV, d_gate, dW1, db1, dW2, db2, dln_w, dln_b) as numpy float32."""
    outs = ttt_backward.ttt_mlp_backward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")), *ckpts, jnp.asarray(dout).astype(dtype), K,
        interpret=True, rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=scale,
        token_major=True,
    )
    dXQ, dXK, dXV, de, dW1, db1, dW2, db2, dlnw, dlnb = (np.asarray(o.astype(jnp.float32)) for o in outs)
    return (dXQ, dXK, dXV, de, dW1.sum(0), db1[:, :, 0:1].sum(0), dW2.sum(0), db2[:, :, 0:1].sum(0),
            dlnw.sum(axis=(0, 2)), dlnb.sum(axis=(0, 2)))


def _port_ckpts(jax_ckpts):
    """The JAX checkpoints as the port's compact ones (bias rows summed)."""
    w1, b1, w2, b2 = (np.array(c, f32) for c in jax_ckpts)
    return [torch.from_numpy(c) for c in (w1, b1.sum(-2, keepdims=True), w2, b2.sum(-2, keepdims=True))]


def _close_scaled(got, want, tol):
    """|got - want| <= tol * max|want| elementwise (gradients span orders of magnitude)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max error {err:.3g} > {tol} x max|want| {scale:.3g}"


# ------------------------------------------------------------ closed-form VJPs


def _vjp_case(name, rng):
    x = lambda *s: torch.from_numpy(rng.standard_normal(s)).double()
    X, T, G, Bt, U = x(3, 5, 16), x(3, 5, 16), x(16), x(16), x(3, 5, 16)
    if name == "ln_fwd_vjp":
        return lambda X, G, Bt: t_ln.ln_fwd(X, G, Bt), (X, G, Bt), lambda: t_ln.ln_fwd_vjp(X, G, Bt, U), U
    if name == "ln_fused_l2_bwd_vjp":
        return (lambda X, T, G, Bt: t_ln.ln_fused_l2_bwd(X, T, G, Bt), (X, T, G, Bt),
                lambda: t_ln.ln_fused_l2_bwd_vjp(X, T, G, Bt, U), U)
    if name == "gelu_bwd2":
        return lambda X: t_ln.gelu_bwd(X), (X,), lambda: (U * t_ln.gelu_bwd2(X),), U
    if name == "target_ln_vjp":
        def target(X):
            mu = X.mean(-1, keepdim=True)
            s = torch.sqrt(X.var(-1, keepdim=True, correction=1)) + 1e-8
            return G * (X - mu) / s + Bt
        s = torch.sqrt(X.var(-1, keepdim=True, correction=1)) + 1e-8
        t_hat = (X - X.mean(-1, keepdim=True)) / s
        return target, (X,), lambda: t_ln.target_ln_vjp(t_hat, s, G, U)[:1], U
    if name == "l2norm_vjp":
        return (lambda X: X / torch.clamp(X.norm(dim=-1, keepdim=True), min=1e-12), (X,),
                lambda: (t_ln.l2norm_vjp(X, U),), U)
    cos, sin = (torch.from_numpy(np.repeat(f(rng.uniform(0, 6.3, (5, 8))), 2, -1)) for f in (np.cos, np.sin))
    return (lambda X: X * cos + t_ln.pair_swap(X) * sin, (X,), lambda: (t_ln.rope_vjp(U, cos, sin),), U)


@pytest.mark.parametrize("name", ["ln_fwd_vjp", "ln_fused_l2_bwd_vjp", "gelu_bwd2", "target_ln_vjp", "l2norm_vjp",
                                  "rope_vjp"])
def test_closed_form_vjps_match_autograd(rng, name):
    """Each closed-form VJP of ops/ln.py against torch.autograd, float64, to 1e-10."""
    fn, inputs, vjp, u = _vjp_case(name, rng)
    inputs = [t.clone().requires_grad_(True) for t in inputs]
    want = torch.autograd.grad(fn(*inputs), inputs, u)
    got = vjp()
    for g, w, x in zip(got, want, inputs):  # dgamma/dbeta come per row block: sum them to the parameter's shape
        np.testing.assert_allclose(g.reshape(-1, *x.shape).sum(0).numpy(), w.numpy(), rtol=1e-10, atol=1e-10)


# ------------------------------------------------------------ K1-train


@pytest.mark.parametrize("CS,NC,K", [(8, 6, 4), (8, 5, 2)])
def test_k1_train_plain_matches_pallas(rng, CS, NC, K):
    """K1-train's plain version against the Pallas kernel (interpret), float32:
    output and all four checkpoints, |d| <= 2e-5 (1 + |jax|)."""
    B, H, F = 2, 2, 16
    a = _args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
    got = tk.ttt_mlp_forward_plain(**_torch(a), eta_scale=scale, checkpoint_group=K)
    want = _jax_forward(a, scale, K)
    want = (want[0], *(c.numpy() for c in _port_ckpts(want[1:])))
    assert [tuple(g.shape) for g in got] == [tuple(np.shape(w)) for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("CS,NC,K", [(16, 5, 2), (64, 3, 2), (32, 3, 2), (48, 3, 2)])
def test_k1_train_plain_matches_pallas_bf16(rng, CS, NC, K):
    """bf16 q/k/v at the CUDA kernels' head dim (F = 64): both round at the
    same points, only float32 summation order differs. Outputs within 1e-2
    absolute and relative (a few bf16 ulps); fp32 checkpoints within 1e-4 of
    their scale."""
    B, H, F = 1, 2, 64
    a = _args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
    got = tk.ttt_mlp_forward_plain(**_torch(a, torch.bfloat16), eta_scale=scale, checkpoint_group=K)
    want = _jax_forward(a, scale, K, jnp.bfloat16)
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)), rtol=1e-2, atol=1e-2)
    for g, w in zip(got[1:], _port_ckpts(want[1:])):
        _close_scaled(g.numpy(), w.numpy(), 1e-4)


# ------------------------------------------------------------ K2


@pytest.mark.parametrize("CS,NC,K", [(8, 6, 4), (8, 3, 1)])
def test_k2_plain_matches_pallas(rng, CS, NC, K):
    """K2's plain two-pass backward against the Pallas backward (interpret),
    float32, from the same checkpoints: every gradient within 1e-4 of its
    scale (float32 summation order through K steps of a second-order VJP)."""
    B, H, F = 2, 2, 16
    a = _args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
    jck = _jax_forward(a, scale, K)[1:]
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a)
    got = tk.ttt_mlp_backward_plain(*(t[k] for k in IN), *_port_ckpts(jck), torch.from_numpy(dout), scale, K)
    want = _jax_backward(a, jck, dout, scale, K)
    for name, g, w in zip(("dXQ", "dXK", "dXV", "dgate", "dW1", "db1", "dW2", "db2", "dlnw", "dlnb"), got, want):
        assert tuple(g.shape) == w.shape, name
        _close_scaled(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("CS,NC,K", [(16, 3, 2), (64, 2, 1), (32, 3, 2), (48, 3, 2)])
def test_k2_plain_matches_pallas_bf16(rng, CS, NC, K):
    """bf16 q/k/v/dout at F = 64: both backwards round at the same points
    (every .astype(dt) of ttt_backward.py:235-399); every gradient within
    2e-2 of its scale (bf16 rounding flips from float32 summation order,
    carried through the step VJP)."""
    B, H, F = 1, 2, 64
    a = _args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
    jck = _jax_forward(a, scale, K, jnp.bfloat16)[1:]
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a, torch.bfloat16)
    got = tk.ttt_mlp_backward_plain(*(t[k] for k in IN), *_port_ckpts(jck),
                                    torch.from_numpy(dout).bfloat16(), scale, K)
    want = _jax_backward(a, jck, dout, scale, K, jnp.bfloat16)
    for g, w in zip(got, want):
        _close_scaled(g.float().numpy(), w, 2e-2)


LARGE_ETA = [0.1, 1.0]  # eta_scale 4,096x and 40,960x the 3 s training slice's (ttt_base_lr / 64 / 64)


@pytest.mark.parametrize("scale", LARGE_ETA)
def test_k1_train_plain_matches_pallas_bf16_large_eta(rng, scale):
    """K1-train's plain version against the Pallas kernel (interpret) at the
    CUDA kernel's shape (bf16 q/k/v, F = CS = 64) and at the large eta where
    the carried state moves the output most (the eta of the CUDA kernel's
    state-update checks): output within 1e-2 absolute and relative, fp32
    checkpoints within 1e-3 of their scale (bf16 rounding flips from float32
    summation order, grown by the larger updates)."""
    B, H, NC, CS, F, K = 1, 2, 3, 64, 64, 2
    a = _args(rng, B, H, NC, CS, F)
    got = tk.ttt_mlp_forward_plain(**_torch(a, torch.bfloat16), eta_scale=scale, checkpoint_group=K)
    want = _jax_forward(a, scale, K, jnp.bfloat16)
    np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)), rtol=1e-2, atol=1e-2)
    for g, w in zip(got[1:], _port_ckpts(want[1:])):
        _close_scaled(g.numpy(), w.numpy(), 1e-3)


@pytest.mark.parametrize("scale", LARGE_ETA)
def test_k2_plain_matches_pallas_bf16_large_eta(rng, scale):
    """K2's plain version against the Pallas backward (interpret) at F = CS =
    64, bf16, large eta, from the same checkpoints: every gradient within
    2e-2 of its scale, as at the slice's eta."""
    B, H, NC, CS, F, K = 1, 2, 3, 64, 64, 2
    a = _args(rng, B, H, NC, CS, F)
    jck = _jax_forward(a, scale, K, jnp.bfloat16)[1:]
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a, torch.bfloat16)
    got = tk.ttt_mlp_backward_plain(*(t[k] for k in IN), *_port_ckpts(jck),
                                    torch.from_numpy(dout).bfloat16(), scale, K)
    want = _jax_backward(a, jck, dout, scale, K, jnp.bfloat16)
    for g, w in zip(got, want):
        _close_scaled(g.float().numpy(), w, 2e-2)


def _tolerances_apart(a, b, atol, rtol):
    """max |a - b| / (atol + rtol |b|): how many of a tolerance two results are apart."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


@pytest.mark.parametrize("scale", LARGE_ETA)
def test_training_plain_versions_move_with_eta(rng, scale):
    """The guard the CUDA training kernels' large-eta checks rely on: at bf16,
    F = CS = 64, K1-train's plain output is at least 10 of the kernels'
    elementwise tolerances (2e-2 + 2e-2 |x|) from its eta_scale = 0 output,
    its later checkpoints at least 10 of the checkpoint tolerance (1e-3 of
    their scale) from eta = 0's, and K2's d_gate is far from 0 (at eta = 0 it
    is exactly 0), so a kernel that drops or garbles the state update, or the
    eta path of the backward, cannot pass."""
    B, H, NC, CS, F, K = 1, 2, 3, 64, 64, 2
    t = _torch(_args(rng, B, H, NC, CS, F), torch.bfloat16)
    got = tk.ttt_mlp_forward_plain(**t, eta_scale=scale, checkpoint_group=K)
    still = tk.ttt_mlp_forward_plain(**t, eta_scale=0.0, checkpoint_group=K)
    assert _tolerances_apart(got[0], still[0], 2e-2, 2e-2) >= 10
    for g, s in zip(got[1:], still[1:]):  # group 1 starts after K updates
        scale_ck = float(g[:, :, 1:].abs().max())
        assert float((g[:, :, 1:] - s[:, :, 1:]).abs().max()) >= 10 * 1e-3 * scale_ck
    dout = torch.from_numpy(rng.standard_normal(t["XQ"].shape).astype(f32)).bfloat16()
    dgate = tk.ttt_mlp_backward_plain(*(t[k] for k in IN), *got[1:], dout, scale, K)[3]
    assert float(dgate.abs().max()) >= 10 * 2e-2


def test_check_aligned_refuses_an_offset_view():
    """The wrappers' 16-byte rule: a contiguous view one bf16 element into its
    storage is refused, the storage itself and a view 8 elements in are taken
    (data_ptr works on the CPU)."""
    base = torch.zeros(4 * 64 + 8, dtype=torch.bfloat16)
    tk.check_aligned("x", base)
    tk.check_aligned("x", base[8:])
    with pytest.raises(ValueError, match="16-byte"):
        tk.check_aligned("x", base[1:])
    with pytest.raises(ValueError, match="16-byte"):
        tk.check_aligned("x", torch.zeros(9)[1:])


def _f64_inputs(B=2, H=2, NC=5, CS=4, F=8):
    g = torch.Generator().manual_seed(0)
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, dtype=torch.float64) * std
    ang = torch.rand(NC, CS, F // 2, generator=g, dtype=torch.float64) * 6.3
    return dict(XQ=r(B, NC, CS, H * F), XK=r(B, NC, CS, H * F), XV=r(B, NC, CS, H * F), gate=r(B, H, NC, CS),
                rope_cos=torch.cos(ang).repeat_interleave(2, -1), rope_sin=torch.sin(ang).repeat_interleave(2, -1),
                ln_w=1 + r(H, F, std=0.1), ln_b=r(H, F, std=0.1), W1=r(H, F, 4 * F, std=0.3),
                b1=r(H, 1, 4 * F, std=0.3), W2=r(H, 4 * F, F, std=0.3), b2=r(H, 1, F, std=0.3))


DIFF = ("XQ", "XK", "XV", "gate", "ln_w", "ln_b", "W1", "b1", "W2", "b2")


def test_k2_plain_matches_autograd_float64():
    """K2's plain version against torch.autograd through K1-train's plain
    version, float64 (no rounding), NC = 5 with K = 2: every gradient to 1e-9
    of its scale."""
    a = _f64_inputs()
    for k in DIFF:
        a[k].requires_grad_(True)
    out, *ck = tk.ttt_mlp_forward_plain(**a, eta_scale=0.5, checkpoint_group=2)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    want = dict(zip(DIFF, torch.autograd.grad(out, [a[k] for k in DIFF], dout)))
    with torch.no_grad():
        got = tk.ttt_mlp_backward_plain(*(a[k].detach() for k in IN), *ck, dout, 0.5, 2)
    for name, g in zip(("XQ", "XK", "XV", "gate", "W1", "b1", "W2", "b2", "ln_w", "ln_b"), got):
        _close_scaled(g.numpy(), want[name].numpy(), 1e-9)


def test_function_gradients_match_autograd_float64():
    """TTTMLPFunction (K1-train forward, K2 backward; CPU tensors take the plain
    versions) gives autograd's gradients of the plain forward, float64, to
    1e-9 of their scale, and the same output."""
    a = _f64_inputs(B=1, NC=3)
    for k in DIFF:
        a[k].requires_grad_(True)
    dout = torch.randn(1, 3, 4, 16, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    out = tk.ttt_mlp_train(*(a[k] for k in IN), a["W1"], a["b1"], a["W2"], a["b2"], 0.5, 2)
    got = torch.autograd.grad(out, [a[k] for k in DIFF], dout)
    ref = tk.ttt_mlp_forward_plain(**a, eta_scale=0.5)
    want = torch.autograd.grad(ref, [a[k] for k in DIFF], dout)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    for g, w in zip(got, want):
        _close_scaled(g.numpy(), w.numpy(), 1e-9)


def test_train_wrappers_take_plain_versions_on_cpu(rng):
    a = _torch(_args(rng, 1, 2, 3, 8, 16))
    got = tk.ttt_mlp_forward_train(**a, eta_scale=1e-3, checkpoint_group=2)
    want = tk.ttt_mlp_forward_plain(**a, eta_scale=1e-3, checkpoint_group=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    dout = torch.from_numpy(rng.standard_normal(a["XQ"].shape).astype(f32))
    got = tk.ttt_mlp_backward(*(a[k] for k in IN), *want[1:], dout, 1e-3, 2)
    for g, w in zip(got, tk.ttt_mlp_backward_plain(*(a[k] for k in IN), *want[1:], dout, 1e-3, 2)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
