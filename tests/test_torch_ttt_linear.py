"""PyTorch port parity: the TTT-linear scan (K5 for sampling and training:
output and state checkpoints), its backward (K6), the step and scan of
ops/ttt_scan.py, and the autograd Function around them
(ttt_video_dit_torch/ops/ttt_linear_kernel.py), against the JAX package on
the CPU and against torch.autograd in float64.

The JAX side is the Pallas kernels in interpret mode, in their
fused-preproc, token-major, in-kernel-gate form (ttt_forward.ttt_linear_forward,
ttt_backward.ttt_linear_backward, as ttt_vjp.py:ttt_linear_fused_pre calls
them and tests/test_pallas_kernels.py runs them). The JAX kernels keep bias
checkpoints as 8 rows x 0.125 and return row-replicated, per-batch bias and
LN gradients; the tests reduce them as ttt_vjp.py:_linear_bwd_pre does (and
sum over the batch, as the port's shared parameters need). Several cases
have NC not a multiple of the checkpoint group K, so the ragged last group
is covered. Tolerances are stated per test.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ttt_video_dit_torch.ops import ttt_linear_kernel as tk  # noqa: E402
from ttt_video_dit_torch.ops import ttt_scan as t_scan  # noqa: E402
from ttt_video_dit_tpu.ops import ttt_scan as j_scan  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_backward, ttt_forward  # noqa: E402

torch.set_num_threads(1)
f32 = np.float32
IN = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")
GRADS = ("dXQ", "dXK", "dXV", "d_gate", "dW1", "db1", "dln_w", "dln_b")


def _args(rng, B, H, NC, CS, F, std=0.02):
    """Raw token-major q/k/v, gate logits, interleaved rope tables, LN affine, initial state (numpy float32)."""
    x = lambda: rng.standard_normal((B, NC, CS, H * F)).astype(f32)
    ang = rng.uniform(0, 6.3, (NC, CS, F // 2)).astype(f32)
    n = lambda *s, s_=std: (s_ * rng.standard_normal(s)).astype(f32)
    return dict(
        XQ=x(), XK=x(), XV=x(), gate=rng.standard_normal((B, H, NC, CS)).astype(f32),
        rope_cos=np.repeat(np.cos(ang), 2, -1), rope_sin=np.repeat(np.sin(ang), 2, -1),
        ln_w=(1 + n(H, F, s_=0.1)).astype(f32), ln_b=n(H, F, s_=0.1), W1=n(H, F, F), b1=n(H, 1, F),
    )


def _torch(a, dtype=torch.float32):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    for k in ("XQ", "XK", "XV"):
        out[k] = out[k].to(dtype)
    return out


def _jax_forward(a, scale, K, dtype=jnp.float32):
    """Pallas K5 (interpret): (out, W1_ck, b1_ck) as the JAX kernel returns them (8-row bias checkpoints)."""
    B = a["XQ"].shape[0]
    tile = lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (B,) + p.shape)
    return ttt_forward.ttt_linear_forward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")), tile(a["W1"]), tile(a["b1"]), K, interpret=True,
        rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=scale, token_major=True,
    )


def _jax_backward(a, ckpts, dout, scale, K, dtype=jnp.float32):
    """Pallas K6 (interpret), reduced as _linear_bwd_pre and summed over the
    batch: (dXQ, dXK, dXV, d_gate, dW1, db1, dln_w, dln_b) as numpy float32."""
    outs = ttt_backward.ttt_linear_backward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")), *ckpts, jnp.asarray(dout).astype(dtype), K,
        interpret=True, rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=scale,
        token_major=True,
    )
    dXQ, dXK, dXV, de, dW1, db1, dlnw, dlnb = (np.asarray(o.astype(jnp.float32)) for o in outs)
    return dXQ, dXK, dXV, de, dW1.sum(0), db1[:, :, 0:1].sum(0), dlnw.sum(axis=(0, 2)), dlnb.sum(axis=(0, 2))


def _port_ckpts(jax_ckpts):
    """The JAX checkpoints as the port's compact ones (the 8 bias rows x 0.125 summed)."""
    w1, b1 = (np.array(c, f32) for c in jax_ckpts)
    return [torch.from_numpy(w1), torch.from_numpy(b1.sum(-2, keepdims=True))]


def _close_scaled(got, want, tol):
    """|got - want| <= tol * max|want| elementwise (gradients span orders of magnitude)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max error {err:.3g} > {tol} x max|want| {scale:.3g}"


# ------------------------------------------------------------ K5


@pytest.mark.parametrize("CS,NC,K", [(8, 6, 4), (8, 5, 2), (16, 3, 3), (8, 7, 3)])
def test_k5_plain_matches_pallas(rng, CS, NC, K):
    """K5's plain version against the Pallas kernel (interpret), float32:
    output and both checkpoints, |d| <= 2e-5 (1 + |jax|) (float32 summation
    order)."""
    B, H, F = 2, 2, 16
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    got = tk.ttt_linear_forward_plain(**_torch(a), eta_scale=scale, checkpoint_group=K)
    want = _jax_forward(a, scale, K)
    want = (np.asarray(want[0]), *(c.numpy() for c in _port_ckpts(want[1:])))
    assert [tuple(g.shape) for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)
    # Without a checkpoint group the plain version returns the output alone, the same values.
    np.testing.assert_array_equal(tk.ttt_linear_forward_plain(**_torch(a), eta_scale=scale).numpy(), got[0].numpy())


@pytest.mark.parametrize("NC,K", [(5, 2), (6, 4), (3, 16)])
def test_k5_plain_matches_pallas_bf16(rng, NC, K):
    """bf16 q/k/v at the CUDA kernel's head dim and mini-batch (F = 64,
    CS = 16): both round at the same points (XQ/XK, W, Gs, attn), only float32
    summation order differs. Outputs within 1e-2 absolute and relative (a few
    bf16 ulps of outputs up to ~5) and at least 99.9 % of them bit-equal
    (leaving out any one of the step's rounding points drops that share to
    95.6 % or less); the fp32 checkpoints within 1e-4 of their scale."""
    B, H, F, CS = 1, 2, 64, 16
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    got = tk.ttt_linear_forward_plain(**_torch(a, torch.bfloat16), eta_scale=scale, checkpoint_group=K)
    want = _jax_forward(a, scale, K, jnp.bfloat16)
    out, ref = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    assert np.mean(out == ref) >= 0.999
    for g, w in zip(got[1:], _port_ckpts(want[1:])):
        _close_scaled(g.numpy(), w.numpy(), 1e-4)


LARGE_ETA = [0.1, 1.0]  # eta_scale 100x and 1,000x the 3 s slice's (ttt_base_lr 1.0 / 64 / 16)
MOVED_TOLS = 10  # the large-eta cases' plain outputs lie at least this many tolerances from eta = 0's


@pytest.mark.parametrize("scale", LARGE_ETA)
@pytest.mark.parametrize("part", ["out", "checkpoints"])
def test_k5_plain_matches_pallas_bf16_large_eta(rng, part, scale):
    """K5's plain version against the Pallas kernel (interpret) at the CUDA
    kernel's shape (bf16 q/k/v, F = 64, CS = 16) and at the large eta where the
    carried state moves the output most (the eta of the CUDA kernels'
    state-update checks): the sampling output (no checkpoint group) within
    1e-2 absolute and relative, K5-train's fp32 checkpoints within 1e-3 of
    their scale (bf16 rounding flips from float32 summation order, grown by
    the larger updates)."""
    B, H, NC, CS, F, K = 1, 2, 5, 16, 64, 2
    a = _args(rng, B, H, NC, CS, F)
    want = _jax_forward(a, scale, K, jnp.bfloat16)
    if part == "out":
        got = tk.ttt_linear_forward_plain(**_torch(a, torch.bfloat16), eta_scale=scale)
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want[0].astype(jnp.float32)), rtol=1e-2,
                                   atol=1e-2)
    else:
        got = tk.ttt_linear_forward_plain(**_torch(a, torch.bfloat16), eta_scale=scale, checkpoint_group=K)
        for g, w in zip(got[1:], _port_ckpts(want[1:])):
            _close_scaled(g.numpy(), w.numpy(), 1e-3)


# The mini-batches the CUDA kernels take besides 16 (ops/ttt_linear_kernel.py:KERNEL_MINI_BATCHES): 32 and 64,
# the model's default and the reference's training mini-batch.
WIDE_CS = [32, 64]


@pytest.mark.parametrize("part", ["k5", "k6"])
@pytest.mark.parametrize("CS", WIDE_CS)
def test_plain_matches_pallas_at_wide_mini_batch(rng, CS, part):
    """K5-train's and K6's plain versions against the Pallas kernels
    (interpret), float32, at the CUDA kernels' head dim F = 64 and
    CS = 32 / 64, eta 1 / F / CS, NC = 3 with K = 2 (a ragged last group):
    K5's output and both checkpoints to 2e-5 absolute and relative (float32
    summation order), all eight K6 gradients to 1e-4 of their scale, as at
    the narrow shapes."""
    B, H, NC, F, K = 1, 2, 3, 64, 2
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    jax_out = _jax_forward(a, scale, K)
    if part == "k5":
        got = tk.ttt_linear_forward_plain(**_torch(a), eta_scale=scale, checkpoint_group=K)
        want = (np.asarray(jax_out[0]), *(c.numpy() for c in _port_ckpts(jax_out[1:])))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w, rtol=2e-5, atol=2e-5)
        return
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a)
    got = tk.ttt_linear_backward_plain(*(t[k] for k in IN), *_port_ckpts(jax_out[1:]), torch.from_numpy(dout),
                                       scale, K)
    for name, g, w in zip(GRADS, got, _jax_backward(a, jax_out[1:], dout, scale, K)):
        assert tuple(g.shape) == w.shape, name
        _close_scaled(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("CS", WIDE_CS)
def test_plain_matches_pallas_bf16_at_wide_mini_batch(rng, CS):
    """What the CUDA kernels see at CS = 32 / 64: bf16 q/k/v/dout, F = 64,
    eta 1 / F / CS, NC = 3, K = 2, through the training wrappers on CPU
    tensors (the plain versions) against the Pallas kernels (interpret):
    K5-train's output within 1e-2 absolute and relative with at least 98 %
    bit-equal (98.9 % at CS = 64 with this seed: 64-term sums flip more bf16
    roundings than 16-term ones; leaving out the rounding of W, Gs or attn
    drops the share to 70 %, 64 % and 94 %), its checkpoints within 1e-3 of
    their scale (as at the edge shapes of CS = 16: Gs's bf16 rounding flips,
    more of them in 64-token sums, carried into the fp32 state; 1.05e-4
    measured at CS = 64 with this seed); every K6 gradient within 2e-2 of its
    scale, as at CS = 16."""
    B, H, NC, F, K = 1, 2, 3, 64, 2
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    t = _torch(a, torch.bfloat16)
    want = _jax_forward(a, scale, K, jnp.bfloat16)
    got = tk.ttt_linear_forward_train(**t, eta_scale=scale, checkpoint_group=K)
    out, ref = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
    assert np.mean(out == ref) >= 0.98
    for g, w in zip(got[1:], _port_ckpts(want[1:])):
        _close_scaled(g.numpy(), w.numpy(), 1e-3)
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    grads = tk.ttt_linear_backward(*(t[k] for k in IN), *_port_ckpts(want[1:]), torch.from_numpy(dout).bfloat16(),
                                   scale, K)
    for g, w in zip(grads, _jax_backward(a, want[1:], dout, scale, K, jnp.bfloat16)):
        _close_scaled(g.float().numpy(), w, 2e-2)


def _tolerances_apart(a, b, atol=2e-2, rtol=2e-2):
    """max |a - b| / (atol + rtol |b|): how many of a tolerance two results are apart."""
    a, b = a.double(), b.double()
    return float(((a - b).abs() / (atol + rtol * b.abs())).max())


@pytest.mark.parametrize("scale", LARGE_ETA)
@pytest.mark.parametrize("what", ["out", "checkpoints", "d_gate", "dW1", "dXK", "dXV"])
def test_plain_versions_move_with_eta(rng, what, scale):
    """The guard the CUDA kernels' large-eta checks rely on: at bf16, F = 64,
    CS = 16, each plain output lies at least MOVED_TOLS of the kernels'
    tolerances from its eta_scale = 0 value: K5's output (2e-2 + 2e-2 |x|
    elementwise), K5-train's later checkpoints (1e-3 of their scale), K6's
    d_gate (exactly 0 at eta = 0; 2e-2), dW1 (1e-2 of its scale), and dXK and
    dXV (elementwise, as the output). So a kernel that drops or garbles the
    state update, or the eta path of the backward, cannot pass."""
    B, H, NC, CS, F, K = 1, 2, 5, 16, 64, 2
    t = _torch(_args(rng, B, H, NC, CS, F), torch.bfloat16)
    got = tk.ttt_linear_forward_plain(**t, eta_scale=scale, checkpoint_group=K)
    still = tk.ttt_linear_forward_plain(**t, eta_scale=0.0, checkpoint_group=K)
    if what == "out":
        assert _tolerances_apart(got[0], still[0]) >= MOVED_TOLS
    elif what == "checkpoints":
        for g, s in zip(got[1:], still[1:]):  # group 1 starts after K updates
            assert float((g[:, :, 1:] - s[:, :, 1:]).abs().max()) >= MOVED_TOLS * 1e-3 * float(g[:, :, 1:].abs().max())
    else:
        dout = torch.from_numpy(rng.standard_normal(t["XQ"].shape).astype(f32)).bfloat16()
        ins = [t[k] for k in IN]
        grads = dict(zip(GRADS, tk.ttt_linear_backward_plain(*ins, *got[1:], dout, scale, K)))
        base = dict(zip(GRADS, tk.ttt_linear_backward_plain(*ins, *still[1:], dout, 0.0, K)))
        if what == "d_gate":
            assert float(grads["d_gate"].abs().max()) >= MOVED_TOLS * 2e-2
        elif what == "dW1":
            assert float((grads["dW1"] - base["dW1"]).abs().max()) >= MOVED_TOLS * 1e-2 * float(grads["dW1"].abs().max())
        else:
            assert _tolerances_apart(grads[what], base[what]) >= MOVED_TOLS


def _preprocessed(a, scale):
    """The composed XLA-side preprocessing of the JAX layer (L2-norm, by-slot
    rope, LN target + XK, sigmoid gate): head-major XQ, XK, XV, eta."""
    B, NC, CS, HF = a["XQ"].shape
    H, F = a["ln_w"].shape
    hm = lambda x: jnp.transpose(jnp.asarray(x).reshape(B, NC, CS, H, F), (0, 3, 1, 2, 4))  # [B,H,NC,CS,F]
    l2n = lambda x: x / jnp.maximum(jnp.linalg.norm(x, axis=-1, keepdims=True), 1e-12)
    cos, sin = jnp.asarray(a["rope_cos"]), jnp.asarray(a["rope_sin"])
    swap = lambda x: jnp.stack([-x[..., 1::2], x[..., 0::2]], axis=-1).reshape(x.shape)
    rope = lambda x: x * cos + swap(x) * sin
    XQ, XK = rope(l2n(hm(a["XQ"]))), rope(l2n(hm(a["XK"])))
    t = hm(a["XV"]) - XK
    mu = jnp.mean(t, -1, keepdims=True)
    sd = jnp.sqrt(jnp.var(t, -1, keepdims=True) * (F / (F - 1))) + 1e-8
    XV = a["ln_w"][None, :, None, None] * (t - mu) / sd + a["ln_b"][None, :, None, None] + XK
    return XQ, XK, XV, jax.nn.sigmoid(jnp.asarray(a["gate"])) * scale


def test_k5_plain_matches_composed_scan_oracle(rng):
    """K5's float32 plain version against the JAX lax.scan oracle
    (ttt_scan.ttt_linear) after the composed preprocessing, 2e-5."""
    B, H, NC, CS, F = 1, 3, 4, 8, 16
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    tile = lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (B,) + p.shape)
    want = j_scan.ttt_linear(*_preprocessed(a, scale), a["ln_w"], a["ln_b"], tile(a["W1"]), tile(a["b1"]),
                             checkpoint_group_size=3)
    want_tm = np.transpose(np.asarray(want), (0, 2, 3, 1, 4)).reshape(B, NC, CS, H * F)
    got = tk.ttt_linear_forward_plain(**_torch(a), eta_scale=scale).numpy()
    np.testing.assert_allclose(got, want_tm, rtol=2e-5, atol=2e-5)


def test_ttt_linear_scan_matches_jax_oracle(rng):
    """ops/ttt_scan.py:ttt_linear (whose step K5's plain version runs)
    against the JAX scan on preprocessed head-major inputs, 2e-5."""
    B, H, NC, CS, F = 2, 2, 3, 8, 16
    x = lambda: rng.standard_normal((B, H, NC, CS, F)).astype(f32)
    XQ, XK, XV = x(), x(), x()
    eta = rng.uniform(0.001, 0.01, (B, H, NC, CS)).astype(f32)
    lnw, lnb = rng.standard_normal((H, F)).astype(f32), rng.standard_normal((H, F)).astype(f32)
    W1 = (0.02 * rng.standard_normal((B, H, F, F))).astype(f32)
    b1 = (0.02 * rng.standard_normal((B, H, 1, F))).astype(f32)
    args = (XQ, XK, XV, eta, lnw, lnb, W1, b1)
    want = j_scan.ttt_linear(*(jnp.asarray(v) for v in args), checkpoint_group_size=2)
    got = t_scan.ttt_linear(*(torch.from_numpy(v) for v in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)


# ------------------------------------------------------------ K6


@pytest.mark.parametrize("CS,NC,K", [(8, 6, 4), (8, 3, 1), (8, 7, 3)])
def test_k6_plain_matches_pallas(rng, CS, NC, K):
    """K6's plain two-pass backward against the Pallas backward (interpret),
    float32, from the same checkpoints: all eight gradients (d_gate and the
    state and LN gradients included) within 1e-4 of their scale (float32
    summation order through K steps of a second-order VJP)."""
    B, H, F = 2, 2, 16
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    jck = _jax_forward(a, scale, K)[1:]
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a)
    got = tk.ttt_linear_backward_plain(*(t[k] for k in IN), *_port_ckpts(jck), torch.from_numpy(dout), scale, K)
    want = _jax_backward(a, jck, dout, scale, K)
    for name, g, w in zip(GRADS, got, want):
        assert tuple(g.shape) == w.shape, name
        _close_scaled(g.numpy(), w, 1e-4)


@pytest.mark.parametrize("NC,K", [(5, 4), (3, 2)])
def test_k6_plain_matches_pallas_bf16(rng, NC, K):
    """bf16 q/k/v/dout at F = 64, CS = 16: both backwards round at the same
    points (XQ, XK, W, Gs, A1, dZb1, dA1, the carry dW, dZ1); every gradient
    within 2e-2 of its scale (bf16 rounding flips from float32 summation
    order, carried through the step VJP)."""
    B, H, F, CS = 1, 2, 64, 16
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    jck = _jax_forward(a, scale, K, jnp.bfloat16)[1:]
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a, torch.bfloat16)
    got = tk.ttt_linear_backward_plain(*(t[k] for k in IN), *_port_ckpts(jck), torch.from_numpy(dout).bfloat16(),
                                       scale, K)
    want = _jax_backward(a, jck, dout, scale, K, jnp.bfloat16)
    for g, w in zip(got, want):
        _close_scaled(g.float().numpy(), w, 2e-2)


@pytest.mark.parametrize("scale", LARGE_ETA)
def test_k6_plain_matches_pallas_bf16_large_eta(rng, scale):
    """K6's plain version against the Pallas backward (interpret) at F = 64,
    CS = 16, bf16, large eta, from the same checkpoints: every gradient within
    2e-2 of its scale, as at the slice's eta."""
    B, H, NC, CS, F, K = 1, 2, 5, 16, 64, 2
    a = _args(rng, B, H, NC, CS, F)
    jck = _jax_forward(a, scale, K, jnp.bfloat16)[1:]
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a, torch.bfloat16)
    got = tk.ttt_linear_backward_plain(*(t[k] for k in IN), *_port_ckpts(jck), torch.from_numpy(dout).bfloat16(),
                                       scale, K)
    want = _jax_backward(a, jck, dout, scale, K, jnp.bfloat16)
    for g, w in zip(got, want):
        _close_scaled(g.float().numpy(), w, 2e-2)


# (NC, K): one mini-batch; one step a group; one group; a group longer than the scan (the wrappers and the
# Pallas kernels take K = NC); a last group of one step.
EDGES = {"nc1": (1, 1), "k1": (4, 1), "k_eq_nc": (4, 4), "k_gt_nc": (3, 8), "last_group_1": (7, 3)}


@pytest.mark.parametrize("edge", list(EDGES))
@pytest.mark.parametrize("kernel", ["k5_train", "k6"])
def test_training_wrappers_match_pallas_at_edge_shapes(rng, kernel, edge):
    """The training wrappers on CPU tensors (the plain versions) against the
    Pallas kernels (interpret) at the CUDA kernels' shape (bf16, F = 64,
    CS = 16, the slice's eta) and at the edges of the checkpoint grouping:
    K5-train's output within 1e-2 absolute and relative and its checkpoints
    within 1e-3 of their scale (bf16 rounding flips of Gs from float32
    summation order, carried into the fp32 state over up to 7 steps); every
    K6 gradient within 2e-2 of its scale."""
    NC, K = EDGES[edge]
    B, H, CS, F = 1, 2, 16, 64
    a = _args(rng, B, H, NC, CS, F)
    scale = 1.0 / F / CS
    t = _torch(a, torch.bfloat16)
    want = _jax_forward(a, scale, K, jnp.bfloat16)
    got = tk.ttt_linear_forward_train(**t, eta_scale=scale, checkpoint_group=K)
    assert got[1].shape[2] == -(-NC // K)
    if kernel == "k5_train":
        np.testing.assert_allclose(got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32)), rtol=1e-2,
                                   atol=1e-2)
        for g, w in zip(got[1:], _port_ckpts(want[1:])):
            _close_scaled(g.numpy(), w.numpy(), 1e-3)
        return
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    grads = tk.ttt_linear_backward(*(t[k] for k in IN), *_port_ckpts(want[1:]), torch.from_numpy(dout).bfloat16(),
                                   scale, K)
    for g, w in zip(grads, _jax_backward(a, want[1:], dout, scale, K, jnp.bfloat16)):
        _close_scaled(g.float().numpy(), w, 2e-2)


def _f64_inputs(B=2, H=2, NC=5, CS=4, F=8):
    g = torch.Generator().manual_seed(0)
    r = lambda *s, std=1.0: torch.randn(*s, generator=g, dtype=torch.float64) * std
    ang = torch.rand(NC, CS, F // 2, generator=g, dtype=torch.float64) * 6.3
    return dict(XQ=r(B, NC, CS, H * F), XK=r(B, NC, CS, H * F), XV=r(B, NC, CS, H * F), gate=r(B, H, NC, CS),
                rope_cos=torch.cos(ang).repeat_interleave(2, -1), rope_sin=torch.sin(ang).repeat_interleave(2, -1),
                ln_w=1 + r(H, F, std=0.1), ln_b=r(H, F, std=0.1), W1=r(H, F, F, std=0.3), b1=r(H, 1, F, std=0.3))


DIFF = ("XQ", "XK", "XV", "gate", "W1", "b1", "ln_w", "ln_b")


@pytest.mark.parametrize("K", [2, 5])
def test_k6_plain_matches_autograd_float64(K):
    """K6's plain version against torch.autograd through K5-train's plain
    version, float64 (no rounding), NC = 5 (K = 2: a ragged last group;
    K = 5: one group): every gradient, d_gate included, to 1e-9 of its scale."""
    a = _f64_inputs()
    for k in DIFF:
        a[k].requires_grad_(True)
    out, *ck = tk.ttt_linear_forward_plain(**a, eta_scale=0.5, checkpoint_group=K)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(1), dtype=torch.float64)
    want = torch.autograd.grad(out, [a[k] for k in DIFF], dout)
    with torch.no_grad():
        got = tk.ttt_linear_backward_plain(*(a[k].detach() for k in IN), *ck, dout, 0.5, K)
    for g, w in zip(got, want):
        _close_scaled(g.numpy(), w.numpy(), 1e-9)


def test_function_gradients_match_autograd_float64():
    """TTTLinearFunction (K5-train forward, K6 backward; CPU tensors take the
    plain versions) gives autograd's gradients of the plain forward, float64,
    to 1e-9 of their scale, and the same output."""
    a = _f64_inputs(B=1, NC=3)
    keys = ("XQ", "XK", "XV", "gate", "ln_w", "ln_b", "W1", "b1")
    for k in keys:
        a[k].requires_grad_(True)
    dout = torch.randn(1, 3, 4, 16, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    out = tk.ttt_linear_train(*(a[k] for k in IN), a["W1"], a["b1"], 0.5, 2)
    got = torch.autograd.grad(out, [a[k] for k in keys], dout)
    ref = tk.ttt_linear_forward_plain(**a, eta_scale=0.5)
    want = torch.autograd.grad(ref, [a[k] for k in keys], dout)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    for g, w in zip(got, want):
        _close_scaled(g.numpy(), w.numpy(), 1e-9)


@pytest.mark.parametrize("scale", [3.125, 31.25])
@pytest.mark.parametrize("K", [2, 5])
def test_k6_plain_matches_autograd_float64_large_eta(K, scale):
    """K6's plain version against torch.autograd through K5-train's plain
    version, float64, at an eta 100x and 1,000x the slice's relative to this
    shape (1 / F / CS = 1 / 32), NC = 5 (K = 2: a ragged last group; K = 5:
    one group): every gradient, d_gate included, to 1e-9 of its scale."""
    a = _f64_inputs()
    for k in DIFF:
        a[k].requires_grad_(True)
    out, *ck = tk.ttt_linear_forward_plain(**a, eta_scale=scale, checkpoint_group=K)
    dout = torch.randn(out.shape, generator=torch.Generator().manual_seed(4), dtype=torch.float64)
    want = torch.autograd.grad(out, [a[k] for k in DIFF], dout)
    with torch.no_grad():
        got = tk.ttt_linear_backward_plain(*(a[k].detach() for k in IN), *ck, dout, scale, K)
    for g, w in zip(got, want):
        _close_scaled(g.numpy(), w.numpy(), 1e-9)


@pytest.mark.parametrize("scale", [3.125, 31.25])
def test_function_gradients_match_autograd_float64_large_eta(scale):
    """TTTLinearFunction against autograd of the plain forward, float64, at an
    eta 100x and 1,000x the slice's relative to this shape (1 / F / CS =
    1 / 32), NC = 5 with K = 2 (a ragged last group): the output bit-equal
    and every gradient to 1e-9 of its scale."""
    a = _f64_inputs(B=1)
    for k in DIFF:
        a[k].requires_grad_(True)
    dout = torch.randn(1, 5, 4, 16, generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    out = tk.ttt_linear_train(*(a[k] for k in IN), a["W1"], a["b1"], scale, 2)
    got = torch.autograd.grad(out, [a[k] for k in DIFF], dout)
    ref = tk.ttt_linear_forward_plain(**a, eta_scale=scale)
    want = torch.autograd.grad(ref, [a[k] for k in DIFF], dout)
    np.testing.assert_array_equal(out.detach().numpy(), ref.detach().numpy())
    for g, w in zip(got, want):
        _close_scaled(g.numpy(), w.numpy(), 1e-9)


def test_backward_trace_splits_dxk_into_its_terms(rng):
    """K6's plain version with a ``trace``: for every mini-batch the recorded
    operands rebuild dXK before the rope and L2-norm VJPs, -Gs bf16(dW)^T +
    bf16(dA1)^T XQ - dtv + bf16(dZ1) W^T, and through the VJPs give the
    returned dXK (float32, 1e-5 of its scale); the trace leaves the gradients
    as they are. scripts/k6_tolerance_seeds.py splits elements this way."""
    from ttt_video_dit_torch.ops import ln as t_ln

    B, H, NC, CS, F, K = 1, 2, 5, 8, 16, 2
    t = _torch(_args(rng, B, H, NC, CS, F))
    ck = tk.ttt_linear_forward_plain(**t, eta_scale=0.01, checkpoint_group=K)[1:]
    dout = torch.from_numpy(rng.standard_normal(t["XQ"].shape).astype(f32))
    ins = [t[k] for k in IN]
    trace = {}
    got = tk.ttt_linear_backward_plain(*ins, *ck, dout, 0.01, K, trace=trace)
    for g, w in zip(got, tk.ttt_linear_backward_plain(*ins, *ck, dout, 0.01, K)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert sorted(trace) == list(range(NC))
    hm = lambda x: x.reshape(B, NC, CS, H, F).permute(1, 0, 3, 2, 4)  # [NC, B, H, CS, F]
    xk, dxk = hm(t["XK"]), hm(got[1])
    for n, tr in trace.items():
        pre = -tr["Gs"] @ tr["dW"].transpose(-1, -2) + tr["dA1"].transpose(-1, -2) @ tr["XQ"] - tr["dtv"] \
            + tr["dZ1"] @ tr["W"].transpose(-1, -2)
        want = t_ln.l2norm_vjp(xk[n], t_ln.rope_vjp(pre, t["rope_cos"][n], t["rope_sin"][n]))
        _close_scaled(dxk[n].numpy(), want.numpy(), 1e-5)


def test_wrappers_take_plain_versions_on_cpu(rng):
    a = _torch(_args(rng, 1, 2, 3, 8, 16))
    np.testing.assert_array_equal(tk.ttt_linear_forward(**a, eta_scale=1e-3).numpy(),
                                  tk.ttt_linear_forward_plain(**a, eta_scale=1e-3).numpy())
    got = tk.ttt_linear_forward_train(**a, eta_scale=1e-3, checkpoint_group=2)
    want = tk.ttt_linear_forward_plain(**a, eta_scale=1e-3, checkpoint_group=2)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    dout = torch.from_numpy(rng.standard_normal(a["XQ"].shape).astype(f32))
    got = tk.ttt_linear_backward(*(a[k] for k in IN), *want[1:], dout, 1e-3, 2)
    for g, w in zip(got, tk.ttt_linear_backward_plain(*(a[k] for k in IN), *want[1:], dout, 1e-3, 2)):
        np.testing.assert_array_equal(g.numpy(), w.numpy())


def _cases(source: str, function: str) -> tuple:
    """The ``case N:`` labels of the switch in C function ``function`` of csrc/``source``."""
    import pathlib
    import re

    from ttt_video_dit_torch.ops import _build

    text = (pathlib.Path(_build.CSRC_DIR) / source).read_text()
    body = text[text.index(f" {function}("):]
    body = body[:body.index("\n}\n")]
    return tuple(int(c) for c in re.findall(r"case (\d+):", body))


@pytest.mark.parametrize("kernels", ["ttt_linear", "ttt_mlp_sampling", "ttt_mlp_training", "ttt_linear_f128"])
def test_supported_mini_batches_are_the_instantiated_ones(kernels):
    """Each wrapper's tuple of mini-batches is the list its C entry
    dispatches on: ttt_mlp_block.cuh:with_slabs (K5, K5-train and K6; K1-train,
    K2, and K1 past CS 16) and ttt_mlp_forward.cu:ttt_mlp_forward (K1), so a
    CS the wrapper lets through always has a kernel, and one that has a
    kernel is never refused: every multiple of 8 up to 64. At head dim 128,
    K5's, K5-train's and K6's takes-list is ttt_linear_f128.cuh:
    with_mini_batch's: CS 16."""
    from ttt_video_dit_torch.ops import ttt_mlp_kernel as tm

    every = (8, 16, 24, 32, 40, 48, 56, 64)
    if kernels == "ttt_linear":
        assert _cases("ttt_mlp_block.cuh", "with_slabs") == tk.KERNEL_MINI_BATCHES == every
    elif kernels == "ttt_linear_f128":
        assert _cases("ttt_linear_f128.cuh", "with_mini_batch") == tk.F128_MINI_BATCHES == (16,)
        assert tk.KERNEL_SHAPES == {64: every, 128: (16,)}
    elif kernels == "ttt_mlp_sampling":
        assert tuple(sorted(_cases("ttt_mlp_forward.cu", "ttt_mlp_forward"))) == tm.KERNEL_MINI_BATCHES == every
    else:
        assert _cases("ttt_mlp_block.cuh", "with_slabs") == tm.KERNEL_MINI_BATCHES == every


def _k5_args(F=64, CS=16, dtype=torch.bfloat16, device="meta", state_width=None):
    B, H, NC = 1, 2, 3
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device=device)
    S = state_width or F
    return [z(B, NC, CS, H * F, dt=dtype), z(B, NC, CS, H * F, dt=dtype), z(B, NC, CS, H * F, dt=dtype),
            z(B, H, NC, CS), z(NC, CS, F), z(NC, CS, F), z(H, F), z(H, F), z(H, F, S), z(H, 1, S)]


@pytest.mark.parametrize("case", ["cpu_tensors", "head_dim_32", "mini_batch_72", "float32_inputs", "mlp_state"])
def test_kernel_rejects_what_it_does_not_take(case):
    """check_kernel_args refuses CPU tensors, F != 64, a CS outside
    KERNEL_MINI_BATCHES (72: a multiple of 8 the JAX kernels take, past the
    port's 64), float32 q/k/v that are not on a CUDA device (the float32
    kernels take them there; tests/test_torch_float32_route.py) and a
    TTT-MLP-shaped state; and a tensor that is neither on the CPU nor
    launchable (meta) makes every wrapper raise, never fall back."""
    args = {"cpu_tensors": lambda: _k5_args(device="cpu"), "head_dim_32": lambda: _k5_args(F=32),
            "mini_batch_72": lambda: _k5_args(CS=72), "float32_inputs": lambda: _k5_args(dtype=torch.float32),
            "mlp_state": lambda: _k5_args(state_width=256)}[case]()
    with pytest.raises(ValueError, match=r"\(8, 16, 24, 32, 40, 48, 56, 64\)" if case == "mini_batch_72" else None):
        tk.check_kernel_args(*args)
    if case != "cpu_tensors":
        with pytest.raises(ValueError):
            tk.ttt_linear_forward(*args, eta_scale=1e-3)
        with pytest.raises(ValueError):
            tk.ttt_linear_forward_train(*args, eta_scale=1e-3, checkpoint_group=2)
        with pytest.raises(ValueError):
            tk.ttt_linear_backward(*args[:8], args[8][None, :, None].expand(1, 2, 2, *args[8].shape[1:]),
                                   args[9][None, :, None].expand(1, 2, 2, 1, args[9].shape[-1]), args[0], 1e-3, 2)
