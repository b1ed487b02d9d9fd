"""PyTorch port parity: TTT inner-loop math and the fused TTT-MLP scan's plain
version (ttt_video_dit_torch/ops) against the JAX package on the CPU.

The same float32 inputs, drawn from a numpy seed, go through the JAX function
and its port. The Pallas kernel runs in interpret mode, as the JAX package's
own tests run it. Tolerance: 2e-5 absolute and relative on O(1) outputs
(float32 summation-order noise).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ttt_video_dit_torch.ops import ln as t_ln  # noqa: E402
from ttt_video_dit_torch.ops import rope as t_rope  # noqa: E402
from ttt_video_dit_torch.ops import ttt_mlp_kernel, ttt_scan as t_scan  # noqa: E402
from ttt_video_dit_tpu.ops import ln as j_ln  # noqa: E402
from ttt_video_dit_tpu.ops import rope as j_rope  # noqa: E402
from ttt_video_dit_tpu.ops import ttt_scan as j_scan  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_forward  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)
f32 = np.float32


def _t(x):
    return torch.from_numpy(np.asarray(x, f32).copy())


def _ttt_args(rng, B, H, NC, CS, F):
    """Raw token-major q/k/v, gate logits, interleaved rope tables, LN affine, initial state."""
    x = lambda: rng.standard_normal((B, NC, CS, H * F)).astype(f32)
    ang = rng.uniform(0, 6.3, (NC, CS, F // 2)).astype(f32)
    return dict(
        XQ=x(), XK=x(), XV=x(), gate=rng.standard_normal((B, H, NC, CS)).astype(f32),
        rope_cos=np.repeat(np.cos(ang), 2, -1), rope_sin=np.repeat(np.sin(ang), 2, -1),
        ln_w=(1 + 0.1 * rng.standard_normal((H, F))).astype(f32), ln_b=(0.1 * rng.standard_normal((H, F))).astype(f32),
        W1=(0.02 * rng.standard_normal((H, F, 4 * F))).astype(f32), b1=(0.02 * rng.standard_normal((H, 1, 4 * F))).astype(f32),
        W2=(0.02 * rng.standard_normal((H, 4 * F, F))).astype(f32), b2=(0.02 * rng.standard_normal((H, 1, F))).astype(f32),
    )


def _port(a, scale, dtype=torch.float32):
    args = {k: _t(v) for k, v in a.items()}
    for k in ("XQ", "XK", "XV"):
        args[k] = args[k].to(dtype)
    return ttt_mlp_kernel.ttt_mlp_forward_plain(**args, eta_scale=scale).float().numpy()


def _pallas(a, scale, K, dtype=jnp.float32):
    """The Pallas kernel (interpret mode) in its fused-preproc, token-major,
    in-kernel-gate form, q/k/v in ``dtype``; output as float32."""
    B = a["XQ"].shape[0]
    tile = lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (B,) + p.shape)
    out = ttt_forward.ttt_mlp_forward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")),
        tile(a["W1"]), tile(a["b1"]), tile(a["W2"]), tile(a["b2"]), K, interpret=True,
        rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=scale, token_major=True,
    )[0]
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("CS,NC,K", [(8, 6, 4), (16, 5, 2), (16, 3, 3)])
def test_plain_scan_matches_pallas_kernel(rng, CS, NC, K):
    """K1's plain version against the Pallas kernel (interpret mode); K need
    not divide NC (the kernel's ragged last checkpoint group must not change
    the output)."""
    B, H, F = 2, 2, 16
    a = _ttt_args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
    np.testing.assert_allclose(_port(a, scale), _pallas(a, scale, K), **TOL)


def test_plain_scan_matches_pallas_kernel_bf16(rng):
    """K1's plain version against the Pallas kernel with bf16 q/k/v, at the
    CUDA kernel's head dim and mini-batch (F=64, CS=16): both round to bf16
    at the same points, so only float32 summation order differs. Tolerance
    1e-2 absolute and relative (a few bf16 ulps of outputs up to ~5), and at
    least 99.8 % of outputs bit-equal: leaving out any one of the step's
    rounding points drops that share to 99.2 % or less."""
    B, H, NC, CS, F = 1, 2, 6, 16, 64
    a = _ttt_args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
    got, want = _port(a, scale, torch.bfloat16), _pallas(a, scale, 4, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert np.mean(got == want) >= 0.998


# CS 64 in float32 and bf16; CS 32 and 48 in bf16 (the ids of the CS-64 cases are the dtypes alone).
@pytest.mark.parametrize("CS,dtype", [pytest.param(64, "float32", id="float32"),
                                      pytest.param(64, "bfloat16", id="bfloat16"),
                                      pytest.param(32, "bfloat16", id="cs32-bfloat16"),
                                      pytest.param(48, "bfloat16", id="cs48-bfloat16")])
def test_plain_scan_matches_pallas_kernel_at_mini_batch_64(rng, CS, dtype):
    """K1's plain version at the model's default mini-batch, CS = 64, and at
    CS = 32 and 48 (each of which the CUDA K1 runs through K1-train's step
    with no checkpoints), F = 64, against the Pallas kernel (interpret mode),
    at the TOMLs' eta (0.1 / F / CS), NC = 3 (odd). float32: 2e-5 absolute
    and relative (summation order). bf16 q/k/v: 1e-2 absolute and relative
    and at least 99.5 % of outputs bit-equal (99.6 % with this seed at CS
    64; leaving out any one of the step's nine rounding points drops the
    share to 99.0 % or less, attn1's and attn2's the least)."""
    B, H, NC, F = 2, 1, 3, 64
    a = _ttt_args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
    if dtype == "float32":
        np.testing.assert_allclose(_port(a, scale), _pallas(a, scale, 2), **TOL)
        return
    got, want = _port(a, scale, torch.bfloat16), _pallas(a, scale, 2, jnp.bfloat16)
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    assert np.mean(got == want) >= 0.995


def test_plain_scan_matches_composed_scan_oracle(rng):
    """K1's plain version against the JAX lax.scan oracle after the composed
    XLA-side preprocessing (L2-norm, by-slot rope, LN target, sigmoid gate)."""
    B, H, NC, CS, F = 1, 3, 4, 8, 16
    a = _ttt_args(rng, B, H, NC, CS, F)
    scale = 0.1 / F / CS
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
    eta = jax.nn.sigmoid(jnp.asarray(a["gate"])) * scale
    tile = lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (B,) + p.shape)
    want = j_scan.ttt_mlp(XQ, XK, XV, eta, a["ln_w"], a["ln_b"], tile(a["W1"]), tile(a["b1"]), tile(a["W2"]),
                          tile(a["b2"]), checkpoint_group_size=3)
    want_tm = np.transpose(np.asarray(want), (0, 2, 3, 1, 4)).reshape(B, NC, CS, H * F)
    np.testing.assert_allclose(_port(a, scale), want_tm, **TOL)


def _in_tolerances(a, b, tol=2e-2):
    """max |a - b| / (tol + tol |b|), elementwise: how many of the CUDA
    kernel's tolerances (2e-2 absolute and relative) apart two outputs are."""
    return float(np.max(np.abs(a - b) / (tol + tol * np.abs(b))))


@pytest.mark.parametrize("NC,scale", [(17, 0.1), (9, 1e-4), (5, 1.0)])
def test_plain_scan_output_moves_with_eta_and_state(rng, NC, scale):
    """The guard the CUDA kernel's tests rely on: with bf16 q/k/v at F=64,
    CS=16, K1's plain output is at least 10 of the kernel's tolerances away
    from the eta_scale = 0 output and, in the last mini-batch, from a scan
    whose state never changes (that mini-batch run from the initial state),
    so a kernel that got the dual-form terms or the state update wrong
    could not pass within one tolerance."""
    B, H, CS, F = 1, 2, 16, 64
    a = _ttt_args(rng, B, H, NC, CS, F)
    out = _port(a, scale, torch.bfloat16)
    assert _in_tolerances(out, _port(a, 0.0, torch.bfloat16)) >= 10
    last = dict(a, XQ=a["XQ"][:, -1:], XK=a["XK"][:, -1:], XV=a["XV"][:, -1:], gate=a["gate"][:, :, -1:],
                rope_cos=a["rope_cos"][-1:], rope_sin=a["rope_sin"][-1:])
    assert _in_tolerances(out[:, -1:], _port(last, scale, torch.bfloat16)) >= 10


@pytest.mark.parametrize("scale", [0.1, 1.0])
def test_plain_scan_matches_pallas_kernel_bf16_large_eta(rng, scale):
    """K1's plain version against the Pallas kernel (interpret mode) with
    bf16 q/k/v at F=64, CS=16 and an eta 1,000x and 10,000x the 3 s
    sampling slice's, where the carried state moves the output most (the
    eta the CUDA kernel's state-update tests use): within 1e-2 absolute and
    relative."""
    B, H, NC, CS, F = 1, 2, 6, 16, 64
    a = _ttt_args(rng, B, H, NC, CS, F)
    np.testing.assert_allclose(_port(a, scale, torch.bfloat16), _pallas(a, scale, 3, jnp.bfloat16), rtol=1e-2,
                               atol=1e-2)


def test_wrapper_takes_plain_version_on_cpu(rng):
    a = _ttt_args(rng, 1, 2, 3, 8, 16)
    got = ttt_mlp_kernel.ttt_mlp_forward(**{k: _t(v) for k, v in a.items()}, eta_scale=1e-3).numpy()
    np.testing.assert_array_equal(got, _port(a, 1e-3))


def test_ttt_scan_matches_jax_oracle(rng):
    """ops/ttt_scan.py (whose step K1's plain version runs) against the JAX
    scan on preprocessed head-major inputs."""
    B, H, NC, CS, F = 2, 2, 3, 8, 16
    x = lambda: rng.standard_normal((B, H, NC, CS, F)).astype(f32)
    XQ, XK, XV = x(), x(), x()
    eta = rng.uniform(0.001, 0.01, (B, H, NC, CS)).astype(f32)
    lnw, lnb = rng.standard_normal((H, F)).astype(f32), rng.standard_normal((H, F)).astype(f32)
    W1 = (0.02 * rng.standard_normal((B, H, F, 4 * F))).astype(f32)
    b1 = (0.02 * rng.standard_normal((B, H, 1, 4 * F))).astype(f32)
    W2 = (0.02 * rng.standard_normal((B, H, 4 * F, F))).astype(f32)
    b2 = (0.02 * rng.standard_normal((B, H, 1, F))).astype(f32)
    args = (XQ, XK, XV, eta, lnw, lnb, W1, b1, W2, b2)
    want = j_scan.ttt_mlp(*(jnp.asarray(v) for v in args), checkpoint_group_size=2)
    got = t_scan.ttt_mlp(*(_t(v) for v in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("fn", ["ln_fwd", "ln_fused_l2_bwd", "gelu_tanh", "gelu_bwd"])
def test_ln_primitives_match_jax(rng, fn):
    x, tgt = rng.standard_normal((3, 5, 16)).astype(f32), rng.standard_normal((3, 5, 16)).astype(f32)
    g, b = rng.standard_normal((16,)).astype(f32), rng.standard_normal((16,)).astype(f32)
    args = {"ln_fwd": (x, g, b), "ln_fused_l2_bwd": (x, tgt, g, b), "gelu_tanh": (x,), "gelu_bwd": (x,)}[fn]
    want = getattr(j_ln, fn)(*(jnp.asarray(v) for v in args))
    got = getattr(t_ln, fn)(*(_t(v) for v in args))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_rope_tables_and_rotation_match_jax(rng):
    F, prefix = 16, 5
    cos_j, sin_j = j_rope.precompute_rope_3d(F, 3, 4, 2)
    cos_t, sin_t = t_rope.precompute_rope_3d(F, 3, 4, 2)
    np.testing.assert_allclose(cos_t.numpy(), np.asarray(cos_j), **TOL)
    np.testing.assert_allclose(sin_t.numpy(), np.asarray(sin_j), **TOL)

    L = prefix + 24
    tabs_j = j_rope.interleaved_tables_prefixed(cos_j, sin_j, prefix, L)
    tabs_t = t_rope.interleaved_tables_prefixed(cos_t, sin_t, prefix, L)
    for a, b in zip(tabs_t, tabs_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)

    x = rng.standard_normal((2, L, 3, F)).astype(f32)
    want = j_rope.apply_rope_prefixed(jnp.asarray(x), cos_j, sin_j, prefix, seq_axis=1)
    got = t_rope.apply_rope_prefixed(_t(x), cos_t, sin_t, prefix, seq_axis=1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
