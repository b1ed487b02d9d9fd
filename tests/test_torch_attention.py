"""PyTorch port parity: window attention's plain versions, forward (K3,
with its log-sum-exp) and backward (K4), and the autograd Function around
them (ttt_video_dit_torch/ops/attention.py), against the JAX package on the
CPU and torch.autograd in float64.

The splash kernel runs in Pallas interpret mode with folded windows and a
ragged (padded, KV-masked) window, as tests/test_attention_windows.py runs
it; its backward through jax.vjp, as tests/test_remat_policy.py runs it.
Tolerance: 2e-5 absolute and relative (float32 summation order) unless a
test says otherwise.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import ttt_video_dit_tpu.ops.attention as attn_mod  # noqa: E402
from ttt_video_dit_torch.ops import attention as t_attn  # noqa: E402

torch.set_num_threads(1)
TOL = dict(rtol=2e-5, atol=2e-5)


def _qkv(rng, shape):
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("windows,valid", [(3, 417), (1, 512)])
def test_plain_matches_splash_kernel(monkeypatch, rng, windows, valid):
    """Folded windows, padded to the block with the pad KV columns masked (valid=417)."""
    monkeypatch.setattr(attn_mod, "_INTERPRET", True)
    attn_mod._splash_spec.cache_clear()
    q, k, v = _qkv(rng, (windows, valid, 2, 128))
    splash = functools.partial(attn_mod._splash_padded, block=256, windows=windows)
    want = splash(*(jnp.asarray(x) for x in (q, k, v)))
    got = t_attn.attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), block_q=100)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("shape", [(2, 37, 3, 16), (3, 130, 2, 64)])
def test_plain_matches_direct(rng, shape):
    q, k, v = _qkv(rng, shape)
    want = attn_mod._direct(*(jnp.asarray(x) for x in (q, k, v)))
    got = t_attn.attention_plain(*(torch.from_numpy(x) for x in (q, k, v)), block_q=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_wrapper_takes_plain_version_on_cpu(rng):
    q, k, v = (torch.from_numpy(x) for x in _qkv(rng, (2, 70, 2, 64)))
    np.testing.assert_array_equal(t_attn.attention(q, k, v).numpy(), t_attn.attention_plain(q, k, v).numpy())


@pytest.mark.parametrize("windows,valid", [(3, 417), (1, 512)])
def test_backward_plain_matches_splash_vjp(monkeypatch, rng, windows, valid):
    """K4's plain version (from K3's plain output and log-sum-exp) against
    jax.vjp of the splash kernel (interpret mode), folded windows and a
    ragged KV-masked window."""
    monkeypatch.setattr(attn_mod, "_INTERPRET", True)
    attn_mod._splash_spec.cache_clear()
    q, k, v = _qkv(rng, (windows, valid, 2, 128))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    splash = functools.partial(attn_mod._splash_padded, block=256, windows=windows)
    _, vjp = jax.vjp(splash, *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(dout))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = t_attn.attention_plain(tq, tk, tv, block_q=100, return_lse=True)
    got = t_attn.attention_backward_plain(tq, tk, tv, out, lse, torch.from_numpy(dout), block_q=128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_lse_matches_logsumexp(rng):
    """The plain forward's log-sum-exp is jax.nn.logsumexp of the scaled
    logits, [BC, H, S]; the output is unchanged by asking for it."""
    q, k, v = _qkv(rng, (2, 70, 3, 16))
    logits = jnp.einsum("bshf,bthf->bhst", jnp.asarray(q), jnp.asarray(k)) / 4.0
    want = jax.nn.logsumexp(logits, axis=-1)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = t_attn.attention_plain(tq, tk, tv, block_q=32, return_lse=True)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want), **TOL)
    np.testing.assert_array_equal(out.numpy(), t_attn.attention_plain(tq, tk, tv, block_q=32).numpy())


def test_backward_plain_and_function_match_autograd_float64(rng):
    """K4's plain formula, and the autograd Function (K3 with lse forward, K4
    backward; CPU tensors take the plain versions), against torch.autograd of
    the plain forward in float64, to 1e-12."""
    q, k, v = (torch.from_numpy(rng.standard_normal((3, 37, 2, 16))).requires_grad_(True) for _ in range(3))
    dout = torch.from_numpy(rng.standard_normal((3, 37, 2, 16)))
    want = torch.autograd.grad(t_attn.attention_plain(q, k, v, block_q=8), (q, k, v), dout)
    out, lse = t_attn.attention_plain(q.detach(), k.detach(), v.detach(), block_q=10, return_lse=True)
    got_plain = t_attn.attention_backward_plain(q.detach(), k.detach(), v.detach(), out, lse, dout, block_q=16)
    got_fn = torch.autograd.grad(t_attn.attention_train(q, k, v), (q, k, v), dout)
    for a, b, w in zip(got_plain, got_fn, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)
        np.testing.assert_allclose(b.numpy(), w.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("windows,valid", [(3, 417), (1, 512)])
def test_backward_plain_matches_splash_vjp_bf16(monkeypatch, rng, windows, valid):
    """The same at bf16 inputs and cotangent, head_dim 64 (the kernels'; its
    1/8 softmax scale is exact in bf16, so splash's pre-scaled q rounds
    nothing): both compute in float32 from the same bf16 values and round the
    gradients to bf16, so they agree to a few bf16 ulps, 2e-2 absolute and
    relative; the forward's log-sum-exp goes in as the plain version gives it."""
    monkeypatch.setattr(attn_mod, "_INTERPRET", True)
    attn_mod._splash_spec.cache_clear()
    q, k, v = _qkv(rng, (windows, valid, 2, 64))
    dout = rng.standard_normal(q.shape).astype(np.float32)
    to_bf16 = lambda x: jnp.asarray(x).astype(jnp.bfloat16)
    splash = functools.partial(attn_mod._splash_padded, block=256, windows=windows)
    _, vjp = jax.vjp(splash, *(to_bf16(x) for x in (q, k, v)))
    want = vjp(to_bf16(dout))
    tq, tk, tv, tdo = (torch.from_numpy(x).bfloat16() for x in (q, k, v, dout))
    out, lse = t_attn.attention_plain(tq, tk, tv, block_q=100, return_lse=True)
    got = t_attn.attention_backward_plain(tq, tk, tv, out, lse, tdo, block_q=128)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), rtol=2e-2, atol=2e-2)
