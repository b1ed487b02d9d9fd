"""PyTorch port parity: window attention's plain version
(ttt_video_dit_torch/ops/attention.py) against the JAX package on the CPU.

The splash kernel runs in Pallas interpret mode with folded windows and a
ragged (padded, KV-masked) window, as tests/test_attention_windows.py runs
it. Tolerance: 2e-5 absolute and relative (float32 summation order).
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

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
