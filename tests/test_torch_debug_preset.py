"""The ``debug`` preset of configs/train/debug.toml and configs/eval/debug.toml
(d512, 8 heads, TTT-linear at the model's default mini-batch CS = 64,
ttt_base_lr 1.0) in the PyTorch port against the JAX package on the CPU: the
DiT's training loss and every parameter's gradient at 2 of its 6 layers, on a
4 x 4 latent grid (13 frames x 16 tokens + 48 text tokens = 256 tokens, NC 4)
with checkpoint groups of 3 (the last of 1), same weights (carried by
``convert.load_flax_params``) and the JAX draws. The port runs K5-train, K6,
K3 with its log-sum-exp and K4 through their autograd Functions, whose plain
versions take CPU tensors: the CUDA kernels at CS 64 are held to those plain
versions on the card (tests/test_torch_cuda.py, chip_smoke.py). Tolerances
as tests/test_torch_long_context.py states them: loss rtol 1e-5, every
gradient within 1e-4 relative L2 (float32 summation order through TTT and
attention backward).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from test_torch_long_context import GRAD_REL_L2, _jax_draws, _port_loss_and_grads, _random_params  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.config.model_config import ModelConfig as TorchModelConfig  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_tpu.config.model_config import ModelConfig  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402

torch.set_num_threads(1)
LAYERS, LATENT, TEXT_LEN, GROUP = 2, 4, 48, 3


def _config(cls, **kw):
    cfg = cls.get_preset("debug", "3sec")
    return dataclasses.replace(cfg, num_layers=LAYERS, ssm_layer="ttt_linear", ttt_base_lr=1.0, latent_height=LATENT,
                               latent_width=LATENT, scan_checkpoint_group_size=GROUP, dtype="float32", **kw)


def test_debug_preset_loss_and_gradients_match_jax():
    cfg = _config(ModelConfig, use_kernel=False)
    assert (cfg.model_dim, cfg.num_heads, cfg.mini_batch_size) == (512, 8, 64)
    rng = np.random.default_rng(0)
    h = LATENT * cfg.patch_size
    vid = rng.standard_normal((2, cfg.compressed_num_frames, cfg.in_channels, h, h)).astype(np.float32)
    text = rng.standard_normal((2, 1, TEXT_LEN, cfg.text_dim)).astype(np.float32)
    lo, hi = np.array([0, 500], np.int32), np.array([500, 1000], np.int32)
    assert (TEXT_LEN + cfg.compressed_num_frames * LATENT * LATENT) == 4 * cfg.mini_batch_size
    model = CogVideoX(cfg)
    bounds = (jnp.asarray(lo), jnp.asarray(hi))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(vid), jnp.asarray(text),
                                               jax.random.PRNGKey(1), bounds), 7)
    key = jax.random.PRNGKey(2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply(p, jnp.asarray(vid), jnp.asarray(text), key, bounds).mean()))(params)
    port_cfg = _config(TorchModelConfig, use_kernel=True)  # the autograd Functions; plain versions on CPU tensors
    port = convert.load_flax_params(TorchCogVideoX(port_cfg), jax.tree.map(np.asarray, params)).train()
    got_loss, got = _port_loss_and_grads(port, vid, text, lo, hi, *_jax_draws(key, vid.shape, lo, hi))
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    assert set(want) == set(got)
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= GRAD_REL_L2 or float((g - w).abs().max()) <= 1e-9, f"{name}: relative L2 {err:.3g}"
