"""Both TTT variants at a mini-batch that is not a multiple of 8, CS = 10,
in the PyTorch port against the JAX package on the CPU. The JAX layer sends
such a scan to its ttt_scan oracle (its kernels' is_supported fails); the
port's layer routes it to its plain versions on a card too
(ops/ttt_mlp_kernel.py:use_plain), so this is what the port computes there.
The tiny flagship config (__graft_entry__._flagship_config(tiny=True): d128,
8 heads, 3 scenes; cut to 1 layer) at its entry's geometry, 37 frames of 4 x 4
tokens and 3 scenes of 16 text tokens (L = 640 = 64 x 10: CS 12 does not
divide it, and 10 is the nearest of its divisors that is not a multiple of
8; NC 64 in checkpoint groups of 4), same weights (carried by
``convert.load_flax_params``), same numpy inputs and the JAX draws:

- one DiT forward (sampling: inference mode), within rtol 1e-5 and 1e-5 of
  the output's scale, as tests/test_torch_model.py holds the DiT;
- the training loss (rtol 1e-5) and every parameter's gradient (1e-4
  relative L2, tests/test_torch_long_context.py's GRAD_REL_L2).
"""

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from test_torch_long_context import GRAD_REL_L2, _jax_draws, _port_loss_and_grads, _random_params  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.config.model_config import ModelConfig as TorchModelConfig  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.ops import ttt_mlp_kernel  # noqa: E402
from ttt_video_dit_tpu.models.dit import dit as j_dit  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402

torch.set_num_threads(1)
CS, SCENES, TEXT_LEN, PIXELS = 10, 3, 16, 8  # 8 x 8 latent pixels: 4 x 4 tokens a frame


@functools.lru_cache(maxsize=2)
def _models(ssm_layer):
    cfg = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), mini_batch_size=CS, ssm_layer=ssm_layer,
                              num_layers=1)
    L = SCENES * TEXT_LEN + cfg.compressed_num_frames * (PIXELS // cfg.patch_size) ** 2
    assert (L, L % 12, L // CS, cfg.scan_checkpoint_group_size) == (640, 4, 64, 4)
    assert ttt_mlp_kernel.routes_to_plain(CS, cfg.model_dim // cfg.num_heads)
    rng = np.random.default_rng(0)
    vid = rng.standard_normal((1, cfg.compressed_num_frames, cfg.in_channels, PIXELS, PIXELS)).astype(np.float32)
    text = rng.standard_normal((1, SCENES, TEXT_LEN, cfg.text_dim)).astype(np.float32)
    lo, hi = np.array([0], np.int32), np.array([1000], np.int32)
    model = CogVideoX(cfg)
    bounds = (jnp.asarray(lo), jnp.asarray(hi))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(vid), jnp.asarray(text),
                                               jax.random.PRNGKey(1), bounds), 7)
    port_cfg = TorchModelConfig(**{**dataclasses.asdict(cfg), "use_kernel": True})
    port = convert.load_flax_params(TorchCogVideoX(port_cfg), jax.tree.map(np.asarray, params))
    return cfg, model, params, port, vid, text, lo, hi, bounds


@pytest.mark.parametrize("ssm_layer", ["ttt_mlp", "ttt_linear"])
def test_dit_forward_at_mini_batch_10_matches_jax(ssm_layer):
    cfg, _, params, port, vid, text, _, _, _ = _models(ssm_layer)
    t = np.array([500.0], np.float32)
    want = np.asarray(jax.jit(j_dit.DiffusionTransformer(cfg).apply)(
        {"params": params["params"]["dit"]}, *(jnp.asarray(x) for x in (vid, text, t))))
    with torch.inference_mode():
        got = port.eval().dit(*(torch.from_numpy(x) for x in (vid, text, t))).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("ssm_layer", ["ttt_mlp", "ttt_linear"])
def test_training_step_at_mini_batch_10_matches_jax(ssm_layer):
    _, model, params, port, vid, text, lo, hi, bounds = _models(ssm_layer)
    key = jax.random.PRNGKey(2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply(p, jnp.asarray(vid), jnp.asarray(text), key, bounds).mean()))(params)
    got_loss, got = _port_loss_and_grads(port.train(), vid, text, lo, hi, *_jax_draws(key, vid.shape, lo, hi))
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    assert set(want) == set(got)
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= GRAD_REL_L2 or float((g - w).abs().max()) <= 1e-9, f"{name}: relative L2 {err:.3g}"
