"""Both TTT variants at a mini-batch whose last 16-token slab is a half slab,
CS = 40 (the 30 s train TOML's L divides by it; the CUDA kernels take every
multiple of 8 up to 64), in the PyTorch port against the JAX package on the
CPU: the DiT's training loss and every parameter's gradient of the tiny
flagship config (__graft_entry__._flagship_config(tiny=True): d128, 8 heads,
2 layers, 3 scenes) with its TTT layer ttt_mlp or ttt_linear, at its entry's
geometry, 37 frames of 4 x 4 tokens and 3 scenes of 16 text tokens (L = 640,
NC = 16 in checkpoint groups of 4), same weights (carried by
``convert.load_flax_params``) and the JAX draws. The port runs its training
scans, attention with its log-sum-exp and attention's backward through their
autograd Functions, whose plain versions take CPU tensors; the CUDA kernels
at CS 40 are held to those plain versions on the card (tests/test_torch_cuda.py,
chip_smoke.py). Tolerances as tests/test_torch_mlp_mini_batch.py states them:
loss rtol 1e-5, every gradient within 1e-4 relative L2.
"""

import dataclasses

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
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402

torch.set_num_threads(1)
CS, SCENES, TEXT_LEN, PIXELS = 40, 3, 16, 8  # 8 x 8 latent pixels: 4 x 4 tokens a frame


@pytest.mark.parametrize("ssm_layer", ["ttt_mlp", "ttt_linear"])
def test_tiny_training_step_at_mini_batch_40_matches_jax(ssm_layer):
    cfg = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), mini_batch_size=CS, ssm_layer=ssm_layer)
    assert (cfg.compressed_num_frames, cfg.scan_checkpoint_group_size) == (37, 4)
    L = SCENES * TEXT_LEN + cfg.compressed_num_frames * (PIXELS // cfg.patch_size) ** 2
    assert (L, L // CS, L % CS, CS % 16) == (640, 16, 0, 8)
    rng = np.random.default_rng(0)
    vid = rng.standard_normal((1, cfg.compressed_num_frames, cfg.in_channels, PIXELS, PIXELS)).astype(np.float32)
    text = rng.standard_normal((1, SCENES, TEXT_LEN, cfg.text_dim)).astype(np.float32)
    lo, hi = np.array([0], np.int32), np.array([1000], np.int32)
    model = CogVideoX(cfg)
    bounds = (jnp.asarray(lo), jnp.asarray(hi))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(vid), jnp.asarray(text),
                                               jax.random.PRNGKey(1), bounds), 7)
    key = jax.random.PRNGKey(2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply(p, jnp.asarray(vid), jnp.asarray(text), key, bounds).mean()))(params)
    # The autograd Functions (use_kernel); on CPU tensors they run the plain versions.
    port_cfg = TorchModelConfig(**{**dataclasses.asdict(cfg), "use_kernel": True})
    port = convert.load_flax_params(TorchCogVideoX(port_cfg), jax.tree.map(np.asarray, params)).train()
    got_loss, got = _port_loss_and_grads(port, vid, text, lo, hi, *_jax_draws(key, vid.shape, lo, hi))
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    assert set(want) == set(got)
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= GRAD_REL_L2 or float((g - w).abs().max()) <= 1e-9, f"{name}: relative L2 {err:.3g}"
