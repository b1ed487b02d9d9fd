"""PyTorch port parity: the sampling stack (ttt_video_dit_torch/models/dit/
sampler.py and schedule.py) against the JAX package on the CPU, and the
slice as a whole: 3 DPM++(2M) steps with dynamic CFG through the tiny
CogVideoX, with JAX's initial latent and per-step noise injected into the port.
"""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.models.dit import sampler as TS  # noqa: E402
from ttt_video_dit_torch.models.dit import schedule as t_schedule  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_tpu.models.dit import sampler as JS  # noqa: E402
from ttt_video_dit_tpu.models.dit import schedule as j_schedule  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402

torch.set_num_threads(1)
EXAMPLE = str(Path(__file__).resolve().parent.parent / "inputs" / "example.json")


def test_load_storyboards_matches_jax(tmp_path):
    story = [[{"text": "a cat", "neg_text": "blurry"}, {"text": "a dog", "requires_scene_transition": True},
              {"text": "a bird"}]]
    (tmp_path / "story.json").write_text(json.dumps(story))
    (tmp_path / "story.jsonl").write_text(json.dumps(story[0]) + "\n" + json.dumps([{"text": "solo"}]) + "\n")
    for path in (EXAMPLE, str(tmp_path / "story.json"), str(tmp_path / "story.jsonl")):
        assert TS.load_storyboards(path) == JS.load_storyboards(path)
    texts, negs = TS.load_storyboards(EXAMPLE)[0]
    assert len(texts) == 1 and negs == ["blurry, low quality"]


@pytest.mark.parametrize("num_steps", [3, 50])
def test_step_tables_and_guidance_match_jax(num_steps):
    guider = dict(scale=6, exp=5, num_steps=num_steps)
    ours, n = TS.DPMPP2MSampler(num_steps, TS.DynamicCFG(**guider)).step_tables()
    _, theirs, n_j = JS.DPMPP2MSampler(num_steps, JS.DynamicCFG(**guider))._step_tables(jax.random.PRNGKey(0))
    assert n == n_j
    for name, col in ours.items():
        np.testing.assert_array_equal(col, theirs[name], err_msg=name)
    x = np.random.default_rng(0).standard_normal((4, 3)).astype(np.float32)
    got = TS.DynamicCFG(**guider).combine(torch.from_numpy(x), 4.5).numpy()
    np.testing.assert_allclose(got, np.asarray(JS.DynamicCFG(**guider).combine(jnp.asarray(x), 4.5)), rtol=1e-6)


def test_schedule_tables_and_timestep_embedding_match_jax():
    np.testing.assert_array_equal(t_schedule.training_sigma_table(1000), j_schedule.training_sigma_table(1000))
    disc_t, disc_j = t_schedule.ZeroSNRDDPMDiscretization(), j_schedule.ZeroSNRDDPMDiscretization()
    for a, b in zip(disc_t(7, return_idx=True), disc_j(7, return_idx=True)):
        np.testing.assert_array_equal(a, b)
    t = np.array([0.0, 3.0, 517.0, 999.0], np.float32)
    want = j_schedule.timestep_embedding(jnp.asarray(t), 65)
    got = t_schedule.timestep_embedding(torch.from_numpy(t), 65)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


def test_three_step_cfg_sampling_matches_jax():
    """The slice end to end at the tiny config: DPM++(2M) x 3 steps, dynamic
    CFG over the doubled batch, CogVideoX.denoise, the DiT with bidirectional
    TTT. Tolerance 1e-5 * max|latent| (float32 summation order, amplified by
    the guidance scale applied to the conditional/unconditional pair)."""
    cfg = __graft_entry__._flagship_config(tiny=True)
    shape = (1, 13, cfg.in_channels, 8, 8)
    rng = np.random.default_rng(0)
    text = rng.standard_normal((1, 1, 16, cfg.text_dim)).astype(np.float32)
    neg = np.zeros_like(text)

    model = CogVideoX(cfg)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), cfg.sigma_interval, jnp.int32))
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32),
                                               jnp.asarray(text), jax.random.PRNGKey(1), bounds))
    params = jax.tree.map(lambda s: jnp.asarray(0.1 * rng.standard_normal(s.shape), jnp.float32), shapes)

    steps, guider = 3, dict(scale=6, exp=5, num_steps=3)
    j_sampler = JS.DPMPP2MSampler(steps, JS.DynamicCFG(**guider))
    key = jax.random.PRNGKey(42)
    want = j_sampler(key, JS.make_cfg_denoise_fn(model, params, jnp.asarray(text), jnp.asarray(neg)), shape)

    # The JAX sampler's draws, in its order: the initial latent, then one per noised step.
    _, tables, n = j_sampler._step_tables(key)
    draws = [jax.random.normal(key, shape, jnp.float32)]
    draws += [jax.random.normal(tables["key"][i], shape, jnp.float32) for i in range(n) if not tables["last"][i]]
    draws = iter(np.array(d) for d in draws)

    port = convert.load_flax_params(TorchCogVideoX(cfg), jax.tree.map(np.asarray, params)).eval()
    t_sampler = TS.DPMPP2MSampler(steps, TS.DynamicCFG(**guider))
    denoise = TS.make_cfg_denoise_fn(port, torch.from_numpy(text), torch.from_numpy(neg))
    with torch.inference_mode():
        got = t_sampler(denoise, shape, noise=lambda shp: torch.from_numpy(next(draws)))
    assert next(draws, None) is None, "the port drew fewer noise tensors than the JAX sampler"
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()))
