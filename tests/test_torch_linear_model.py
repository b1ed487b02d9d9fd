"""PyTorch port parity for the ``ttt_linear`` variant: the TTT layer (value and
gradients, both directions), the DiT and CogVideoX.denoise
(ttt_video_dit_torch/models) against the flax modules on the CPU, with the
flax weights carried over by ttt_video_dit_torch/convert.py (strict load).

The model is the tiny flagship config (__graft_entry__._flagship_config(tiny=True):
d128, 8 heads, 2 layers, TTT mini-batch 8) with ``ssm_layer = "ttt_linear"``,
at 37 frames / 3 scenes / 640 tokens (interleave + reverse TTT across scenes)
and at 13 frames / 1 scene. The flax side runs use_kernel=False (the lax.scan
oracle after XLA-side preprocessing), jitted; the port runs K5's plain
version (forward) and the TTTLinearFunction over K5-train/K6's plain
versions (gradients). Weights are random float32 values of the flax tree's
shapes. Tolerance: |port - flax| <= 1e-5 * max|flax| + 1e-5 * |flax| (float32
summation order through a few layers); gradients within 1e-4 of their scale
(the same noise carried through the second-order step VJP).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.models.ttt.layer import TTTLayer as TorchTTTLayer  # noqa: E402
from ttt_video_dit_tpu.models.dit import dit as j_dit  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.models.sequence import SequenceMetadata  # noqa: E402
from ttt_video_dit_tpu.models.ttt.layer import TTTLayer  # noqa: E402

torch.set_num_threads(1)
CFG = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), ssm_layer="ttt_linear")
PORT_CFG = dataclasses.replace(CFG, use_kernel=True)  # the kernels' wrappers; on CPU tensors, their plain versions
TEXT_LEN, LAT = 16, 8
GEOMETRIES = {"37f_3scenes": (37, 3), "13f_1scene": (13, 1)}


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale)


def _close_scaled(got, want, tol, name=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, name
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"{name}: max error {err:.3g} > {tol} x max|want| {scale:.3g}"


def _random_params(init_fn, seed):
    """Random float32 weights of the flax tree's shapes: fan-in-scaled kernels,
    scales near 1, small biases, fast weights and LR gates, gates near 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            value = noise / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "ttt_norm_weight"):
            value = 1.0 + 0.1 * noise
        elif name == "gating_alpha":
            value = 0.1 + 0.05 * noise
        else:
            value = 0.05 * noise
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def _meta(frames, scenes):
    return SequenceMetadata(text_length=TEXT_LEN, num_frames=frames, num_chunks=scenes,
                            tokens_per_frame=(LAT // 2) ** 2, latent_height=LAT, latent_width=LAT)


def _port(module, params):
    return convert.load_flax_params(module, jax.tree.map(np.asarray, params))


def _layer(rng, geometry):
    meta = _meta(*GEOMETRIES[geometry])
    L = meta.seq_text_length + meta.num_video_tokens
    x = rng.standard_normal((2, L, CFG.model_dim)).astype(np.float32)
    layer = TTTLayer(CFG)
    params = _random_params(lambda: layer.init(jax.random.PRNGKey(0), jnp.asarray(x), meta), 1)
    return meta, x, layer, params


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("reverse", [False, True])
def test_ttt_linear_layer_matches_flax(rng, geometry, reverse):
    meta, x, layer, params = _layer(rng, geometry)
    assert params["params"]["W1"].shape == (CFG.num_heads, CFG.head_dim, CFG.head_dim)
    want = jax.jit(lambda p, x: layer.apply(p, x, meta, reverse=reverse))(params, jnp.asarray(x))
    with torch.inference_mode():
        got = _port(TorchTTTLayer(PORT_CFG), params).eval()(torch.from_numpy(x), meta, reverse=reverse)
    _close(got, want)


@pytest.mark.parametrize("reverse", [False, True])
def test_ttt_linear_layer_gradients_match_flax(rng, reverse):
    """d(sum(out * cot)) with respect to the input and every parameter (W1,
    b1, the TTT norm, the LR gate, the projections, post_norm) at the
    multiscene geometry, through the TTTLinearFunction (K5-train forward, K6
    backward; plain versions on CPU tensors): within 1e-4 of each scale."""
    meta, x, layer, params = _layer(rng, "37f_3scenes")
    cot = rng.standard_normal(x.shape).astype(np.float32)
    loss = lambda p, x: jnp.sum(layer.apply(p, x, meta, reverse=reverse) * cot)
    want_p, want_x = jax.jit(jax.grad(loss, argnums=(0, 1)))(params, jnp.asarray(x))
    port = _port(TorchTTTLayer(PORT_CFG), params).train()
    xt = torch.from_numpy(x).requires_grad_(True)
    (port(xt, meta, reverse=reverse) * torch.from_numpy(cot)).sum().backward()
    _close_scaled(xt.grad.numpy(), want_x, 1e-4, "x")
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, want_p))
    assert set(want) == {n for n, _ in port.named_parameters()}
    for name, p in port.named_parameters():
        _close_scaled(p.grad.numpy(), want[name].numpy(), 1e-4, name)


@pytest.fixture(scope="module")
def cogvideox():
    """flax CogVideoX (ttt_linear, random params) and the port loaded with the same weights."""
    model = CogVideoX(CFG)
    vid = jnp.zeros((1, 37, CFG.in_channels, LAT, LAT), jnp.float32)
    text = jnp.zeros((1, 3, TEXT_LEN, CFG.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), CFG.sigma_interval, jnp.int32))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid, text, jax.random.PRNGKey(1), bounds), 3)
    return model, params, _port(TorchCogVideoX(PORT_CFG), params).eval()


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_denoise_and_dit_match_flax(rng, cogvideox, geometry):
    model, params, port = cogvideox
    frames, scenes = GEOMETRIES[geometry]
    vid = rng.standard_normal((2, frames, CFG.in_channels, LAT, LAT)).astype(np.float32)
    text = rng.standard_normal((2, scenes, TEXT_LEN, CFG.text_dim)).astype(np.float32)
    a = np.array([0.3, 0.9], np.float32)
    t = np.array([700.0, 40.0], np.float32)
    want = jax.jit(lambda p, *args: model.apply(p, *args, method="denoise"))(params, *(jnp.asarray(v) for v in
                                                                                        (vid, a, text, t)))
    T = torch.from_numpy
    with torch.inference_mode():
        got = port.denoise(T(vid), T(a), T(text), T(t))
    _close(got, want)
    if scenes > 1:  # the bare DiT once, at the multiscene geometry
        dit = j_dit.DiffusionTransformer(CFG)
        want_dit = jax.jit(dit.apply)({"params": params["params"]["dit"]}, *(jnp.asarray(v) for v in (vid, text, t)))
        with torch.inference_mode():
            _close(port.dit(T(vid), T(text), T(t)), want_dit)


def test_convert_maps_every_flax_leaf(cogvideox):
    """Every flax leaf of the ttt_linear tree lands on exactly one port
    parameter (strict load): W1 [H, F, F], b1 [H, 1, F], no W2/b2."""
    _, params, port = cogvideox
    sd = port.state_dict()
    ssm = params["params"]["dit"]["layers_1"]["seq_modeling_block"]["ssm"]
    np.testing.assert_array_equal(sd["dit.layers.1.seq_modeling_block.ssm.W1"].numpy(), np.asarray(ssm["W1"]))
    assert sd["dit.layers.1.seq_modeling_block.ssm.b1"].shape == (CFG.num_heads, 1, CFG.head_dim)
    assert not any(n.endswith((".W2", ".b2")) for n in sd)
    assert len(sd) == len(jax.tree.leaves(params))
