"""PyTorch port parity: the TTT layer, segment-local attention, the DiT and
CogVideoX.denoise (ttt_video_dit_torch/models) against the flax modules
(use_kernel=False) on the CPU, with the flax weights carried over by
ttt_video_dit_torch/convert.py (strict load).

Geometries: the tiny flagship config (__graft_entry__._flagship_config(tiny=True):
d128, 8 heads, 2 layers, TTT mini-batch 8) at 37 frames / 3 scenes / 640
tokens (interleave + reverse TTT across scenes) and at 13 frames / 1 scene.
Weights are random float32 values of the flax tree's shapes (no
zero-initialised bias or gate left), and the flax side runs jitted.
Tolerance: |port - flax| <= 1e-5 * max|flax| + 1e-5 * |flax| (float32
summation order through a few layers).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.models.dit import dit as t_dit  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.models.ttt.layer import TTTLayer as TorchTTTLayer  # noqa: E402
from ttt_video_dit_tpu.models.dit import dit as j_dit  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.models.sequence import SequenceMetadata  # noqa: E402
from ttt_video_dit_tpu.models.ttt.layer import TTTLayer  # noqa: E402

torch.set_num_threads(1)
CFG = __graft_entry__._flagship_config(tiny=True)
TEXT_LEN, LAT = 16, 8  # text tokens per scene; latent pixels (4x4 token grid after 2x2 patches)
GEOMETRIES = {"37f_3scenes": (37, 3), "13f_1scene": (13, 1)}


def _close(got, want):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=1e-5, atol=1e-5 * scale)


def _random_params(init_fn, seed):
    """Random weights of the flax tree's shapes (eval_shape: no init forward
    pass): fan-in-scaled kernels, LayerNorm/TTT-norm scales near 1, small
    biases, fast weights and LR gates, gates near their 0.1 init."""
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
        else:  # biases, W1/b1/W2/b2, learnable_ttt_lr_*
            value = 0.05 * noise
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def _meta(frames, scenes):
    return SequenceMetadata(text_length=TEXT_LEN, num_frames=frames, num_chunks=scenes,
                            tokens_per_frame=(LAT // 2) ** 2, latent_height=LAT, latent_width=LAT)


def _port(module, params):
    return convert.load_flax_params(module, jax.tree.map(np.asarray, params)).eval()


@pytest.mark.parametrize("geometry", GEOMETRIES)
@pytest.mark.parametrize("reverse", [False, True])
def test_ttt_layer_matches_flax(rng, geometry, reverse):
    meta = _meta(*GEOMETRIES[geometry])
    L = meta.seq_text_length + meta.num_video_tokens
    x = rng.standard_normal((2, L, CFG.model_dim)).astype(np.float32)
    layer = TTTLayer(CFG)
    params = _random_params(lambda: layer.init(jax.random.PRNGKey(0), jnp.asarray(x), meta), 1)
    want = jax.jit(lambda p, x: layer.apply(p, x, meta, reverse=reverse))(params, jnp.asarray(x))
    with torch.inference_mode():
        got = _port(TorchTTTLayer(CFG), params)(torch.from_numpy(x), meta, reverse=reverse)
    _close(got, want)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_segment_local_attention_matches_flax(rng, geometry):
    meta = _meta(*GEOMETRIES[geometry])
    vid = rng.standard_normal((2, meta.num_video_tokens, CFG.model_dim)).astype(np.float32)
    text = rng.standard_normal((2, meta.seq_text_length, CFG.model_dim)).astype(np.float32)
    mod = j_dit.SegmentLocalAttention(CFG)
    params = _random_params(lambda: mod.init(jax.random.PRNGKey(0), jnp.asarray(vid), jnp.asarray(text), meta), 2)
    want = jax.jit(lambda p, v, t: mod.apply(p, v, t, meta))(params, jnp.asarray(vid), jnp.asarray(text))
    with torch.inference_mode():
        got = _port(t_dit.SegmentLocalAttention(CFG), params)(torch.from_numpy(vid), torch.from_numpy(text), meta)
    _close(got, want)


@pytest.fixture(scope="module")
def cogvideox():
    """flax CogVideoX (random params) and the port loaded with the same weights."""
    model = CogVideoX(CFG)
    vid = jnp.zeros((1, 37, CFG.in_channels, LAT, LAT), jnp.float32)
    text = jnp.zeros((1, 3, TEXT_LEN, CFG.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), CFG.sigma_interval, jnp.int32))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid, text, jax.random.PRNGKey(1), bounds), 3)
    return model, params, _port(TorchCogVideoX(CFG), params)


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_denoise_and_dit_match_flax(rng, cogvideox, geometry):
    model, params, port = cogvideox
    frames, scenes = GEOMETRIES[geometry]
    vid = rng.standard_normal((2, frames, CFG.in_channels, LAT, LAT)).astype(np.float32)
    text = rng.standard_normal((2, scenes, TEXT_LEN, CFG.text_dim)).astype(np.float32)
    a = np.array([0.3, 0.9], np.float32)
    t = np.array([700.0, 40.0], np.float32)

    denoise = jax.jit(lambda p, *args: model.apply(p, *args, method="denoise"))
    want = denoise(params, *(jnp.asarray(x) for x in (vid, a, text, t)))
    T = torch.from_numpy
    with torch.inference_mode():
        got = port.denoise(T(vid), T(a), T(text), T(t))
    _close(got, want)
    if scenes > 1:  # the bare DiT once, at the multiscene geometry
        dit = j_dit.DiffusionTransformer(CFG)
        want_dit = jax.jit(dit.apply)({"params": params["params"]["dit"]}, *(jnp.asarray(x) for x in (vid, text, t)))
        with torch.inference_mode():
            _close(port.dit(T(vid), T(text), T(t)), want_dit)


def test_convert_maps_every_flax_leaf(cogvideox):
    """Every flax leaf lands on exactly one port parameter (strict load), with
    Dense kernels transposed and the conv kernel HWIO -> OIHW."""
    _, params, port = cogvideox
    p = params["params"]["dit"]
    sd = port.state_dict()
    np.testing.assert_array_equal(sd["dit.time_embed_0.weight"].numpy(), np.asarray(p["time_embed_0"]["kernel"]).T)
    np.testing.assert_array_equal(sd["dit.patch_embedding.vid_proj.weight"].numpy(),
                                  np.asarray(p["patch_embedding"]["vid_proj"]["kernel"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["dit.layers.1.seq_modeling_block.ssm.W1"].numpy(),
                                  np.asarray(p["layers_1"]["seq_modeling_block"]["ssm"]["W1"]))
    assert len(sd) == len(jax.tree.leaves(params))


def test_cast_matmul_weights_rounds_once():
    """The one-time cast gives the bf16 values flax's per-call promote_dtype
    gives, and leaves LayerNorm, TTT state and gates in float32."""
    cfg = dataclasses.replace(CFG, num_layers=1)
    model = t_dit.init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(0))
    w = model.dit.layers[0].mlp.layer1.weight.detach().clone().numpy()
    t_dit.cast_matmul_weights_(model, torch.bfloat16)
    layer = model.dit.layers[0]
    assert layer.mlp.layer1.weight.dtype == torch.bfloat16
    np.testing.assert_array_equal(layer.mlp.layer1.weight.detach().float().numpy(),
                                  np.asarray(jnp.asarray(w).astype(jnp.bfloat16).astype(jnp.float32)))
    ssm = layer.seq_modeling_block.ssm
    for p in (ssm.W1, ssm.ttt_norm_weight, ssm.post_norm.weight, layer.seq_modeling_block.forward_ssm_gating_text.gating_alpha):
        assert p.dtype == torch.float32


@pytest.mark.parametrize("scenes", [1, 3, 21])
def test_reverse_text_chunks_matches_jax(rng, scenes):
    """The scenes' text blocks in reverse order, each block's tokens in order, and an involution."""
    from ttt_video_dit_torch.models.ttt.interleave import reverse_text_chunks
    from ttt_video_dit_tpu.models.ttt.interleave import reverse_text_chunks as jax_reverse_text_chunks

    x = rng.standard_normal((2, scenes * 5, 4)).astype(np.float32)
    got = reverse_text_chunks(torch.from_numpy(x), scenes)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_reverse_text_chunks(jnp.asarray(x), scenes)))
    np.testing.assert_array_equal(got.numpy()[:, :5], x[:, -5:])
    assert torch.equal(reverse_text_chunks(got, scenes), torch.from_numpy(x))
