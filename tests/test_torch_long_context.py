"""Long-context geometry (9–63 s) of the PyTorch port against the JAX package
on the CPU, the memory-bounded token-wise path, and the sampling entry's
``[parallelism]`` warning.

- The 63 s structure of tests/test_63s_geometry.py: 21 scenes, 21
  overlapping attention windows (prefix 1 + 21 x 2 frames = 43), d32, 2
  heads, CS 8, checkpoint group 5, which does not divide NC = 32; and a
  9 s-shaped case (3 scenes, 37 frames, windows of 1 + 12 frames, NC = 20,
  checkpoint group 6: a ragged last group of 2; in
  tests/test_torch_long_context_9s.py). Both variants, the port's
  DiT (the training kernels' plain versions through their autograd
  Functions) against the flax CogVideoX with the same weights carried by
  ``convert.load_flax_params`` and the JAX draws: the training loss rtol
  1e-5 and every parameter's gradient within 1e-4 relative L2 (float32
  summation order through TTT and attention backward).
- The chunking of the MLP (over tokens) and the attention's q/k LayerNorm +
  rope (over windows) (``models/dit/dit.py:in_chunks``) at a budget of a few
  rows a chunk against one chunk (the computation without it), same
  weights and inputs. The q/k chunks hold no matmul and are bit-equal; the
  MLP's are not on the CPU: its float32 and bf16 matmuls round differently
  for different row counts (about two thirds of the float32 forward's
  outputs differ in their last bits). Tolerances: float32 forward and loss
  1e-6 relative L2 (measured ~1.2e-7 and 0), gradients 5e-6 (~8.6e-7: a
  weight's gradient sums the chunks in another order), the bf16 sampling
  forward 1e-2 (~2.9e-3: bf16 roundings of intermediate values). At the 3 s
  shapes each site is one chunk, so that path is unchanged.
"""

import ast
import dataclasses
import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ttt_video_dit_torch import convert, sample  # noqa: E402
from ttt_video_dit_torch.config.model_config import ModelConfig as TorchModelConfig  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.models.dit import dit  # noqa: E402
from ttt_video_dit_tpu.config.model_config import ModelConfig  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
# frames, attention length, scenes, text tokens a scene, checkpoint group: 63 s (21 x 4 + 43 x 4 = 256 tokens,
# NC 32, groups of 5) and 9 s (3 x 4 + 37 x 4 = 160 tokens, NC 20, groups of 6).
GEOMETRIES = {"63s_21_scenes": (43, 2, 21, 4, 5), "9s_3_scenes": (37, 12, 3, 4, 6),
              # Windows of 2 + 12 and 3 + 12 frames (3 x 8 + 38 x 4 = 176 and 3 x 4 + 39 x 4 = 168 tokens, NC 22 and
              # 21, groups of 6): tests/test_torch_prefix_windows.py.
              "38f_prefix_2": (38, 12, 3, 8, 6), "39f_prefix_3": (39, 12, 3, 4, 6)}
# prefix_temporal_length of a geometry; 1 where it is not named.
PREFIX = {"38f_prefix_2": 2, "39f_prefix_3": 3}
# The JAX compiles of both geometries take ~55 s: this file holds the 63 s cases, tests/test_torch_long_context_9s.py
# the 9 s ones (xdist deals whole files, so each stays under a minute).
VARIANTS = ["ttt_mlp", "ttt_linear"]
GRAD_REL_L2 = 1e-4
CHUNKED_GRAD_REL_L2 = 5e-6
CHUNKED_REL_L2 = {"float32": 1e-6, "bfloat16": 1e-2}


def _config(cls, geometry, variant, **kw):
    frames, attn, _, _, group = GEOMETRIES[geometry]
    return cls(model_dim=32, num_heads=2, num_layers=1, ssm_layer=variant, mini_batch_size=8, latent_height=2,
               latent_width=2, compressed_num_frames=frames, attn_length=attn,
               prefix_temporal_length=PREFIX.get(geometry, 1), text_dim=16,
               time_embed_dim=16, scan_checkpoint_group_size=group, use_kernel=False, dtype="float32",
               ttt_base_lr=1.0 if variant == "ttt_linear" else 0.1, **kw)


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


def _inputs(geometry, cfg, seed=0):
    frames, _, scenes, text_len, _ = GEOMETRIES[geometry]
    rng = np.random.default_rng(seed)
    h = cfg.latent_height * cfg.patch_size
    vid = rng.standard_normal((2, frames, cfg.in_channels, h, h)).astype(np.float32)
    text = rng.standard_normal((2, scenes, text_len, cfg.text_dim)).astype(np.float32)
    return vid, text, np.array([0, 500], np.int32), np.array([500, 1000], np.int32)


def _jax_draws(key, shape, lo, hi):
    """The draws of idx and noise CogVideoX.__call__ makes from ``key``."""
    key_idx, key_noise = jax.random.split(key)
    u = jax.random.randint(key_idx, (shape[0],), 0, jnp.int32(1) << 30, dtype=jnp.int32)
    idx = np.asarray(jnp.asarray(lo) + u % jnp.maximum(jnp.asarray(hi) - jnp.asarray(lo), 1))
    return idx, np.asarray(jax.random.normal(key_noise, shape, jnp.float32))


def _port_loss_and_grads(port, vid, text, lo, hi, idx, noise):
    port.zero_grad(set_to_none=True)
    t = torch.from_numpy
    loss = port(t(vid), t(text), (t(lo), t(hi)), idx=t(np.array(idx)), noise=t(np.array(noise))).mean()
    loss.backward()
    return float(loss.detach()), {n: p.grad.detach().clone() for n, p in port.named_parameters()}


def check_loss_and_gradients_match_jax(geometry, variant):
    """The training loss and every parameter's gradient of the port's DiT at
    ``geometry`` against the flax model's, same weights and draws."""
    cfg = _config(ModelConfig, geometry, variant)
    vid, text, lo, hi = _inputs(geometry, cfg)
    assert cfg.num_chunks == GEOMETRIES[geometry][2]
    model = CogVideoX(cfg)
    bounds = (jnp.asarray(lo), jnp.asarray(hi))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(vid), jnp.asarray(text),
                                               jax.random.PRNGKey(1), bounds), 7)
    key = jax.random.PRNGKey(2)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: model.apply(p, jnp.asarray(vid), jnp.asarray(text), key, bounds).mean()))(params)
    port_cfg = _config(TorchModelConfig, geometry, variant)
    port_cfg.use_kernel = True  # the autograd Functions; on CPU tensors they run the plain versions
    port = convert.load_flax_params(TorchCogVideoX(port_cfg), jax.tree.map(np.asarray, params)).train()
    got_loss, got = _port_loss_and_grads(port, vid, text, lo, hi, *_jax_draws(key, vid.shape, lo, hi))
    np.testing.assert_allclose(got_loss, float(loss), rtol=1e-5)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, grads))
    assert set(want) == set(got)
    nonzero = 0
    for name, w in want.items():
        g, w = got[name].double(), w.double()
        err = float((g - w).norm() / w.norm().clamp_min(1e-30))
        assert err <= GRAD_REL_L2 or float((g - w).abs().max()) <= 1e-9, f"{name}: relative L2 {err:.3g}"
        nonzero += bool(w.abs().max() > 0)
    assert nonzero / len(want) > 0.9  # 21 windows and both TTT directions leave no dead parameters


@pytest.mark.parametrize("variant", VARIANTS)
def test_63s_loss_and_gradients_match_jax(variant):
    """21 scenes, 21 windows, NC 32 in checkpoint groups of 5 (the last of 2)."""
    check_loss_and_gradients_match_jax("63s_21_scenes", variant)


def _port_model(geometry, variant, dtype="float32", seed=3):
    cfg = _config(TorchModelConfig, geometry, variant)
    cfg.use_kernel, cfg.dtype = True, dtype
    model = TorchCogVideoX(cfg)
    from ttt_video_dit_torch.models.dit.dit import init_params_

    init_params_(model, torch.Generator().manual_seed(seed))
    with torch.no_grad():  # no zero bias or unit norm left: every term of every site matters
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator().manual_seed(p.numel())))
    return cfg, model


@pytest.mark.parametrize("variant", VARIANTS)
def test_chunked_training_path(monkeypatch, variant):
    """Loss and gradients of the 63 s structure with a token-wise budget of a
    few tokens a chunk against one chunk (float32): the loss within
    CHUNKED_REL_L2, every gradient within CHUNKED_GRAD_REL_L2 (a weight's
    gradient is summed over the chunks in another order)."""
    _, model = _port_model("63s_21_scenes", variant)
    vid, text, lo, hi = _inputs("63s_21_scenes", model.config)
    draws = (np.array([300, 700]), np.random.default_rng(1).standard_normal(vid.shape).astype(np.float32))
    want = _port_loss_and_grads(model, vid, text, lo, hi, *draws)
    monkeypatch.setattr(dit, "CHUNK_BYTES", 4096)  # 1-8 tokens or 1 window a chunk at d32
    got = _port_loss_and_grads(model, vid, text, lo, hi, *draws)
    assert abs(got[0] - want[0]) <= CHUNKED_REL_L2["float32"] * abs(want[0])
    worst = 0.0
    for name, w in want[1].items():
        g = got[1][name]
        worst = max(worst, float((g - w).double().norm() / w.double().norm().clamp_min(1e-30)))
    assert worst <= CHUNKED_GRAD_REL_L2


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_chunked_sampling_forward(monkeypatch, variant, dtype):
    """One CFG-batch DiT forward under inference mode at the 63 s structure,
    chunked against one chunk, within CHUNKED_REL_L2 (the CPU's matmuls
    round differently for different row counts). The chunking really splits every site."""
    _, model = _port_model("63s_21_scenes", variant, dtype=dtype)
    dit.cast_matmul_weights_(model, dit.compute_dtype(model.config)).eval()
    vid, text, _, _ = _inputs("63s_21_scenes", model.config)
    vid, text, t = torch.from_numpy(vid).to(dit.compute_dtype(model.config)), torch.from_numpy(text), torch.tensor(
        [999.0, 400.0])
    with torch.inference_mode():
        want = model.dit(vid, text, t)
    calls = []
    chunked = dit.in_chunks

    def counting(fn, x, row_bytes, dim=1):
        calls.append(-(-x.shape[dim] // max(1, dit.CHUNK_BYTES // row_bytes)))
        return chunked(fn, x, row_bytes, dim)

    monkeypatch.setattr(dit, "CHUNK_BYTES", 2048)
    monkeypatch.setattr(dit, "in_chunks", counting)
    with torch.inference_mode():
        got = model.dit(vid, text, t)
    g, w = got.double(), want.double()
    rel = float((g - w).norm() / w.norm())
    assert rel <= CHUNKED_REL_L2[dtype]
    assert len(calls) == 3 and min(calls) > 1, calls  # the layer's q and k norm-rope and MLP, each split


def test_k7_casts_each_weight_once_when_chunked(monkeypatch):
    """Under scan_layers (the train TOMLs), a chunked MLP casts its two weights
    through K7 once a pass, not once a chunk: 12 casts a layer and pass, as
    without chunking (tests/test_torch_remat.py)."""
    from ttt_video_dit_torch.ops import convert as convert_ops

    n = {"casts": 0}
    plain = convert_ops.convert_f32_bf16_plain

    def counted(x):
        n["casts"] += 1
        return plain(x)

    monkeypatch.setattr(convert_ops, "convert_f32_bf16_plain", counted)
    monkeypatch.setattr(dit, "CHUNK_BYTES", 4096)
    cfg = _config(TorchModelConfig, "63s_21_scenes", "ttt_mlp", scan_layers=True)
    cfg.use_kernel, cfg.dtype = True, "bfloat16"
    from ttt_video_dit_torch.models.dit.dit import init_params_

    model = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(0)).train()
    vid, text, lo, hi = _inputs("63s_21_scenes", cfg)
    draws = (np.array([300, 700]), np.random.default_rng(1).standard_normal(vid.shape).astype(np.float32))
    _port_loss_and_grads(model, vid, text, lo, hi, *draws)
    assert n["casts"] == 2 * 12 * cfg.num_layers  # the forward, and the per-layer recompute under "none"


def test_one_chunk_at_the_3s_shapes():
    """At the 3 s eval shape (L = 18,048, CFG batch 2, d3072) every site fits
    one chunk, so the 3 s path runs as it did without chunking."""
    D, L, B = 3072, 18048, 2
    assert dit.CHUNK_BYTES // (4 * 4 * D * 2 * B) >= L  # the MLP's hidden values and GELU terms, bf16
    assert dit.CHUNK_BYTES // (12 * L * D) >= B  # the q/k norm-rope of the 2 windows


def _jax_warning_fragments():
    """The literal pieces of the JAX entry's [parallelism] warning (sample.py at the repo root)."""
    tree = ast.parse((REPO / "sample.py").read_text(encoding="utf-8"))
    for node in ast.walk(tree):
        if isinstance(node, ast.JoinedStr):
            parts = [v.value for v in node.values if isinstance(v, ast.Constant)]
            if parts and parts[0].startswith("WARNING: [parallelism]"):
                return parts
    raise AssertionError("no [parallelism] warning in sample.py")


@pytest.mark.parametrize("toml,warned", [("configs/eval/ttt-mlp/63s.toml", True), ("configs/eval/ttt-mlp/30s.toml", True),
                                         ("configs/eval/ttt-mlp/3s.toml", False),
                                         ("configs/eval/ttt-linear/9s.toml", False)])
def test_parallelism_warning_is_the_jax_entrys(toml, warned):
    """The 30 s and 63 s eval TOMLs ask for tp_sharding = 2: the entry prints
    the JAX entry's warning word for word with the card count and samples on
    one card; the 3 s and 9 s TOMLs ask for one card and it says nothing."""
    job = sample.parse_args(["--job.config_file", toml])
    out = io.StringIO()
    with redirect_stdout(out):
        assert sample.warn_parallelism(job) is warned
    if not warned:
        assert out.getvalue() == ""
        return
    p = job.parallelism
    want = (f"WARNING: [parallelism] asks for replicate={p.dp_replicate} fsdp={p.dp_sharding} tp={p.tp_sharding} but "
            f"only {torch.cuda.device_count()} device(s) visible; sampling unsharded\n")
    assert out.getvalue() == want and p.tp_sharding == 2
    text = want
    for piece in _jax_warning_fragments():
        assert piece in text
        text = text[text.index(piece) + len(piece):]


def test_sampling_entry_on_the_63s_toml(tmp_path):
    """The entry on configs/eval/ttt-mlp/63s.toml at tiny width from a
    21-scene storyboard: the warning, one card, finite [253, 16, h, w]
    latents, the sequence length and window count in its first line and
    summary."""
    board = tmp_path / "board.json"
    board.write_text(json.dumps([[{"text": f"scene {i}", "neg_text": None} for i in range(21)]]))
    job = sample.parse_args(["--job.config_file", "configs/eval/ttt-mlp/63s.toml", "--eval.input_file", str(board),
                             "--eval.num_denoising_steps", "2", "--guider.num_steps", "2", "--eval.image_height", "32",
                             "--eval.image_width", "32", "--eval.txt_maxlen", "12", "--model.latent_height", "2",
                             "--model.latent_width", "2", "--model.model_dim", "32", "--model.num_heads", "2",
                             "--model.num_layers", "1", "--job.platform", "cpu", "--eval.output_dir",
                             str(tmp_path / "out")])
    out = io.StringIO()
    with redirect_stdout(out):
        summary = sample.main(job)
    lines = out.getvalue().splitlines()
    assert "sequence 1264 tokens (21 scenes x 12 text + 253 frames x 4), 21 attention windows of 64 tokens" in lines[0]
    assert lines[1].startswith("WARNING: [parallelism] asks for replicate=1 fsdp=1 tp=2")
    assert (summary["seq_len"], summary["windows"], len(summary["eval_seconds"])) == (1264, 21, 2)
    latents = np.load(summary["latents"][0])
    assert latents.shape == (253, 16, 4, 4) and np.isfinite(latents).all()
