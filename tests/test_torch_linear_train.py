"""PyTorch port parity for ``ttt_linear`` training (ttt_video_dit_torch/models,
training/) against the JAX package on the CPU. The entries on the ttt-linear
TOMLs are in tests/test_torch_linear_entry.py.

The model is the tiny flagship config (__graft_entry__._flagship_config(tiny=True):
d128, 8 heads, 2 layers, TTT mini-batch 8, checkpoint group 4) with
``ssm_layer = "ttt_linear"``, at 37 frames of 2x2 latents and 3 scenes of 9
text tokens (64 tokens, NC = 8), adapter ``qkvo`` as the ttt-linear train
TOMLs set it. Weights are random float32 values of the flax tree's shapes,
carried over by ttt_video_dit_torch/convert.py (strict load); the random
draws (sigma index, noise, text-dropout keep mask) are the JAX package's own,
fed to the port. The port runs K5-train, K6, K3 with its log-sum-exp and K4
(their plain versions on CPU tensors) through their autograd Functions, and
the layer stack's weight cast (K7) where ``scan_layers`` is set. Tolerances
are stated per test.
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
from ttt_video_dit_torch.training import optimizer as t_opt  # noqa: E402
from ttt_video_dit_torch.training.train_step import train_step  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import convert as j_convert  # noqa: E402
from ttt_video_dit_tpu.training import optimizer as j_opt  # noqa: E402
from ttt_video_dit_tpu.training import setup as j_setup  # noqa: E402
from ttt_video_dit_tpu.training.train_step import make_train_step  # noqa: E402

torch.set_num_threads(1)
CFG = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), ssm_layer="ttt_linear")
FRAMES, SCENES, TEXT_LEN, LAT = 37, 3, 9, 2  # 3 * 9 + 37 * 1 = 64 tokens, NC = 8
OPT = dict(lr=1e-3, lr_ssm=1e-2, lr_end=1e-4, lr_schedule="linear", lr_ssm_schedule="cosine", warmup_steps=2,
           total_steps=10)


def _random_params(init_fn, seed):
    """Random float32 weights of the flax tree's shapes: fan-in-scaled kernels,
    scales near 1, small biases, fast weights and LR gates, gates near 0.1."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        noise = rng.standard_normal(s.shape).astype(np.float32)
        if name == "kernel":
            value = noise / np.sqrt(s.shape[-2])
        elif name in ("scale", "ttt_norm_weight"):
            value = 1.0 + 0.1 * noise
        elif name == "gating_alpha":
            value = 0.1 + 0.05 * noise
        else:
            value = 0.05 * noise
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


def _models(cfg, seed=5):
    """flax CogVideoX of ``cfg`` with random params, and the port loaded with the same weights."""
    model = CogVideoX(cfg)
    vid = jnp.zeros((1, FRAMES, cfg.in_channels, LAT, LAT), jnp.float32)
    text = jnp.zeros((1, SCENES, TEXT_LEN, cfg.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), cfg.sigma_interval, jnp.int32))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid, text, jax.random.PRNGKey(1), bounds), seed)
    port_cfg = dataclasses.replace(cfg, use_kernel=True)  # the wrappers; on CPU tensors they run the plain versions
    port = convert.load_flax_params(TorchCogVideoX(port_cfg), jax.tree.map(np.asarray, params)).train()
    return model, params, port


def _batch(rng, B):
    return dict(vid=rng.standard_normal((B, FRAMES, CFG.in_channels, LAT, LAT)).astype(np.float32),
                text=rng.standard_normal((B, SCENES, TEXT_LEN, CFG.text_dim)).astype(np.float32),
                sigma_lo=np.array([0, 500][:B], np.int32), sigma_hi=np.array([500, 1000][:B], np.int32))


def _jax_draws(key, shape, lo, hi, dropout_prob=None):
    """The draws CogVideoX.__call__ (and, with a dropout prob, the train
    step's text dropout) make from ``key``."""
    out = {}
    if dropout_prob is not None:
        k_drop, key = jax.random.split(key)
        out["keep"] = np.asarray(jax.random.bernoulli(k_drop, 1.0 - dropout_prob, (shape[0],)))
    key_idx, key_noise = jax.random.split(key)
    u = jax.random.randint(key_idx, (shape[0],), 0, jnp.int32(1) << 30, dtype=jnp.int32)
    out["idx"] = np.asarray(jnp.asarray(lo) + u % jnp.maximum(jnp.asarray(hi) - jnp.asarray(lo), 1))
    out["noise"] = np.asarray(jax.random.normal(key_noise, shape, jnp.float32))
    return out


def _t(d):
    return {k: torch.from_numpy(np.array(v)) for k, v in d.items()}  # np.array: a writable copy


@pytest.mark.parametrize("scan_layers", [False, True], ids=["unrolled", "scan_layers"])
def test_train_steps_match_jax(monkeypatch, scan_layers):
    """Two full train steps with the qkvo adapter, port (CPU, the training
    kernels' plain versions through their autograd Functions, per-layer
    recompute) against two jitted JAX make_train_step steps (remat on), same
    weights, batches, dropout masks and sigma draws. With ``scan_layers`` the
    JAX model scans its layers (and convert._INTERPRET is on, so its weight
    pin is the Pallas path; in float32 the cast is the identity) and its
    stacked params reach the port's unrolled layers through convert.py's
    unstacking. Losses rtol 1e-5, grad norms rtol 1e-4 (first-order float32
    noise through two layers of TTT and attention backward), every updated
    parameter within 2 % of its group's peak learning rate (1e-3, TTT 1e-2)
    + 1e-4 |p| (Adam normalises each gradient element, and one near eps =
    1e-8 turns float32 noise into a visible share of its update); the frozen
    ones unchanged. The key LayerNorm's bias is held only within the two
    steps' reach, 2 x its peak learning rate: softmax ignores a shift of every
    key by one vector, so its gradient vanishes in exact arithmetic on the
    features rope leaves unrotated (measured: elements of 1e-11 beside 1e-3),
    and Adam moves those by the sign of float32 noise. Its gradient is held
    through the grad norm."""
    monkeypatch.setattr(j_convert, "_INTERPRET", True)
    model, params, port = _models(dataclasses.replace(CFG, scan_layers=scan_layers))
    assert ("scan_layers" in params["params"]["dit"]) == scan_layers
    trainable, _ = j_opt.partition_params(params, "qkvo")
    tx, _, _ = j_opt.build_optimizer(trainable, **OPT)
    state = j_setup.create_train_state(params, tx, "qkvo")
    step_fn = jax.jit(make_train_step(model, tx, text_dropout_prob=0.5))
    opt = t_opt.build_optimizer(port, **OPT, adapter_method="qkvo")
    frozen = {n: p.detach().clone() for n, p in port.named_parameters() if not p.requires_grad}
    assert frozen and len(frozen) < len(list(port.parameters()))
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(42)
    for step in range(2):
        b = _batch(rng, 2)
        state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        d = _jax_draws(jax.random.fold_in(key, step), b["vid"].shape, b["sigma_lo"], b["sigma_hi"], 0.5)
        got = train_step(port, opt, _t(b), text_dropout_prob=0.5, draws=[_t(d)])
        np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, j_opt.merge_params(state.trainable, state.frozen)))
    for name, p in port.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name
        lr = OPT["lr_ssm"] if t_opt.is_ttt_parameter(t_opt.flax_path(name)) else OPT["lr"]
        share = 2.0 if name.endswith("attention.k_norm.bias") else 0.02
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=share * lr, err_msg=name)


def test_bf16_loss_through_the_weight_pin_matches_jax(monkeypatch, rng):
    """bf16 compute with scan_layers: the JAX model casts every 2-D Dense
    kernel of its scanned layer stack through K7 (the Pallas kernel, in the
    interpreter: the traced loss holds pallas_calls), the port's unrolled
    model through K7's plain version in each pinned Linear. Same loss within
    2e-2 relative: both round the same weights to bf16 once, then carry bf16
    activations whose roundings differ between XLA and PyTorch through two
    layers."""
    monkeypatch.setattr(j_convert, "_INTERPRET", True)
    cfg = dataclasses.replace(CFG, scan_layers=True, dtype="bfloat16")
    model, params, port = _models(cfg)
    assert all(m.pin is not None for n, m in port.named_modules() if n.startswith("dit.layers.") and
               type(m).__name__ == "Linear")
    b = _batch(rng, 2)
    key = jax.random.PRNGKey(3)
    args = (jnp.asarray(b["vid"]), jnp.asarray(b["text"]), key, (jnp.asarray(b["sigma_lo"]), jnp.asarray(b["sigma_hi"])))
    assert "pallas_call" in str(jax.make_jaxpr(model.apply)(params, *args))
    want = jax.jit(model.apply)(params, *args)
    d = _t(_jax_draws(key, b["vid"].shape, b["sigma_lo"], b["sigma_hi"]))
    tb = _t(b)
    with torch.no_grad():
        got = port(tb["vid"], tb["text"], (tb["sigma_lo"], tb["sigma_hi"]), idx=d["idx"], noise=d["noise"])
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), rtol=2e-2)
