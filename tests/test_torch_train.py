"""PyTorch port parity for the training slice (ttt_video_dit_torch/models,
training/, data/, utils/, train.py) against the JAX package on the CPU.

Weights are random float32 values of the flax tree's shapes, carried over by
ttt_video_dit_torch/convert.py (strict load); the random draws (sigma index,
noise, text-dropout keep mask) are the JAX package's own, fed to the port.
The model is the tiny flagship config (__graft_entry__._flagship_config(tiny=True):
d128, 8 heads, 2 layers, TTT mini-batch 8, checkpoint group 4) at 37 frames
of 2x2 latents and 3 scenes of 9 text tokens: 64 tokens, NC = 8, three
attention windows, interleave and reverse TTT across scenes. The JAX side
runs jitted, layers unrolled (scan_layers = false) under remat; the port
runs the training kernels' plain versions (K1-train, K2, K3 with its
log-sum-exp, K4) through their autograd Functions. Tolerances are stated per
test. The entry, text dropout and the training-config weight conversion are
in tests/test_torch_train_entry.py.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert, train  # noqa: E402
from ttt_video_dit_torch.data.dataset import SyntheticDataModule  # noqa: E402
from ttt_video_dit_torch.models.dit import schedule as t_schedule  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.training import optimizer as t_opt  # noqa: E402
from ttt_video_dit_torch.training import setup as t_setup  # noqa: E402
from ttt_video_dit_torch.training.train_step import train_step  # noqa: E402
from ttt_video_dit_torch.utils import metrics as t_metrics  # noqa: E402
from ttt_video_dit_tpu.data import dataset as j_dataset  # noqa: E402
from ttt_video_dit_tpu.models.dit import schedule as j_schedule  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.training import optimizer as j_opt  # noqa: E402
from ttt_video_dit_tpu.training import setup as j_setup  # noqa: E402
from ttt_video_dit_tpu.training.train_step import make_train_step  # noqa: E402
from ttt_video_dit_tpu.utils import metrics as j_metrics  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CFG = __graft_entry__._flagship_config(tiny=True)
PORT_CFG = dataclasses.replace(CFG, use_kernel=True)  # the Functions; on CPU tensors they run the plain versions
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
            value = noise / np.sqrt(np.prod(s.shape[:-1]))
        elif name in ("scale", "ttt_norm_weight"):
            value = 1.0 + 0.1 * noise
        elif name == "gating_alpha":
            value = 0.1 + 0.05 * noise
        else:
            value = 0.05 * noise
        return jnp.asarray(value, jnp.float32)

    return jax.tree_util.tree_map_with_path(leaf, jax.eval_shape(init_fn))


@pytest.fixture(scope="module")
def models():
    """flax CogVideoX with random params, and the port loaded with the same weights."""
    model = CogVideoX(CFG)
    vid = jnp.zeros((1, FRAMES, CFG.in_channels, LAT, LAT), jnp.float32)
    text = jnp.zeros((1, SCENES, TEXT_LEN, CFG.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), CFG.sigma_interval, jnp.int32))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid, text, jax.random.PRNGKey(1), bounds), 5)
    port = convert.load_flax_params(TorchCogVideoX(PORT_CFG), jax.tree.map(np.asarray, params)).train()
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


def test_loss_matches_flax(models, rng):
    """CogVideoX.__call__ (per-sample weighted v-prediction loss) on the same
    weights, fed the JAX draws of idx and noise: rtol 1e-5."""
    model, params, port = models
    b = _batch(rng, 2)
    key = jax.random.PRNGKey(3)
    want = jax.jit(model.apply)(params, jnp.asarray(b["vid"]), jnp.asarray(b["text"]), key,
                                (jnp.asarray(b["sigma_lo"]), jnp.asarray(b["sigma_hi"])))
    d = _jax_draws(key, b["vid"].shape, b["sigma_lo"], b["sigma_hi"])
    assert d["idx"][0] < 500 <= d["idx"][1]
    tb = _t(b)
    with torch.no_grad():
        td = _t(d)
        got = port(tb["vid"], tb["text"], (tb["sigma_lo"], tb["sigma_hi"]), idx=td["idx"], noise=td["noise"])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=0)


def _tree_to_torch(tree):
    return convert.flax_to_state_dict(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("clip_norm", [1e-3, 1e6], ids=["clipped", "unclipped"])
def test_optimizer_steps_match_optax(models, clip_norm):
    """Two steps of the grouped AdamW (global-norm clip, four groups, warm-up
    from schedule(0)) against optax's build_optimizer on the same gradients,
    on both sides of the clip threshold: parameters within 1e-7 + 1e-6 |p|
    (float32 rounding of updates ~1e-3), grad norms rtol 1e-6."""
    _, params, _ = models
    port = convert.load_flax_params(TorchCogVideoX(PORT_CFG), jax.tree.map(np.asarray, params))
    tx, _, _ = j_opt.build_optimizer(params, **OPT, gradient_clipping_norm=clip_norm)
    opt_state = tx.init(params)
    opt = t_opt.build_optimizer(port, **OPT, gradient_clipping_norm=clip_norm)

    @jax.jit
    def optax_step(grads, opt_state, params):
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state

    rng = np.random.default_rng(7)
    for _ in range(2):
        np_grads = jax.tree.map(lambda p: (rng.standard_normal(p.shape) * 0.01).astype(np.float32), params)
        g_norm = float(np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in jax.tree.leaves(np_grads))))
        params, opt_state = optax_step(jax.tree.map(jnp.asarray, np_grads), opt_state, params)
        tg = _tree_to_torch(np_grads)
        for name, p in port.named_parameters():
            p.grad = tg[name].clone()
        got_norm = float(opt.step())
        np.testing.assert_allclose(got_norm, g_norm, rtol=1e-6)
        assert (got_norm >= clip_norm) == (clip_norm == 1e-3)
    want = _tree_to_torch(params)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-6, atol=1e-7, err_msg=name)


def test_parameter_groups_match_optax_labels(models):
    """Every parameter lands in the group optax's label tree gives its flax path."""
    _, params, port = models
    _, labels, _ = j_opt.build_optimizer(params, **OPT)
    want = {k: v for k, v in zip(_tree_to_torch(params), jax.tree.leaves(labels))}
    assert len(want) == len(jax.tree.leaves(labels))
    opt = t_opt.build_optimizer(port, **OPT)
    got = {path: opt.labels[path] for path, _ in opt.params}
    assert got == {t_opt.flax_path(n): want[n] for n in want}
    assert set(got.values()) == set(t_opt.GROUPS)


@pytest.mark.parametrize("adapter", ["sft", "qkvo", "none"])
def test_trainable_and_lr_schedules_match_jax(adapter):
    paths = ["dit/layers_0/seq_modeling_block/attention/q/kernel", "dit/layers_0/seq_modeling_block/attention/q_norm/scale",
             "dit/layers_0/seq_modeling_block/ssm/W1", "dit/layers_0/mlp/layer1/bias", "dit/final_layer/linear/kernel"]
    assert [t_opt.is_trainable(p, adapter) for p in paths] == [j_opt.is_trainable(p, adapter) for p in paths]
    for kind in ("linear", "cosine"):
        got = t_opt.make_lr_schedule(kind, 3, 10, 1e-4, 1e-5)
        want = j_opt.make_lr_schedule(kind, 3, 10, 1e-4, 1e-5)
        np.testing.assert_allclose([got(s) for s in range(12)], [float(want(s)) for s in range(12)], rtol=1e-6)


def test_train_steps_match_jax(models):
    """Two full train steps, port (CPU, the training kernels' plain versions
    through their autograd Functions, per-layer recompute) against two jitted
    JAX make_train_step steps (scan_layers = false, remat on), same weights,
    batches, dropout masks and sigma draws: losses rtol 1e-5, grad norms
    rtol 1e-4 (first-order float32 noise through two layers of TTT and
    attention backward), every updated parameter within 2 % of its group's
    peak learning rate (1e-3, TTT 1e-2) + 1e-4 |p|: Adam normalizes each
    gradient element, and one whose gradient is near eps = 1e-8 turns float32
    noise into a visible share of its update."""
    model, params, _ = models
    port = convert.load_flax_params(TorchCogVideoX(PORT_CFG), jax.tree.map(np.asarray, params)).train()
    tx, _, _ = j_opt.build_optimizer(params, **OPT)
    state = j_setup.create_train_state(params, tx, "sft")
    step_fn = jax.jit(make_train_step(model, tx, text_dropout_prob=0.5))
    opt = t_opt.build_optimizer(port, **OPT)
    rng = np.random.default_rng(11)
    key = jax.random.PRNGKey(42)
    for step in range(2):
        b = _batch(rng, 2)
        state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
        d = _jax_draws(jax.random.fold_in(key, step), b["vid"].shape, b["sigma_lo"], b["sigma_hi"], 0.5)
        got = train_step(port, opt, _t(b), text_dropout_prob=0.5, draws=[_t(d)])
        np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
        np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    want = _tree_to_torch(j_opt.merge_params(state.trainable, state.frozen))
    for name, p in port.named_parameters():
        lr = OPT["lr_ssm"] if t_opt.is_ttt_parameter(t_opt.flax_path(name)) else OPT["lr"]
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=0.02 * lr, err_msg=name)


@pytest.mark.parametrize("world,batch", [(1, 1), (4, 8), (3, 6)])
def test_sigma_buckets_match_jax(world, batch):
    got = t_schedule.StratifiedSigmaBuckets.create(1000, world)
    want = j_schedule.StratifiedSigmaBuckets.create(1000, world)
    assert (got.group_num, got.group_width) == (want.group_num, want.group_width)
    for g, w in zip(got.sample_bounds(batch, world), want.sample_bounds(batch, world)):
        np.testing.assert_array_equal(g, w)


def test_synthetic_data_flops_and_example_batch_match_jax():
    """SyntheticDataModule draws the JAX module's numbers; the FLOP count is
    the JAX count; the example batch has the JAX shapes and values."""
    got = next(SyntheticDataModule((3, 2, 4, 4), (1, 5, 6), seed=3).batches(2))
    want = next(j_dataset.SyntheticDataModule((3, 2, 4, 4), (1, 5, 6), seed=3).batches(2))
    for k in ("vid", "text"):
        np.testing.assert_array_equal(got[k], want[k])
    cfg = dataclasses.replace(CFG, mini_batch_size=64)
    assert t_metrics.train_step_flops(cfg, 2, 498) == j_metrics.train_step_flops(cfg, 2, 498)
    assert t_metrics.device_peak_flops() == 989e12
    tb, jb = t_setup.make_example_batch(CFG, 2, 16, seed=4), j_setup.make_example_batch(CFG, 2, 16, seed=4)
    for k in tb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]))
