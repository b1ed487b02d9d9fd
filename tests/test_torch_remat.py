"""The port's remat policy (ttt_video_dit_torch/models/dit/dit.py:_ckpt_policy)
and the layer weights' K7 casts, on the CPU.

"save_seq" keeps the outputs of the custom ops K1-train / K5-train (the TTT
scans' output and state checkpoints) and K3-lse (attention's output and
log-sum-exp) across the per-layer torch.utils.checkpoint, so the backward's
recompute runs neither; on CPU tensors those ops run their plain versions,
which the tests count. A policy must never change values: the port's DiT
gradients under save_seq equal those under "none" bit for bit, and match
the JAX package's under save_seq (gradients within 1e-4 of their scale, as
tests/test_torch_linear_model.py holds DiT-layer gradients). Under
scan_layers the layer stack's 2-D weights are cast through K7 (its plain
version here) 12 times a layer and pass: the TTT projections once for both
directions, as the JAX pin casts each stacked kernel once per layer body.
The model is the tiny flagship config at 37 frames of 2x2 latents and 3
scenes of 9 text tokens (64 tokens, NC = 8, three attention windows).
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
from ttt_video_dit_torch.models.dit.dit import init_params_  # noqa: E402
from ttt_video_dit_torch.ops import attention, convert as convert_ops, ttt_linear_kernel, ttt_mlp_kernel  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402

torch.set_num_threads(1)
CFG = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), use_kernel=True)
FRAMES, SCENES, TEXT_LEN, LAT = 37, 3, 9, 2  # 3 * 9 + 37 * 1 = 64 tokens, NC = 8
VARIANTS = {"ttt_mlp": (ttt_mlp_kernel, "ttt_mlp_forward_plain"),
            "ttt_linear": (ttt_linear_kernel, "ttt_linear_forward_plain")}


def _inputs(seed=1):
    g = torch.Generator().manual_seed(seed)
    vid = torch.randn(1, FRAMES, CFG.in_channels, LAT, LAT, generator=g)
    text = torch.randn(1, SCENES, TEXT_LEN, CFG.text_dim, generator=g)
    return vid, text, torch.tensor([300]), torch.randn(vid.shape, generator=g)


def _counting(monkeypatch, variant):
    """Count the plain training forwards (with checkpoints) and the plain
    attention forwards with the log-sum-exp that the custom ops' CPU kernels run."""
    calls = {"scan": 0, "attention": 0}
    mod, name = VARIANTS[variant]
    scan, attn = getattr(mod, name), attention.attention_plain

    def scan_counted(*a, **k):
        calls["scan"] += bool(k.get("checkpoint_group"))
        return scan(*a, **k)

    def attn_counted(*a, **k):
        calls["attention"] += bool(k.get("return_lse"))
        return attn(*a, **k)

    monkeypatch.setattr(mod, name, scan_counted)
    monkeypatch.setattr(attention, "attention_plain", attn_counted)
    return calls


def _port_grads(cfg, seed=0):
    model = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(seed)).train()
    vid, text, idx, noise = _inputs()
    loss = model(vid, text, (torch.tensor([0]), torch.tensor([1000])), idx=idx, noise=noise).mean()
    loss.backward()
    return loss.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_save_seq_grads_equal_none_and_halve_the_forwards(monkeypatch, variant):
    """Two layers, per-layer recompute: under "none" each layer runs its two
    scans and its attention twice (forward and recompute), under save_seq
    once; loss and every gradient are bit-equal. In the config's float32 and
    in bf16: at float32 attention takes its plain versions by the model's
    route (ops/attention.py:use_plain, the JAX package's XLA route), which is
    no custom op, so save_seq keeps nothing of it and the recompute runs it
    again under either policy; the scans' custom ops are kept at both."""
    calls = _counting(monkeypatch, variant)
    for dtype in ("float32", "bfloat16"):
        results = {}
        for policy in ("none", "save_seq"):
            calls.update(scan=0, attention=0)
            cfg = dataclasses.replace(CFG, ssm_layer=variant, remat_policy=policy, dtype=dtype)
            results[policy] = _port_grads(cfg)
            L = CFG.num_layers
            runs = 2 if policy == "none" else 1
            expect = {"scan": 2 * runs * L, "attention": (2 if dtype == "float32" else runs) * L}
            assert calls == expect, (dtype, policy, calls)
        (loss_n, grads_n), (loss_s, grads_s) = results["none"], results["save_seq"]
        assert torch.equal(loss_n, loss_s), dtype
        assert grads_n.keys() == grads_s.keys()
        for name in grads_n:
            assert torch.equal(grads_n[name], grads_s[name]), (dtype, name)


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="bogus"):
        _port_grads(dataclasses.replace(CFG, remat_policy="bogus"))
    assert t_dit._ckpt_policy(dataclasses.replace(CFG, remat_policy="")) is None
    assert t_dit._ckpt_policy(dataclasses.replace(CFG, remat_policy="none")) is None
    assert t_dit._ckpt_policy(dataclasses.replace(CFG, remat_policy="save_seq")) is not None


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


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_save_seq_grads_match_jax(variant):
    """The DiT's parameter gradients of one loss, port under save_seq
    against the JAX package under save_seq (use_kernel = False: its reference
    scans and chunked attention), same weights, batch, sigma index and noise:
    each within 1e-4 of its tensor's largest gradient."""
    jcfg = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), ssm_layer=variant,
                               remat_policy="save_seq")
    model = CogVideoX(jcfg)
    vid, text, idx, noise = _inputs()
    v, t = jnp.asarray(vid.numpy()), jnp.asarray(text.numpy())
    bounds = (jnp.asarray([300], jnp.int32), jnp.asarray([301], jnp.int32))  # the sigma index drawn is 300
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), v, t, jax.random.PRNGKey(1), bounds), 5)
    key = jax.random.PRNGKey(3)
    k_noise = jax.random.split(key)[1]
    want_noise = np.asarray(jax.random.normal(k_noise, v.shape, jnp.float32))
    want = jax.jit(jax.grad(lambda p: model.apply(p, v, t, key, bounds).mean()))(params)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, want))

    port = convert.load_flax_params(TorchCogVideoX(dataclasses.replace(CFG, ssm_layer=variant,
                                                                       remat_policy="save_seq")),
                                    jax.tree.map(np.asarray, params)).train()
    loss = port(vid, text, (torch.tensor([300]), torch.tensor([301])), idx=idx,
                noise=torch.from_numpy(want_noise.copy())).mean()
    loss.backward()
    for name, p in port.named_parameters():
        w = want[name].numpy()
        err, scale = float(np.abs(p.grad.numpy() - w).max()), float(np.abs(w).max())
        assert err <= 1e-4 * scale, f"{name}: max error {err:.3g} > 1e-4 x max|want| {scale:.3g}"


def test_k7_casts_twelve_weights_a_layer_and_pass(monkeypatch):
    """Under scan_layers, one training forward casts each layer's 2-D weights
    through K7's function 12 times (adaLN x 2, attention q/k/v/o, MLP x 2,
    TTT wq/wk/wv/wo once for both directions); the recompute under the
    per-layer checkpoint casts them again (save_seq keeps no cast)."""
    n = {"casts": 0}
    plain = convert_ops.convert_f32_bf16_plain

    def counted(x):
        n["casts"] += 1
        return plain(x)

    monkeypatch.setattr(convert_ops, "convert_f32_bf16_plain", counted)
    cfg = dataclasses.replace(CFG, scan_layers=True, dtype="bfloat16", remat_policy="save_seq")
    model = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(0)).train()
    vid, text, idx, noise = _inputs()
    loss = model(vid, text, (torch.tensor([0]), torch.tensor([1000])), idx=idx, noise=noise).mean()
    assert n["casts"] == 12 * cfg.num_layers
    loss.backward()
    assert n["casts"] == 2 * 12 * cfg.num_layers
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())
