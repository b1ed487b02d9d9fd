"""PyTorch port parity for training at head dim 128 (d3072 at 24 heads,
--model.num_heads 24 on the 5B preset): the plain versions of the four
training kernels at that width (K3-lse and K4, csrc/attention_forward_f128.cu
and attention_backward_f128.cu; K5-train and K6, csrc/ttt_linear_forward_f128.cu
and ttt_linear_backward_f128.cu), the kernels' argument checks, chip_smoke.py's
group-by-group check at that width, and one training step of a TTT-linear DiT
at F = 128, against the JAX package on the CPU.

- ``ttt_linear_forward_plain(checkpoint_group=K)`` at F = 128, CS 16 against
  the Pallas K5 (_linear_kernel, interpret mode) in its fused-preproc,
  token-major, in-kernel-gate form: output and both checkpoints, float32 at
  2e-5 absolute and relative; bf16 q/k/v, the output at 1e-2 absolute and
  relative, the fp32 checkpoints within 1e-3 of their scale (bf16 rounding
  flips of XQ XK^T, Gs and W from float32 summation order, carried into the
  state: 1.1e-4 of its scale measured at F = 128, where F = 64 stays under
  1e-4); a ragged last group (NC 5, K 2) in both.
- ``ttt_linear_backward_plain``'s eight gradients against the Pallas K6
  (_linear_bwd_kernel, interpret mode) from the same checkpoints, as
  tests/test_torch_ttt_linear.py holds them at F = 16 and 64: float32 within
  1e-4 of each gradient's scale, bf16 within 2e-2.
- K3-lse's plain log-sum-exp at F = 128 against a float64 numpy logsumexp of
  the same scores: 1e-5 absolute (float32 sums of values up to ~10).
- chip_smoke.py's phase-24 check of K5-train@F128 and K6@F128 (check_scan_by_group)
  on a tiny F = 128 scan on the CPU, the plain versions standing in for the
  kernels: passes them, and fails a scan whose second checkpoint group's
  output or dXK is off, naming the group; read_counts names the four new
  rows.
- One training step (text dropout, sigma and noise draws from the JAX step)
  of a d256, 2-head (F = 128), 2-layer TTT-linear DiT at CS 16, K 3 (NC 4:
  the last group one mini-batch), adapter qkvo, the JAX package's parameters
  carried by convert.flax_to_state_dict, against the flax model's jitted
  make_train_step: tests/test_torch_linear_train.py's tolerances (loss rtol
  1e-5, grad norm rtol 1e-4, every updated parameter within 2 % of its
  group's peak learning rate + 1e-4 |p|, the key LayerNorm's bias 2x).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from test_torch_linear_train import OPT, _jax_draws, _random_params, _t  # noqa: E402
from ttt_video_dit_torch import convert  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.ops import attention  # noqa: E402
from ttt_video_dit_torch.ops import ttt_linear_kernel as tk  # noqa: E402
from ttt_video_dit_torch.training import optimizer as t_opt  # noqa: E402
from ttt_video_dit_torch.training.train_step import train_step  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_backward, ttt_forward  # noqa: E402
from ttt_video_dit_tpu.training import optimizer as j_opt  # noqa: E402
from ttt_video_dit_tpu.training import setup as j_setup  # noqa: E402
from ttt_video_dit_tpu.training.train_step import make_train_step  # noqa: E402

torch.set_num_threads(1)
f32 = np.float32
F, CS = 128, 16
IN = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")
ETA = 1.0 / F / CS  # the 3 s TTT-linear train TOML's ttt_base_lr 1.0 / F / CS


def _args(rng, B, H, NC):
    """Raw token-major q/k/v, gate logits, interleaved rope tables, LN affine, initial state (numpy float32)."""
    x = lambda: rng.standard_normal((B, NC, CS, H * F)).astype(f32)
    ang = rng.uniform(0, 6.3, (NC, CS, F // 2)).astype(f32)
    n = lambda *s, std=0.02: (std * rng.standard_normal(s)).astype(f32)
    return dict(XQ=x(), XK=x(), XV=x(), gate=rng.standard_normal((B, H, NC, CS)).astype(f32),
                rope_cos=np.repeat(np.cos(ang), 2, -1), rope_sin=np.repeat(np.sin(ang), 2, -1),
                ln_w=(1 + n(H, F, std=0.1)).astype(f32), ln_b=n(H, F, std=0.1), W1=n(H, F, F), b1=n(H, 1, F))


def _torch(a, dtype=torch.float32):
    out = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in a.items()}
    for k in ("XQ", "XK", "XV"):
        out[k] = out[k].to(dtype)
    return out


def _jax_forward(a, K, dtype):
    """Pallas K5 (interpret): (out, W1_ck, b1_ck), the bias checkpoints as the JAX kernel keeps them (8 rows)."""
    B = a["XQ"].shape[0]
    tile = lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (B,) + p.shape)
    return ttt_forward.ttt_linear_forward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")), tile(a["W1"]), tile(a["b1"]), K, interpret=True,
        rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=ETA, token_major=True,
    )


def _jax_backward(a, ckpts, dout, K, dtype):
    """Pallas K6 (interpret), reduced as ttt_vjp.py:_linear_bwd_pre and summed over the batch."""
    outs = ttt_backward.ttt_linear_backward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")), *ckpts, jnp.asarray(dout).astype(dtype), K,
        interpret=True, rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=ETA,
        token_major=True,
    )
    dXQ, dXK, dXV, de, dW1, db1, dlnw, dlnb = (np.asarray(o.astype(jnp.float32)) for o in outs)
    return dXQ, dXK, dXV, de, dW1.sum(0), db1[:, :, 0:1].sum(0), dlnw.sum(axis=(0, 2)), dlnb.sum(axis=(0, 2))


def _port_ckpts(jax_ckpts):
    """The JAX checkpoints as the port's compact ones (the 8 bias rows x 0.125 summed)."""
    w1, b1 = (np.array(c, f32) for c in jax_ckpts)
    return [torch.from_numpy(w1), torch.from_numpy(b1.sum(-2, keepdims=True))]


def _close_scaled(got, want, tol):
    """|got - want| <= tol * max|want| elementwise (gradients span orders of magnitude)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    err, scale = float(np.abs(got - want).max()), max(float(np.abs(want).max()), 1e-30)
    assert err <= tol * scale, f"max error {err:.3g} > {tol} x max|want| {scale:.3g}"


# ------------------------------------------------------------ K5-train and K6


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("NC,K", [(4, 2), (5, 2)], ids=["full", "ragged"])
def test_k5_train_plain_matches_pallas_at_head_dim_128(rng, NC, K, dtype):
    B, H = 1, 2
    a = _args(rng, B, H, NC)
    dt, jdt = (torch.float32, jnp.float32) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16)
    got = tk.ttt_linear_forward_plain(**_torch(a, dt), eta_scale=ETA, checkpoint_group=K)
    want = _jax_forward(a, K, jdt)
    out, ref = got[0].float().numpy(), np.asarray(want[0].astype(jnp.float32))
    ckpts = _port_ckpts(want[1:])
    assert out.shape == (B, NC, CS, H * F) and [tuple(c.shape) for c in got[1:]] == [
        (B, H, -(-NC // K), F, F), (B, H, -(-NC // K), 1, F)]
    if dtype == "float32":
        np.testing.assert_allclose(out, ref, rtol=2e-5, atol=2e-5)
        for g, w in zip(got[1:], ckpts):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-5, atol=2e-5)
    else:
        np.testing.assert_allclose(out, ref, rtol=1e-2, atol=1e-2)
        for g, w in zip(got[1:], ckpts):
            _close_scaled(g.numpy(), w.numpy(), 1e-3)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k6_plain_matches_pallas_at_head_dim_128(rng, dtype):
    """From the Pallas forward's checkpoints, NC 5 at K 2 (a last group of one step)."""
    B, H, NC, K = 1, 2, 5, 2
    a = _args(rng, B, H, NC)
    dt, jdt, tol = (torch.float32, jnp.float32, 1e-4) if dtype == "float32" else (torch.bfloat16, jnp.bfloat16, 2e-2)
    jck = _jax_forward(a, K, jdt)[1:]
    dout = rng.standard_normal(a["XQ"].shape).astype(f32)
    t = _torch(a, dt)
    got = tk.ttt_linear_backward_plain(*(t[k] for k in IN), *_port_ckpts(jck), torch.from_numpy(dout).to(dt),
                                       ETA, K)
    want = _jax_backward(a, jck, dout, K, jdt)
    for g, w in zip(got, want):
        _close_scaled(g.float().numpy(), w, tol)


# ------------------------------------------------------------ chip_smoke.py's phase-24 checks


@pytest.mark.parametrize("corrupt", ["none", "output", "dXK"])
def test_chip_smoke_checks_the_head_dim_128_scan_by_group(monkeypatch, corrupt):
    import chip_smoke

    monkeypatch.setattr(chip_smoke, "timed", lambda fn: (fn(), 0.0))  # CUDA events need a card
    gen = torch.Generator().manual_seed(0)
    a = chip_smoke._ttt_inputs(1, 2, 9, gen, torch.device("cpu"), CS=CS, variant="ttt_linear", F=F)
    dout = torch.randn(*a["XQ"].shape, generator=gen).bfloat16()
    K, off = 4, slice(4, 8)  # the second of 3 groups (the last of one mini-batch)

    def fwd(**kw):
        out, *ck = tk.ttt_linear_forward_plain(**kw)
        if corrupt == "output":
            out = out.clone()
            out[:, off] *= 1.5
        return (out, *ck)

    def bwd(*args):
        grads = list(tk.ttt_linear_backward_plain(*args))
        if corrupt == "dXK":
            grads[1] = grads[1].clone()
            grads[1][:, off] *= 1.5
        return tuple(grads)

    if corrupt == "none":
        r = chip_smoke.check_scan_by_group("ttt_linear", a, K, ETA, dout, kernels=(fwd, bwd))
        assert r["err"] == 0 and r["gerr"] == 0 and r["ck"][0].shape == (1, 2, 3, F, F)
    else:
        with pytest.raises(AssertionError, match="ttt_linear_.*@F128 .*group 1"):
            chip_smoke.check_scan_by_group("ttt_linear", a, K, ETA, dout, kernels=(fwd, bwd))
    rows = set(chip_smoke.read_counts())
    assert {"attention_forward_lse@F128", "attention_backward@F128", "ttt_linear_forward_train@F128",
            "ttt_linear_backward@F128"} <= rows


# ------------------------------------------------------------ K3-lse


def test_attention_plain_lse_matches_logsumexp_at_head_dim_128(rng):
    """Two windows of 300 tokens (two 256-row blocks of the plain version), bf16 inputs as on the card."""
    shape = (2, 300, 2, F)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape).astype(f32)).bfloat16() for _ in range(3))
    out, lse = attention.attention_plain(q, k, v, return_lse=True)
    qn, kn = (x.double().numpy() for x in (q, k))
    s = np.einsum("bqhf,bkhf->bhqk", qn, kn) / np.sqrt(F)
    m = s.max(-1, keepdims=True)
    want = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    assert lse.shape == (2, 2, 300) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    assert out.shape == shape and out.dtype == torch.bfloat16


# ------------------------------------------------------------ the slice: one training step


CFG = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), ssm_layer="ttt_linear", model_dim=256,
                          num_heads=2, mini_batch_size=16, scan_checkpoint_group_size=3)
FRAMES, SCENES, TEXT_LEN, LAT = 37, 3, 9, 2  # 3 * 9 + 37 * 1 = 64 tokens: NC 4 at CS 16, groups of 3 and 1


def test_train_step_at_head_dim_128_matches_jax(rng):
    assert CFG.head_dim == F and CFG.num_layers == 2
    model = CogVideoX(CFG)
    vid0 = jnp.zeros((1, FRAMES, CFG.in_channels, LAT, LAT), jnp.float32)
    text0 = jnp.zeros((1, SCENES, TEXT_LEN, CFG.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), CFG.sigma_interval, jnp.int32))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid0, text0, jax.random.PRNGKey(1), bounds), 5)
    state_dict = convert.flax_to_state_dict(jax.tree.map(np.asarray, params))
    assert state_dict["dit.layers.1.seq_modeling_block.ssm.W1"].shape == (2, F, F)
    port = TorchCogVideoX(dataclasses.replace(CFG, use_kernel=True)).train()  # the wrappers: plain on CPU tensors
    port.load_state_dict(state_dict, strict=True)

    trainable, _ = j_opt.partition_params(params, "qkvo")
    tx, _, _ = j_opt.build_optimizer(trainable, **OPT)
    state = j_setup.create_train_state(params, tx, "qkvo")
    step_fn = jax.jit(make_train_step(model, tx, text_dropout_prob=0.5))
    opt = t_opt.build_optimizer(port, **OPT, adapter_method="qkvo")
    frozen = {n: p.detach().clone() for n, p in port.named_parameters() if not p.requires_grad}
    b = dict(vid=rng.standard_normal((2, FRAMES, CFG.in_channels, LAT, LAT)).astype(f32),
             text=rng.standard_normal((2, SCENES, TEXT_LEN, CFG.text_dim)).astype(f32),
             sigma_lo=np.array([0, 500], np.int32), sigma_hi=np.array([500, 1000], np.int32))
    key = jax.random.PRNGKey(42)
    state, metrics = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()}, key)
    d = _jax_draws(jax.random.fold_in(key, 0), b["vid"].shape, b["sigma_lo"], b["sigma_hi"], 0.5)
    got = train_step(port, opt, _t(b), text_dropout_prob=0.5, draws=[_t(d)])
    np.testing.assert_allclose(float(got["loss"]), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(got["grad_norm"]), float(metrics["grad_norm"]), rtol=1e-4)
    want = convert.flax_to_state_dict(jax.tree.map(np.asarray, j_opt.merge_params(state.trainable, state.frozen)))
    assert frozen
    for name, p in port.named_parameters():
        if name in frozen:
            assert torch.equal(p.detach(), frozen[name]), name
        lr = OPT["lr_ssm"] if t_opt.is_ttt_parameter(t_opt.flax_path(name)) else OPT["lr"]
        share = 2.0 if name.endswith("attention.k_norm.bias") else 0.02
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(), rtol=1e-4, atol=share * lr, err_msg=name)
