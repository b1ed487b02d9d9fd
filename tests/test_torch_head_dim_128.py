"""PyTorch port parity at head dim 128 (d3072 at 24 heads, --model.num_heads
24 on the 5B preset): the plain versions of the two sampling kernels the
port has at that width (K3, csrc/attention_forward_f128.cu; K5,
csrc/ttt_linear_forward_f128.cu), a TTT-linear DiT's sampling eval, and the
wrappers' argument checks, against the JAX package on the CPU.

- ``attention_plain`` against the JAX ``attention`` (its _direct path at a
  window of up to 4,096 tokens, _chunked above, at a ragged length), in
  float32 (|d| <= 1e-5 max|jax|: summation order) and on bf16 inputs (within
  one bf16 rounding of the output, 1e-2 absolute and relative).
- ``ttt_linear_forward_plain`` at F = 128, CS 16 against the Pallas K5
  (_linear_kernel, interpret mode) in its fused-preproc, token-major,
  in-kernel-gate form, as tests/test_torch_ttt_linear.py runs it: float32
  (2e-5 absolute and relative), bf16 q/k/v (1e-2 absolute and relative, at
  least 99.9 % of the outputs bit-equal) and bf16 at 1,000x the 3 s slice's
  eta (1e-2 absolute and relative), where the output must move at least 10
  tolerances from eta = 0's.
- A DiT at d256, 2 heads (F = 128), 2 layers, TTT-linear, CS 16, 37 frames in
  3 scenes: one sampling eval (CogVideoX.denoise, CFG batch 2), the JAX
  package's parameters carried by convert.flax_to_state_dict, against the
  flax model's on the same numpy latents and text, float32: |d| <= 1e-5
  max|flax| + 1e-5 |flax|, as tests/test_torch_linear_model.py holds d128.
- On CPU tensors the wrappers' shape checks take F = 128 at CS 16 for
  every attention and TTT-linear kernel, sampling and training (only the
  device check is left to fail), and raise ValueError naming what the
  kernels take for TTT-MLP at F = 128, for another CS at F = 128 and for
  float32 at F = 128, sampling and training.
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
from ttt_video_dit_torch.ops import attention, ttt_linear_kernel as tk, ttt_mlp_kernel  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.ops import attention as j_attention  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_forward  # noqa: E402

torch.set_num_threads(1)
f32 = np.float32
F = 128


# ------------------------------------------------------------ K3's plain version


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 1000, 2, F), (1, 4133, 1, F)], ids=["direct", "chunked"])
def test_attention_plain_matches_jax_at_head_dim_128(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    q, k, v = (rng.standard_normal(shape).astype(f32) * 2 for _ in range(3))
    assert (shape[1] > j_attention._CHUNK_THRESHOLD) == (shape[1] == 4133)
    if dtype == "bfloat16":  # the same bf16 values on both sides
        q, k, v = (np.array(jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    want = np.asarray(j_attention.attention(*(jnp.asarray(x) for x in (q, k, v))))
    T = lambda x: torch.from_numpy(x).to(getattr(torch, dtype))
    got = attention.attention_plain(T(q), T(k), T(v)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)


# ------------------------------------------------------------ K5's plain version


def _args(rng, B, H, NC, CS=16):
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


def _jax_out(a, scale, dtype):
    """The Pallas K5 (_linear_kernel, interpret mode), token-major with fused preprocessing: its output."""
    B = a["XQ"].shape[0]
    tile = lambda p: jnp.broadcast_to(jnp.asarray(p)[None], (B,) + p.shape)
    out = ttt_forward.ttt_linear_forward(
        *(jnp.asarray(a[k]).astype(dtype) for k in ("XQ", "XK", "XV")),
        *(jnp.asarray(a[k]) for k in ("gate", "ln_w", "ln_b")), tile(a["W1"]), tile(a["b1"]), 4, interpret=True,
        rope_cos=jnp.asarray(a["rope_cos"]), rope_sin=jnp.asarray(a["rope_sin"]), eta_scale=scale, token_major=True,
    )[0]
    return np.asarray(out.astype(jnp.float32))


ETA = 1.0 / F / 16  # the 3 s TTT-linear TOMLs' ttt_base_lr 1.0 / F / CS


@pytest.mark.parametrize("case", ["float32", "bfloat16", "bfloat16_large_eta"])
def test_k5_plain_matches_pallas_at_head_dim_128(rng, case):
    B, H, NC = 2, 2, 3
    a = _args(rng, B, H, NC)
    scale = ETA * (1000 if case.endswith("large_eta") else 1)
    dt, jdt = (torch.float32, jnp.float32) if case == "float32" else (torch.bfloat16, jnp.bfloat16)
    got = tk.ttt_linear_forward_plain(**_torch(a, dt), eta_scale=scale).float().numpy()
    want = _jax_out(a, scale, jdt)
    assert got.shape == want.shape == (B, NC, 16, H * F)
    if case == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
        return
    np.testing.assert_allclose(got, want, rtol=1e-2, atol=1e-2)
    if case == "bfloat16":  # at the large eta the larger updates carry more rounding flips (as at F = 64)
        assert np.mean(got == want) >= 0.999
    else:  # the carried state moves the output far past the tolerance
        still = tk.ttt_linear_forward_plain(**_torch(a, dt), eta_scale=0.0).float().numpy()
        assert (np.abs(got - still) / (1e-2 + 1e-2 * np.abs(still))).max() >= 10


# ------------------------------------------------------------ the slice: a sampling eval


CFG = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), ssm_layer="ttt_linear", model_dim=256,
                          num_heads=2, mini_batch_size=16)
TEXT_LEN, LAT, FRAMES, SCENES = 16, 8, 37, 3


def _random_params(init_fn, seed):
    """Random float32 weights of the flax tree's shapes (tests/test_torch_linear_model.py's draw)."""
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = path[-1].key
        noise = rng.standard_normal(s.shape).astype(f32)
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


def test_dit_sampling_eval_at_head_dim_128_matches_jax(rng):
    assert CFG.head_dim == F and CFG.num_layers == 2
    model = CogVideoX(CFG)
    vid0 = jnp.zeros((1, FRAMES, CFG.in_channels, LAT, LAT), jnp.float32)
    text0 = jnp.zeros((1, SCENES, TEXT_LEN, CFG.text_dim), jnp.float32)
    bounds = (jnp.zeros((1,), jnp.int32), jnp.full((1,), CFG.sigma_interval, jnp.int32))
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid0, text0, jax.random.PRNGKey(1), bounds), 5)
    state = convert.flax_to_state_dict(jax.tree.map(np.asarray, params))
    ssm = "dit.layers.1.seq_modeling_block.ssm."
    assert state[ssm + "W1"].shape == (2, F, F) and state[ssm + "ttt_norm_weight"].shape == (2, F)
    port = TorchCogVideoX(dataclasses.replace(CFG, use_kernel=True)).eval()
    port.load_state_dict(state, strict=True)

    vid = rng.standard_normal((2, FRAMES, CFG.in_channels, LAT, LAT)).astype(f32)
    text = rng.standard_normal((2, SCENES, TEXT_LEN, CFG.text_dim)).astype(f32)
    a, t = np.array([0.3, 0.9], f32), np.array([700.0, 40.0], f32)
    want = np.asarray(jax.jit(lambda p, *args: model.apply(p, *args, method="denoise"))(
        params, *(jnp.asarray(x) for x in (vid, a, text, t))))
    with torch.inference_mode():
        got = port.denoise(*(torch.from_numpy(x) for x in (vid, a, text, t))).numpy()
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# ------------------------------------------------------------ the wrappers' argument checks


def _k5(F_=F, CS=16, dtype=torch.bfloat16):
    B, H, NC = 1, 2, 3
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt)
    return [z(B, NC, CS, H * F_, dt=dtype), z(B, NC, CS, H * F_, dt=dtype), z(B, NC, CS, H * F_, dt=dtype),
            z(B, H, NC, CS), z(NC, CS, F_), z(NC, CS, F_), z(H, F_), z(H, F_), z(H, F_, F_), z(H, 1, F_)]


ON_CPU = "expected a tensor on cpu"  # the device check: what is left to fail on CPU tensors once the shape passes
TAKES = r"\{64: \(8, 16, 24, 32, 40, 48, 56, 64\), 128: \(16,\)\}"


@pytest.mark.parametrize("case", ["attention", "attention_with_lse", "attention_backward", "ttt_linear_forward",
                                  "ttt_linear_forward_train", "ttt_linear_backward", "ttt_linear_cs32",
                                  "ttt_linear_float32", "ttt_mlp", "ttt_linear_cs32_train",
                                  "ttt_linear_float32_train", "ttt_mlp_train"])
def test_head_dim_128_argument_checks(case):
    """The launch paths' checks, run on CPU (or meta) tensors, where the wrappers themselves take the plain
    versions: every TTT-linear and attention kernel takes F = 128 (at CS 16, bf16), so only the device check is
    left to fail; another CS, float32 and TTT-MLP raise ValueError naming what the kernels take."""
    q = torch.zeros(2, 33, 3, F, dtype=torch.bfloat16)
    mlp_takes = r"F=64 and CS in \(8, 16, 24, 32, 40, 48, 56, 64\); got F=128"
    if case == "attention":  # attention() on the card: K3@F128
        with pytest.raises(ValueError, match="CUDA"):
            attention._forward(q, q, q, with_lse=False)
    elif case == "attention_with_lse":  # K3-lse@F128
        with pytest.raises(ValueError, match="CUDA"):
            attention._forward(q, q, q, with_lse=True)
    elif case == "attention_backward":  # K4@F128
        m = q.to("meta")
        with pytest.raises(ValueError, match="expected a tensor on meta \\(CUDA\\)"):
            attention.attention_backward(m, m, m, m, torch.zeros(2, 3, 33, device="meta"), m)
    elif case == "ttt_linear_forward":  # ttt_linear_forward on the card: K5@F128
        with pytest.raises(ValueError, match=ON_CPU):
            tk._forward(*_k5(), 1e-3, 0)
    elif case == "ttt_linear_forward_train":  # K5-train@F128
        with pytest.raises(ValueError, match=ON_CPU):
            tk._forward(*_k5(), 1e-3, 2)
    elif case == "ttt_linear_backward":  # K6@F128's checks (the backward passes W1/b1 as None)
        with pytest.raises(ValueError, match=ON_CPU):
            tk.check_kernel_args(*_k5()[:8], None, None)
    elif case in ("ttt_linear_cs32", "ttt_linear_cs32_train"):
        with pytest.raises(ValueError, match=TAKES + r"; got F=128, CS=32"):
            tk._forward(*_k5(CS=32), 1e-3, 2 if case.endswith("train") else 0)
    elif case in ("ttt_linear_float32", "ttt_linear_float32_train"):
        with pytest.raises(ValueError, match="takes bfloat16"):
            tk._forward(*_k5(dtype=torch.float32), 1e-3, 2 if case.endswith("train") else 0)
    else:
        a = _k5()
        H = a[6].shape[0]
        mlp = a[:8] + [torch.zeros(H, F, 4 * F), torch.zeros(H, 1, 4 * F), torch.zeros(H, 4 * F, F),
                       torch.zeros(H, 1, F)]
        with pytest.raises(ValueError, match=mlp_takes):
            ttt_mlp_kernel.check_kernel_args(*mlp)
        if case == "ttt_mlp_train":  # K2's checks (from checkpoints: no initial state)
            with pytest.raises(ValueError, match=mlp_takes):
                ttt_mlp_kernel.check_kernel_args(*mlp[:8], None, None, None, None)
    # The model's route sends a scan at F = 128 to the kernels (the JAX package's shape test passes it).
    assert not tk.use_plain(True, 16, F, torch.device("cpu")) and not attention.routes_to_plain(torch.bfloat16)
