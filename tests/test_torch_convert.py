"""PyTorch port parity: the layer stack's weight cast (K7,
ttt_video_dit_torch/ops/convert.py) against the JAX package's opaque_convert
(the Pallas _convert_kernel in interpret mode) and jnp.astype; its use in the
port's ``Linear`` under ``scan_layers``; and convert.py's unstacking of a
``scan_layers`` flax tree.

The casts are compared bit for bit (uint16 views) on random values and on
ties, subnormals, signed zeros, +-inf, values past the bf16 maximum and NaN.
For NaN only NaN-ness is compared: the two CPU libraries emit different NaN
payloads for the same input (PyTorch 0xffff, XLA 0x7fc0), and the card's
bit-exact check is against PyTorch's own cast (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert as t_convert  # noqa: E402
from ttt_video_dit_torch.models.dit import dit as t_dit  # noqa: E402
from ttt_video_dit_torch.models.ttt.layer import Linear  # noqa: E402
from ttt_video_dit_torch.ops import convert as k7  # noqa: E402
from ttt_video_dit_tpu.models.dit import dit as j_dit  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import convert as j_convert  # noqa: E402

torch.set_num_threads(1)
SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan, 3.4e38, -3.39e38, 3.3961e38, 1e-40, -1e-45,
                    3.0e-39, 1.00390625, 1.01171875, -1.00390625, 1.0 + 2**-8 + 2**-20, 65504.0], np.float32)
TINY = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), ssm_layer="ttt_linear")


def _values(rng, shape):
    x = (rng.standard_normal(shape) * 10.0 ** rng.integers(-40, 38, shape)).astype(np.float32)
    x.reshape(-1)[: min(SPECIAL.size, x.size)] = SPECIAL[: x.size]
    return x


def _same_bits(got, want):
    got, want = np.asarray(got), np.asarray(want)
    nan = np.isnan(want.astype(np.float32))
    np.testing.assert_array_equal(np.isnan(got.astype(np.float32)), nan)
    np.testing.assert_array_equal(got.view(np.uint16)[~nan], want.view(np.uint16)[~nan])


@pytest.mark.parametrize("shape", [(64, 48), (24, 40), (2, 17)])
def test_k7_plain_matches_opaque_convert_bit_for_bit(monkeypatch, rng, shape):
    """convert_f32_bf16 (on CPU tensors: the plain version) against the Pallas
    kernel in interpret mode and against jnp.astype, bit for bit."""
    monkeypatch.setattr(j_convert, "_INTERPRET", True)
    x = _values(rng, shape)
    got = k7.convert_f32_bf16(torch.from_numpy(x)).view(torch.int16).numpy().view(np.uint16)
    pallas = j_convert.opaque_convert(jnp.asarray(x), jnp.bfloat16)
    assert "pallas_call" in str(jax.make_jaxpr(lambda v: j_convert.opaque_convert(v, jnp.bfloat16))(x))
    _same_bits(got.view(jnp.bfloat16), np.asarray(pallas))
    _same_bits(got.view(jnp.bfloat16), np.asarray(jnp.asarray(x).astype(jnp.bfloat16)))


def test_opaque_convert_function_backward_matches_jax(monkeypatch, rng):
    """OpaqueConvertFunction's backward casts the bf16 cotangent back to
    float32, as _opaque_bwd does: equal to jax.vjp through opaque_convert."""
    monkeypatch.setattr(j_convert, "_INTERPRET", True)
    x = rng.standard_normal((16, 24)).astype(np.float32)
    g = rng.standard_normal((16, 24)).astype(np.float32)
    gb = np.asarray(jnp.asarray(g).astype(jnp.bfloat16))
    _, vjp = jax.vjp(lambda v: j_convert.opaque_convert(v, jnp.bfloat16), jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(gb))[0])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = k7.OpaqueConvertFunction.apply(xt, False)
    y.backward(torch.from_numpy(g).bfloat16())
    assert y.dtype == torch.bfloat16 and xt.grad.dtype == torch.float32
    np.testing.assert_array_equal(xt.grad.numpy(), want)


def test_opaque_convert_casts_only_2d_float32_to_bf16():
    """Like the JAX pin's _eligible: a same-dtype tensor passes through, and
    other casts (1-D, float32 -> float16) are plain .to."""
    w = torch.randn(4, 3)
    assert k7.opaque_convert(w, torch.float32) is w
    assert k7.opaque_convert(w, torch.bfloat16).grad_fn is None  # no autograd graph for a leaf without grad
    w.requires_grad_(True)
    assert type(k7.opaque_convert(w, torch.bfloat16).grad_fn).__name__ == "OpaqueConvertFunctionBackward"
    assert type(k7.opaque_convert(w[0], torch.bfloat16).grad_fn).__name__ == "ToCopyBackward0"
    assert k7.opaque_convert(w, torch.float16).dtype == torch.float16


@pytest.mark.parametrize("case", ["meta", "float64", "non_contiguous"])
def test_convert_kernel_rejects_what_it_does_not_take(case):
    """A tensor that is neither on the CPU nor a contiguous float32 CUDA
    tensor makes the wrapper raise, never fall back."""
    x = {"meta": torch.zeros(8, 8, device="meta"), "float64": torch.zeros(8, 8, dtype=torch.float64, device="meta"),
         "non_contiguous": torch.zeros(8, 8, device="meta").t()}[case]
    with pytest.raises(ValueError):
        k7.convert_f32_bf16(x)


def _layer_linears(model, inside: bool):
    names = [n for n, m in model.named_modules() if isinstance(m, Linear) and n.startswith("layers.") == inside]
    return names, [m for n, m in model.named_modules() if n in names]


@pytest.mark.parametrize("scan_layers", [False, True])
def test_only_the_layer_stacks_linears_are_pinned(scan_layers):
    """With scan_layers, every Linear of DiffusionTransformer.layers (the 2-D
    Dense kernels the JAX pin covers: 12 a layer) casts through K7; the
    time embedding, text projection and final layer keep .to."""
    model = t_dit.DiffusionTransformer(dataclasses.replace(TINY, scan_layers=scan_layers))
    names, inner = _layer_linears(model, inside=True)
    _, outer = _layer_linears(model, inside=False)
    assert len(inner) == 12 * TINY.num_layers and len(outer) == 5
    assert all((m.pin is not None) == scan_layers for m in inner) and all(m.pin is None for m in outer)


def test_pinned_linear_matches_the_plain_cast(rng):
    """A pinned Linear on a bf16 input gives the unpinned Linear's output and
    float32 gradients (K7's plain version is .to(bf16); its backward casts the
    cotangent as .to's does), with the kernel path or the plain one."""
    x = torch.from_numpy(rng.standard_normal((3, 5, 32)).astype(np.float32)).bfloat16()
    ref = Linear(32, 24)
    outs = []
    for pin in (None, dataclasses.replace(TINY, use_kernel=True), dataclasses.replace(TINY, use_kernel=False)):
        lin = Linear(32, 24)
        lin.load_state_dict(ref.state_dict())
        lin.pin = pin
        y = lin(x)
        y.float().square().sum().backward()
        outs.append((y, lin.weight.grad, lin.bias.grad))
    for y, gw, gb in outs[1:]:
        assert torch.equal(y, outs[0][0]) and gw.dtype == torch.float32
        assert torch.equal(gw, outs[0][1]) and torch.equal(gb, outs[0][2])


def test_flax_to_state_dict_unstacks_scan_layers(rng):
    """A scan_layers tree (stack_layer_params of an unrolled DiT tree) gives
    the same state dict as the unrolled tree it came from."""
    L = 3
    layer = {"mlp": {"layer1": {"kernel": None, "bias": None}}, "seq_modeling_block": {"ssm": {"W1": None}}}
    shapes = {"kernel": (8, 16), "bias": (16,), "W1": (2, 4, 4)}
    fill = lambda t: {k: fill(v) if isinstance(v, dict) else rng.standard_normal(shapes[k]).astype(np.float32)
                      for k, v in t.items()}
    unrolled = {"time_embed_0": fill({"kernel": None, "bias": None}),
                **{f"layers_{i}": fill(layer) for i in range(L)}}
    stacked = jax.tree.map(np.asarray, j_dit.stack_layer_params(unrolled, L))
    assert "scan_layers" in stacked and not any(k.startswith("layers_") for k in stacked)
    want = t_convert.flax_to_state_dict({"params": {"dit": unrolled}})
    got = t_convert.flax_to_state_dict({"params": {"dit": stacked}})
    assert sorted(got) == sorted(want) and "dit.layers.2.mlp.layer1.weight" in got
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name].numpy())
