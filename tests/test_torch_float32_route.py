"""Where the port sends a TTT scan or an attention call on the card, held to
where the JAX package sends it, and what the kernel wrappers take at float32:

- the TTT route (ops/ttt_mlp_kernel.py:routes_to_plain, the same in
  ops/ttt_linear_kernel.py) equals ``not is_supported`` of the JAX package's
  TTT-MLP and TTT-linear dispatch over CS 4-72 and F 32, 60, 64, 72, run with
  ``_FORCE_INTERPRET`` set (and restored) so that its platform test passes;
- the attention route (ops/attention.py:routes_to_plain) sends exactly the
  dtypes other than bf16 to the plain versions; the JAX package's
  ``attention`` on a TPU (its platform patched) sends every non-bf16 call to
  XLA and bf16 above 4,096 tokens to its splash kernel (bf16 up to 4,096 to
  XLA's _direct, the same function the port's kernel computes there);
- ``use_plain`` counts a route to the plain versions on a CUDA device only,
  and never with ``use_kernel`` off; the model's layers follow the routes
  (the TTT layer at CS 10 and 8, attention at float32 and bf16);
- the wrappers' argument checks take bf16 and float32 q/k/v (the meta
  tensors then fail only the device check), refuse float16 and mixed
  dtypes, and still refuse F 72 and CS 72 at either dtype, naming the
  mini-batches the kernels take;
- the float32 kernels' sources dispatch on the mini-batches the wrappers
  name (csrc/ttt_f32.cuh:takes_mini_batch, called by every float32 entry).
"""

import dataclasses
import pathlib
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch.config.model_config import ModelConfig as TorchModelConfig  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.models.dit.dit import init_params_  # noqa: E402
from ttt_video_dit_torch.ops import _build, attention, ttt_linear_kernel, ttt_mlp_kernel  # noqa: E402
from ttt_video_dit_tpu.ops import attention as jax_attention  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_linear_kernel as jax_linear  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_mlp_kernel as jax_mlp  # noqa: E402

torch.set_num_threads(1)
CUDA = torch.device("cuda")  # a device object only: nothing here runs on a card
EVERY = r"\(8, 16, 24, 32, 40, 48, 56, 64\)"


@pytest.mark.parametrize("variant", ["ttt_mlp", "ttt_linear"])
@pytest.mark.parametrize("F", [32, 60, 64, 72])
def test_ttt_route_is_the_jax_shape_test(monkeypatch, variant, F):
    jax_mod, mod = (jax_mlp, ttt_mlp_kernel) if variant == "ttt_mlp" else (jax_linear, ttt_linear_kernel)
    monkeypatch.setattr(jax_mod, "_FORCE_INTERPRET", True)
    for CS in range(4, 73):
        assert mod.routes_to_plain(CS, F) == (not jax_mod.is_supported((2, 3, 5, CS, F))), (CS, F)
    monkeypatch.undo()
    assert jax_mod._FORCE_INTERPRET is False


@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16", "float64"])
def test_attention_route_is_the_jax_dispatch(monkeypatch, dtype):
    """The JAX package on a TPU: which of _direct, _chunked and the splash kernel each (dtype, S) reaches; the
    port's route is the plain versions exactly where XLA computes a non-bf16 call."""
    taken = []
    for fn in ("_direct", "_chunked", "_splash_dispatch"):
        monkeypatch.setattr(jax_attention, fn, lambda q, k, v, _fn=fn, **kw: taken.append(_fn) or q)
    monkeypatch.setattr(jax_attention, "target_platform", lambda: "tpu")
    for S in (64, 4096, 4097, 18048):
        q = jnp.zeros((1, S, 1, 64), getattr(jnp, dtype))
        jax_attention.attention(q, q, q)
        jax_kernel = taken.pop() == "_splash_dispatch"
        assert jax_kernel == (dtype == "bfloat16" and S > jax_attention._CHUNK_THRESHOLD), (dtype, S)
        assert attention.routes_to_plain(getattr(torch, dtype)) == (dtype != "bfloat16")
        if attention.routes_to_plain(getattr(torch, dtype)):
            assert not jax_kernel  # the port's plain routes: calls XLA computes in the JAX package


def test_use_plain_counts_the_card_routes_only():
    for mod, args in ((ttt_mlp_kernel, (10, 64)), (ttt_linear_kernel, (10, 64)), (attention, (torch.float32,))):
        before = mod.plain_routes
        assert mod.use_plain(True, *args, torch.device("cpu")) and mod.plain_routes == before
        assert mod.use_plain(False, *args, CUDA) and mod.plain_routes == before
        assert mod.use_plain(True, *args, CUDA) and mod.plain_routes == before + 1
    for mod, args in ((ttt_mlp_kernel, (8, 64)), (ttt_linear_kernel, (64, 64)), (attention, (torch.bfloat16,))):
        before = mod.plain_routes
        assert not mod.use_plain(True, *args, CUDA) and mod.plain_routes == before
        assert mod.use_plain(False, *args, CUDA) and mod.plain_routes == before


def _spy(monkeypatch, module, names):
    calls = {n: 0 for n in names}
    for n in names:
        fn = getattr(module, n)

        def spy(*a, _n=n, _fn=fn, **kw):
            calls[_n] += 1
            return _fn(*a, **kw)

        monkeypatch.setattr(module, n, spy)
    return calls


@pytest.mark.parametrize("ssm_layer", ["ttt_mlp", "ttt_linear"])
@pytest.mark.parametrize("CS,dtype", [(8, "float32"), (10, "float32"), (8, "bfloat16"), (10, "bfloat16")])
def test_the_model_follows_the_routes(monkeypatch, ssm_layer, CS, dtype):
    """A sampling DiT forward of the tiny config (use_kernel): the TTT scans reach the kernel wrapper at CS 8 and
    only the plain version at CS 10, whatever the dtype; attention reaches its kernel wrapper in bf16 and only the
    plain version in float32 (on CPU tensors a wrapper runs the plain version itself)."""
    cfg = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), mini_batch_size=CS, ssm_layer=ssm_layer,
                              num_layers=1)
    port = TorchCogVideoX(TorchModelConfig(**{**dataclasses.asdict(cfg), "use_kernel": True, "dtype": dtype}))
    init_params_(port, torch.Generator().manual_seed(0))
    ttt = _spy(monkeypatch, ttt_mlp_kernel if ssm_layer == "ttt_mlp" else ttt_linear_kernel,
               (f"{ssm_layer}_forward", f"{ssm_layer}_forward_plain"))
    att = _spy(monkeypatch, attention, ("attention", "attention_plain"))
    rng = np.random.default_rng(0)
    vid = torch.from_numpy(rng.standard_normal((1, 37, cfg.in_channels, 8, 8)).astype(np.float32))
    text = torch.from_numpy(rng.standard_normal((1, 3, 16, cfg.text_dim)).astype(np.float32))
    with torch.inference_mode():
        out = port.dit(vid.to(getattr(torch, dtype)), text, torch.tensor([500.0]))
    assert torch.isfinite(out.float()).all()
    assert (ttt[f"{ssm_layer}_forward"], ttt[f"{ssm_layer}_forward_plain"]) == ((0, 2) if CS % 8 else (2, 2))
    assert (att["attention"], att["attention_plain"]) == ((0, 1) if dtype == "float32" else (1, 1))


def _mlp_args(F=64, CS=16, dtypes=(torch.bfloat16,) * 3):
    B, H, NC = 1, 2, 3
    z = lambda *s, dt=torch.float32: torch.zeros(*s, dtype=dt, device="meta")
    return [*(z(B, NC, CS, H * F, dt=dt) for dt in dtypes), z(B, H, NC, CS), z(NC, CS, F), z(NC, CS, F), z(H, F),
            z(H, F), z(H, F, 4 * F), z(H, 1, 4 * F), z(H, 4 * F, F), z(H, 1, F)]


@pytest.mark.parametrize("variant", ["ttt_mlp", "ttt_linear"])
@pytest.mark.parametrize("case", ["bfloat16", "float32", "float16", "mixed", "head_dim_72", "mini_batch_72"])
def test_argument_checks_take_bfloat16_and_float32(variant, case):
    mod = ttt_mlp_kernel if variant == "ttt_mlp" else ttt_linear_kernel
    f32, bf16 = torch.float32, torch.bfloat16
    dtypes = {"float32": (f32,) * 3, "float16": (torch.float16,) * 3, "mixed": (f32, f32, bf16)}.get(case, (bf16,) * 3)
    for dt in ((bf16,) * 3, (f32,) * 3) if case.endswith("_72") else (dtypes,):
        args = _mlp_args(F=72 if case == "head_dim_72" else 64, CS=72 if case == "mini_batch_72" else 16, dtypes=dt)
        if variant == "ttt_linear":  # W1 [H, F, F], b1 [H, 1, F]
            F = args[6].shape[1]
            args = args[:8] + [args[8][..., :F], args[9][..., :F]]
        if case in ("bfloat16", "float32"):
            match = "expected a tensor on meta"  # the dtype taken: only the device check fails
        elif case in ("float16", "mixed"):
            match = "all bfloat16 or all float32"
        else:
            match = EVERY
        with pytest.raises(ValueError, match=match):
            mod.check_kernel_args(*args)
        with pytest.raises(ValueError, match=match):
            getattr(mod, f"{variant}_forward")(*args, eta_scale=1e-3)


def _cases(text: str, function: str) -> tuple:
    body = text[text.index(f" {function}("):]
    body = body[: body.index("\n}\n")]
    return tuple(int(c) for c in re.findall(r"case (\d+):", body))


def test_float32_sources_dispatch_on_the_kernel_mini_batches():
    csrc = pathlib.Path(_build.CSRC_DIR)
    assert _cases((csrc / "ttt_f32.cuh").read_text(), "takes_mini_batch") == ttt_mlp_kernel.KERNEL_MINI_BATCHES
    assert ttt_linear_kernel.KERNEL_MINI_BATCHES == ttt_mlp_kernel.KERNEL_MINI_BATCHES
    names = {*ttt_mlp_kernel.F32_LIBS, *ttt_linear_kernel.F32_LIBS}
    assert names == {p.stem for p in csrc.glob("*_f32.cu")}
    for name in names:
        text = (csrc / f"{name}.cu").read_text()
        entry = text[text.index(f'extern "C" int {name}('):]
        assert "if (!takes_mini_batch(CS)" in entry[: entry.index("\n}\n")], name
        smem = text[text.index(f"{name}_smem_bytes(int cs)"):]
        assert "takes_mini_batch(cs)" in smem[: smem.index("\n}\n")], name
