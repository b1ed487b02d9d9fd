"""models/recompute.py in the PyTorch port: where a transformer layer
recomputes (``recompute.binds``), its LayerNorms, GELU, q/k norm-rope and
TTT LR gate keep only their inputs and run again in the backward. On the CPU
at the tiny flagship config (d128, 8 heads, 2 layers, float32):

- the DiT's output and every gradient with the recompute bit-equal to
  those without it, and fewer bytes saved for the backward;
- the gradient of the video input with the recompute against the JAX DiT's
  (|port - flax| <= 1e-5 * max|flax| + 1e-5 * |flax|, as tests/test_torch_model.py);
- ``binds`` is off for a tensor on the CPU, and outside ``when(True)`` a
  function runs as it is.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import __graft_entry__  # noqa: E402
from tests.test_torch_model import GEOMETRIES, LAT, TEXT_LEN, _close, _port, _random_params  # noqa: E402
from ttt_video_dit_torch.models import recompute  # noqa: E402
from ttt_video_dit_torch.models.dit import dit as t_dit  # noqa: E402
from ttt_video_dit_tpu.models.dit import dit as j_dit  # noqa: E402

torch.set_num_threads(1)
CFG = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), remat_transformer_layers=False)


def _inputs(rng, geometry):
    frames, scenes = GEOMETRIES[geometry]
    vid = rng.standard_normal((1, frames, CFG.in_channels, LAT, LAT)).astype(np.float32)
    text = rng.standard_normal((1, scenes, TEXT_LEN, CFG.text_dim)).astype(np.float32)
    t = np.array([300.0], np.float32)
    return vid, text, t


def _run(model, vid, text, t, w, on: bool, monkeypatch):
    """The DiT's output, the gradients of sum(out * w) (the video input's, then every parameter's) and the bytes
    autograd saved, with the layers recomputing if ``on``."""
    monkeypatch.setattr(recompute, "binds", lambda x: on)
    model.zero_grad(set_to_none=True)
    v = torch.from_numpy(vid).requires_grad_(True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda x: saved.append(x.untyped_storage().nbytes()) or x,
                                                  lambda x: x):
        out = model(v, torch.from_numpy(text), torch.from_numpy(t))
    (out * torch.from_numpy(w)).sum().backward()
    grads = [v.grad] + [p.grad for p in model.parameters()]
    return out.detach(), grads, sum(saved)


@pytest.fixture(scope="module")
def dit():
    """flax DiT (random params) and the port loaded with the same weights."""
    model = j_dit.DiffusionTransformer(CFG)
    vid = jnp.zeros((1, 37, CFG.in_channels, LAT, LAT), jnp.float32)
    text = jnp.zeros((1, 3, TEXT_LEN, CFG.text_dim), jnp.float32)
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), vid, text, jnp.zeros((1,))), 5)
    port = _port(t_dit.DiffusionTransformer(CFG), {"params": params["params"]})
    return model, params, port


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_recompute_is_bit_equal_and_saves_less(rng, dit, geometry, monkeypatch):
    _, _, port = dit
    vid, text, t = _inputs(rng, geometry)
    w = rng.standard_normal(vid.shape).astype(np.float32)
    out_off, grads_off, saved_off = _run(port, vid, text, t, w, False, monkeypatch)
    out_on, grads_on, saved_on = _run(port, vid, text, t, w, True, monkeypatch)
    np.testing.assert_array_equal(out_on.numpy(), out_off.numpy())
    for a, b in zip(grads_on, grads_off, strict=True):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), b.numpy())
    assert saved_on < saved_off


@pytest.mark.parametrize("geometry", GEOMETRIES)
def test_recomputed_input_gradient_matches_flax(rng, dit, geometry, monkeypatch):
    model, params, port = dit
    vid, text, t = _inputs(rng, geometry)
    w = rng.standard_normal(vid.shape).astype(np.float32)
    want = jax.jit(jax.grad(lambda v: (model.apply(params, v, jnp.asarray(text), jnp.asarray(t)) * w).sum()))(
        jnp.asarray(vid))
    _, grads, _ = _run(port, vid, text, t, w, True, monkeypatch)
    _close(grads[0].numpy(), want)


def test_binds_is_off_on_the_cpu_and_off_outside_when():
    assert not recompute.binds(torch.zeros(8, 3072, dtype=torch.bfloat16))
    x = torch.ones(4, requires_grad=True)
    assert recompute.recomputed(torch.sin, x).grad_fn.name() == "SinBackward0"
    with recompute.when(True):
        assert "Recomputed" in recompute.recomputed(torch.sin, x).grad_fn.name()
        with torch.no_grad():
            assert recompute.recomputed(torch.sin, x).grad_fn is None
    assert recompute.recomputed(torch.sin, x).grad_fn.name() == "SinBackward0"
