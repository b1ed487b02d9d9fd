"""Attention windows with a prefix of more than one frame
(``prefix_temporal_length`` > 1, models/dit/dit.py), which no TOML sets:

- the port's loss and every gradient against the JAX package's at prefix 2
  (38 frames, windows of 2 + 12 frames, 3 scenes, 8 text tokens), both
  variants, within tests/test_torch_long_context.py's GRAD_REL_L2 1e-4 (its
  helpers, d32, 1 layer, float32 plain versions); prefix 3 (39 frames, 4
  text tokens) in tests/test_torch_prefix_windows_3.py (xdist deals whole
  files, so each stays under a minute);
- the window gather and stitch (``WindowGather`` / ``WindowStitch``, sums
  in window order) against the ``index_select`` / ``index_add_``
  formulation they replace, forward and backward in float64, bit for bit,
  and bit-equal across two runs; at prefix 5 over windows of 2 frames a
  frame lies in three windows;
- the DiT at prefix 2 under remat policy save_seq against none, loss and
  gradients bit for bit (the two Functions under selective checkpointing).

The kernel path on the card (two bf16 runs bit-equal) is
tests/test_torch_cuda.py::test_prefix_windows_training_step_reruns_agree.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_long_context import (  # noqa: E402
    VARIANTS, _inputs, _port_loss_and_grads, _port_model, check_loss_and_gradients_match_jax)
from ttt_video_dit_torch.models.dit.dit import WindowGather, WindowStitch  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("variant", VARIANTS)
def test_prefix_2_loss_and_gradients_match_jax(variant):
    check_loss_and_gradients_match_jax("38f_prefix_2", variant)


def _old_gather_and_stitch(frames, cot_win, w, cot_out, P, AL, C):
    """The replaced formulation: ``index_select`` over the windows' frame
    indices and ``index_add_`` back, each with its autograd backward."""
    T, WF = frames.shape[1], P + AL
    idx = torch.from_numpy((np.arange(C)[:, None] * AL + np.arange(WF)[None, :]).reshape(-1))
    f = frames.clone().requires_grad_()
    win = f.index_select(1, idx).reshape(frames.shape[0], C, WF, *frames.shape[2:])
    (win * cot_win).sum().backward()
    ww = w.clone().requires_grad_()
    out = torch.zeros((w.shape[0], T) + w.shape[3:], dtype=w.dtype).index_add(
        1, idx, ww.reshape(w.shape[0], C * WF, *w.shape[3:]))
    (out * cot_out).sum().backward()
    return win.detach(), f.grad, out.detach(), ww.grad


def _new_gather_and_stitch(frames, cot_win, w, cot_out, P, AL, C):
    T = frames.shape[1]
    f = frames.clone().requires_grad_()
    win = WindowGather.apply(f, AL, P + AL)
    (win * cot_win).sum().backward()
    ww = w.clone().requires_grad_()
    out = WindowStitch.apply(ww, T, AL)
    (out * cot_out).sum().backward()
    return win.detach(), f.grad, out.detach(), ww.grad


@pytest.mark.parametrize("P,AL,C", [(2, 12, 3), (3, 12, 3), (5, 2, 4)])
def test_window_gather_and_stitch_match_index_select_and_index_add(P, AL, C):
    """Forward and backward of both Functions against the formulation they
    replace, float64, bit for bit, and twice."""
    rng = np.random.default_rng(P)
    B, T, WF, TPF, D = 2, P + C * AL, P + AL, 3, 5
    t = lambda *s: torch.from_numpy(rng.standard_normal(s))  # noqa: E731
    args = (t(B, T, TPF, D), t(B, C, WF, TPF, D), t(B, C, WF, TPF, D), t(B, T, TPF, D), P, AL, C)
    want = _old_gather_and_stitch(*args)
    got = _new_gather_and_stitch(*args)
    again = _new_gather_and_stitch(*args)
    for name, g, a, w in zip(("windows", "frames' gradient", "stitched", "windows' gradient"), got, again, want):
        assert g.dtype == torch.float64 and g.shape == w.shape, name
        assert torch.equal(g, w), name
        assert torch.equal(g, a), name


def test_save_seq_equals_none_at_prefix_2():
    """The DiT at prefix 2 (38 frames) under remat policy save_seq against
    none: the same loss and gradients, bit for bit."""
    _, model = _port_model("38f_prefix_2", "ttt_mlp")
    vid, text, lo, hi = _inputs("38f_prefix_2", model.config)
    draws = (np.array([300, 700]), np.random.default_rng(1).standard_normal(vid.shape).astype(np.float32))
    results = []
    for policy in ("none", "save_seq"):
        model.config.remat_policy = policy  # every module holds this config
        results.append(_port_loss_and_grads(model, vid, text, lo, hi, *draws))
    (loss_none, grads_none), (loss_seq, grads_seq) = results
    assert loss_none == loss_seq
    for name, g in grads_none.items():
        assert torch.equal(grads_seq[name], g), name
