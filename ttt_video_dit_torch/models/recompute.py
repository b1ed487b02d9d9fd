"""Recompute in the backward instead of keeping what autograd would save,
where a layer's saves would bind the card's memory.

PyTorch's eager autograd keeps every intermediate an elementwise chain
needs: the tanh GELU of the MLP saves five tensors of the hidden width a
token, a float32 LayerNorm its float32 input: ~28 and ~8 times the bf16
stream a layer (scripts/measure_torch_layer_saves.py), of ~78 in all, where
XLA keeps only what its fusions need. At 63 s (352,512 tokens of d3072) the
stream is 2.02 GiB, and under remat policy "none" a layer's recompute holds
all of it at once.
:func:`recomputed` runs such a function without a graph, keeps only its
inputs, and in the backward runs it again under autograd and takes the
gradients of that graph: the same operations on the same values, so the
output and every gradient are bit-equal to the function differentiated
directly. The cost is the function's forward once more and a backward,
paid only inside :func:`when` ``(True)``: a transformer layer enters it
when :func:`binds` says its saves would take much of the card
(models/dit/dit.py), and elsewhere the function runs as it is.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch

# The bytes one layer keeps for its backward without the recompute, as a multiple of its rows of the bf16
# stream (77.99 at tp 1, 63.52 at tp 4: scripts/measure_torch_layer_saves.py --recompute off), and the share of
# the card's memory from which they bind: the rest holds the parameters, the optimizer state, every layer's
# boundary save and the layer's transients.
LAYER_SAVES = 78
CARD_SHARE = 0.4

_ON = contextvars.ContextVar("recompute", default=False)


def binds(x) -> bool:
    """Whether a layer over the rows ``x`` of the stream recomputes: ``x`` is
    on a card, and LAYER_SAVES times its bytes exceed CARD_SHARE of the
    card's memory. A function of the shape and the card only, so a layer's
    checkpointed re-run decides as its forward did."""
    if not x.is_cuda:
        return False
    total = torch.cuda.get_device_properties(x.device).total_memory
    return LAYER_SAVES * x.numel() * x.element_size() > CARD_SHARE * total


@contextlib.contextmanager
def when(on: bool):
    """:func:`recomputed` recomputes inside this block if ``on``, else runs its function as it is."""
    token = _ON.set(on)
    try:
        yield
    finally:
        _ON.reset(token)


class _Recomputed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, fn, *args):
        ctx.fn = fn
        ctx.save_for_backward(*args)
        with torch.no_grad():
            return fn(*args)

    @staticmethod
    def backward(ctx, grad):
        needs = ctx.needs_input_grad[1:]
        args = [a.detach().requires_grad_(n) for a, n in zip(ctx.saved_tensors, needs)]
        with torch.enable_grad():
            out = ctx.fn(*args)
        wrt = [a for a, n in zip(args, needs) if n]
        grads = iter(torch.autograd.grad(out, wrt, grad, allow_unused=True)) if wrt else iter(())
        return (None, *(next(grads) if n else None for n in needs))


def recomputed(fn, *args):
    """``fn(*args)`` (tensors in, one tensor out), keeping only ``args`` for
    the backward inside :func:`when` ``(True)``; elsewhere, or without
    autograd, ``fn(*args)``."""
    if not (_ON.get() and torch.is_grad_enabled()):
        return fn(*args)
    return _Recomputed.apply(fn, *args)
