"""One training step (port of ttt_video_dit_tpu/training/train_step.py).

Text dropout, the CogVideoX loss, gradient accumulation over micro-batches,
then the grouped AdamW (global-norm clip included). The JAX step is one
jitted function over an immutable state; here the model's parameters and the
optimizer's moments are updated in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ttt_video_dit_torch.parallel.sharding import sum_replicated_grads


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of optimizer step ``step`` (0-based: the optimizer's
    count before the step), seeded from (seed, step) alone, as the JAX step
    folds ``state.step`` into its key: a resumed run draws what an
    uninterrupted run draws."""
    state = np.random.SeedSequence([seed, step]).generate_state(2, np.uint32)
    return torch.Generator(device).manual_seed((int(state[0]) << 31) | (int(state[1]) >> 1))


def global_draws(generator: torch.Generator, global_batch_size: int, vid_shape, text_dropout_prob: float,
                 sigma_lo, sigma_hi, device) -> dict:
    """The step's random draws for the whole global batch, in one order from
    ``generator``: the text-dropout keep mask [G] (kept with probability
    1 - ``text_dropout_prob``), the sigma index [G] (lo + u % max(hi - lo, 1)
    with u uniform in [0, 2^30), from the global bounds) and the noise
    [G, *vid_shape]. Every rank draws them all and takes its data rank's
    slice (:func:`rank_draws`), so N ranks draw what one process draws for
    the same global batch, as the JAX step draws over the global batch."""
    G = global_batch_size
    keep = torch.rand(G, generator=generator, device=device) < 1.0 - text_dropout_prob
    u = torch.randint(0, 1 << 30, (G,), generator=generator, device=device)
    lo, hi = (torch.as_tensor(x, device=device).long() for x in (sigma_lo, sigma_hi))
    noise = torch.randn((G, *vid_shape), generator=generator, device=device)
    return {"keep": keep, "idx": lo + u % torch.clamp(hi - lo, min=1), "noise": noise}


def rank_draws(draws: dict, rank: int, ranks: int, grad_accum_steps: int) -> list:
    """Data rank ``rank`` of ``ranks``'s contiguous slice of :func:`global_draws`,
    split into the micro-batches of :func:`train_step` (its ``draws``)."""
    local = draws["idx"].shape[0] // ranks
    micro = local // grad_accum_steps
    start = rank * local
    return [{k: v[start + i * micro : start + (i + 1) * micro] for k, v in draws.items()}
            for i in range(grad_accum_steps)]


def apply_text_dropout(text, prob: float, generator: torch.Generator | None = None, keep=None):
    """Zero the whole text conditioning of a sample with probability ``prob``
    (classifier-free-guidance dropout). ``keep`` [B] (1 keeps, 0 drops)
    replaces the draw from ``generator``."""
    if keep is None:
        if prob <= 0.0:
            return text
        keep = torch.rand(text.shape[0], generator=generator, device=text.device) < 1.0 - prob
    keep = torch.as_tensor(keep, device=text.device).to(text.dtype)
    return text * keep.reshape(-1, *([1] * (text.ndim - 1)))


def train_step(model, optimizer, batch: dict, *, grad_accum_steps: int = 1, text_dropout_prob: float = 0.1,
               generator: torch.Generator | None = None, draws: list | None = None) -> dict:
    """One optimizer step on ``batch`` (vid [B, T, C, H, W], text
    [B, scenes, S, E], sigma_lo/sigma_hi [B]), split into ``grad_accum_steps``
    micro-batches whose gradients are averaged. Random draws (text-dropout
    keep mask, sigma index, noise) come from ``generator``; ``draws``, one dict
    per micro-batch with any of "keep", "idx", "noise", replaces them.
    Returns {"loss", "grad_norm"} as device scalars (the grad norm before
    clipping)."""
    vid, text = batch["vid"], batch["text"]
    B = vid.shape[0]
    micro = B // grad_accum_steps
    optimizer.zero_grad()
    loss_sum = torch.zeros((), device=vid.device)
    for i in range(grad_accum_steps):
        sl = slice(i * micro, (i + 1) * micro)
        d = draws[i] if draws else {}
        t = apply_text_dropout(text[sl], text_dropout_prob, generator, d.get("keep"))
        loss = model(vid[sl], t, (batch["sigma_lo"][sl], batch["sigma_hi"][sl]), generator,
                     idx=d.get("idx"), noise=d.get("noise")).mean()
        (loss / grad_accum_steps).backward()
        loss_sum = loss_sum + loss.detach()
    sum_replicated_grads(model)  # under sequence parallelism each tensor rank holds a partial sum
    grad_norm = optimizer.step()
    return {"loss": loss_sum / grad_accum_steps, "grad_norm": grad_norm}
