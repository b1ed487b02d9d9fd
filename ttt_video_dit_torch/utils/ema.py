"""Exponential-moving-average parameter tracking (port of
ttt_video_dit_tpu/utils/ema.py, on state dicts).

The warm-up-ramped decay ``min(decay, (1 + n) / (10 + n))`` of the
reference's LitEma, an update step, and a swap helper for evaluating with
the EMA weights. Neither package's training uses it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class EmaState(NamedTuple):
    ema_params: dict  # name -> tensor, as the state dict it was made from
    num_updates: int  # -1: no warm-up ramp


@torch.no_grad()
def init(params: dict, use_num_updates: bool = True) -> EmaState:
    """An EMA of ``params`` (a state dict, or any name -> tensor map), starting at their values."""
    return EmaState({k: v.detach().clone() for k, v in params.items()}, 0 if use_num_updates else -1)


@torch.no_grad()
def update(state: EmaState, params: dict, decay: float = 0.9999) -> EmaState:
    """One EMA step: ema -= (1 - d) * (ema - param), with the ramp
    d = min(decay, (1 + n) / (10 + n)) while n >= 0 (computed in float32, as
    the JAX package does)."""
    n = state.num_updates
    d = torch.tensor(decay, dtype=torch.float32)
    if n >= 0:
        d = torch.minimum(d, (1.0 + torch.tensor(float(n))) / (10.0 + torch.tensor(float(n))))
    one_minus = 1.0 - d
    ema = {k: e - one_minus.to(device=e.device, dtype=e.dtype) * (e - params[k].to(e.dtype)) for k, e in
           state.ema_params.items()}
    return EmaState(ema, n + 1 if n >= 0 else n)


def swap(state: EmaState, params: dict):
    """(the EMA weights to evaluate with, the live weights to restore after)."""
    return state.ema_params, params
