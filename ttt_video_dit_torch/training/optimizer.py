"""Grouped AdamW with per-group LR schedules and adapter freezing (port of
ttt_video_dit_tpu/training/optimizer.py).

The same four parameter groups (TTT +/- weight decay, other +/- weight
decay), matched on the flax-mirrored parameter paths; AdamW(0.9, 0.95,
eps 1e-8), WD 1e-4, warm-up + cosine/linear schedules; and the optax chain
the JAX package builds, step for step:

- clip_by_global_norm: g unchanged when ||g|| < c, else (g / ||g||) * c, with
  no epsilon (``torch.nn.utils.clip_grad_norm_`` adds 1e-6 and differs);
- scale_by_adam: bias-corrected moments, m_hat / (sqrt(v_hat) + eps);
- add_decayed_weights: + wd * p;
- scale_by_learning_rate: * -schedule(count), the count starting at 0, so the
  first update uses schedule(0).

Under FSDP2 and head tensor parallelism (parallel/sharding.py) the
parameters, their gradients and the moments (made like their parameters)
are DTensors of one layout each: the update runs on their local shards,
elementwise, and the clip reads the norm of the full gradient
(parallel/sharded.py:square_sum, one all-reduce over the world).
"""

from __future__ import annotations

import math
import re
from typing import Callable

import torch

from ttt_video_dit_torch.parallel.sharded import copy_full_, local, square_sum

NO_WEIGHT_DECAY_PATTERNS = ("bias", "norm", "b1", "b2")
TTT_PARAMETER_PATTERNS = ("ttt", "ssm")
WEIGHT_DECAY_VALUE = 1e-4
GROUPS = ("ttt_no_wd", "ttt_wd", "other_no_wd", "other_wd")

_QKVO_NAMES = ("/q/", "/k/", "/v/", "/o/")


def flax_path(name: str) -> str:
    """A torch parameter name as the flax path it mirrors:
    ``dit.layers.0.mlp.layer1.weight`` -> ``dit/layers_0/mlp/layer1/weight``
    (leaf names differ, kernel/scale vs weight, and no pattern reads them)."""
    return re.sub(r"(^|\.)layers\.(\d+)", r"\1layers_\2", name).replace(".", "/")


def is_ttt_parameter(path: str) -> bool:
    p = path.lower()
    return any(pat in p for pat in TTT_PARAMETER_PATTERNS)


def skips_weight_decay(path: str) -> bool:
    p = path.lower()
    return any(pat in p for pat in NO_WEIGHT_DECAY_PATTERNS)


def is_trainable(path: str, adapter_method: str) -> bool:
    """Which params train per adapter method: sft everything; qkvo the
    attention q/k/v/o, q/k norms, all TTT params and SSM gates; none the same
    as qkvo without the q/k norms."""
    if adapter_method == "sft":
        return True
    p = "/" + path.lower() + "/"
    if "ssm" in p:
        return True
    if "/attention/" in p and any(n in p for n in _QKVO_NAMES):
        return True
    if adapter_method == "qkvo" and ("q_norm" in p or "k_norm" in p):
        return True
    return False


def group_label(path: str) -> str:
    ttt = is_ttt_parameter(path)
    no_wd = skips_weight_decay(path)
    if ttt:
        return "ttt_no_wd" if no_wd else "ttt_wd"
    return "other_no_wd" if no_wd else "other_wd"


def make_lr_schedule(schedule_type: str, warmup_steps: int, total_steps: int, lr_peak: float,
                     lr_end: float) -> Callable[[int], float]:
    """Absolute-LR schedule: linear warm-up to ``lr_peak`` over ``warmup_steps``,
    then cosine or linear decay to ``lr_end``."""
    decay_steps = max(1, total_steps - warmup_steps)

    def warm(step):
        return lr_peak * (step + 1.0) / max(warmup_steps, 1)

    def cosine(step):
        if step < warmup_steps:
            return warm(step)
        return lr_end + (lr_peak - lr_end) * 0.5 * (1.0 + math.cos(math.pi * (step - warmup_steps) / decay_steps))

    def linear(step):
        if step < warmup_steps:
            return warm(step)
        frac = min((step - warmup_steps) / decay_steps, 1.0)
        return lr_peak * (1.0 - frac) + lr_end * frac

    if schedule_type == "cosine":
        return cosine
    if schedule_type == "linear":
        return linear
    raise ValueError(f"Unsupported schedule type: {schedule_type!r}")


def global_norm(tensors) -> torch.Tensor:
    """sqrt(sum of squares) over every tensor, in float32 (a device scalar);
    over the full tensors of DTensors."""
    return torch.sqrt(square_sum(tensors))


class GroupedAdamW:
    """The optax chain of the JAX package as one object over the trainable
    parameters of a module. ``step()`` reads each parameter's ``.grad``, clips
    by the global norm, updates in place, and returns the global norm before
    clipping."""

    def __init__(self, named_params, schedules: dict, weight_decay: dict, clip_norm: float,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8):
        self.params = [(flax_path(n), p) for n, p in named_params]
        self.labels = {path: group_label(path) for path, _ in self.params}
        self.schedules, self.weight_decay, self.clip_norm = schedules, weight_decay, clip_norm
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for _, p in self.params]
        self.nu = [torch.zeros_like(p) for _, p in self.params]
        self.count = 0

    def learning_rates(self, step: int | None = None) -> dict[str, float]:
        step = self.count if step is None else step
        return {name: fn(step) for name, fn in self.schedules.items()}

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for _, p in self.params]
        g_norm = global_norm(grads)
        clip = g_norm >= self.clip_norm
        lrs = self.learning_rates()
        t = self.count + 1
        bc1, bc2 = 1.0 - self.b1**t, 1.0 - self.b2**t
        for (path, p), g, m, v in zip(self.params, grads, self.mu, self.nu):
            p, g, m, v = local(p), local(g), local(m), local(v)  # one layout: the update is elementwise
            g = torch.where(clip, (g / g_norm.to(g.dtype)) * self.clip_norm, g)
            m.mul_(self.b1).add_(g, alpha=1.0 - self.b1)  # (1 - b1) g + b1 m
            v.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            u = (m / bc1) / (torch.sqrt(v / bc2) + self.eps)
            label = self.labels[path]
            if self.weight_decay[label]:
                u = u + self.weight_decay[label] * p
            p.add_(u, alpha=-lrs[label])
        self.count = t
        return g_norm

    def state_dict(self) -> dict:
        """{"count": int, "mu": {flax path: tensor}, "nu": {flax path: tensor}} (the live tensors, DTensors
        under FSDP2)."""
        paths = [path for path, _ in self.params]
        return {"count": self.count, "mu": dict(zip(paths, self.mu)), "nu": dict(zip(paths, self.nu))}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        """Copy a :meth:`state_dict` in place, strictly: the same paths, each
        at its shape; values are cast to the moments' dtypes and devices one
        tensor at a time, a sharded moment taking its shard of the full value
        (``state``'s moments may be any name -> tensor maps, e.g.
        ``safetensors.LazyFile``s)."""
        paths = [path for path, _ in self.params]
        for key, live in (("mu", self.mu), ("nu", self.nu)):
            src = state[key]
            if set(src) != set(paths):
                missing, extra = sorted(set(paths) - set(src)), sorted(set(src) - set(paths))
                raise KeyError(f"optimizer state {key}: missing {missing[:4]}, unexpected {extra[:4]}")
            for path, t in zip(paths, live):
                value = src[path]
                if tuple(value.shape) != tuple(t.shape):
                    raise ValueError(f"optimizer state {key}/{path}: shape {tuple(value.shape)}, "
                                     f"expected {tuple(t.shape)}")
                copy_full_(t, value)
        self.count = int(state["count"])

    def zero_grad(self) -> None:
        for _, p in self.params:
            p.grad = None


def build_optimizer(module: torch.nn.Module, *, lr: float, lr_ssm: float, lr_end: float, lr_schedule: str = "linear",
                    lr_ssm_schedule: str = "linear", warmup_steps: int, total_steps: int,
                    gradient_clipping_norm: float = 0.1, adapter_method: str = "sft") -> GroupedAdamW:
    """The grouped AdamW over ``module``'s trainable parameters; frozen ones
    get ``requires_grad = False``."""
    named = []
    for name, p in module.named_parameters():
        p.requires_grad_(is_trainable(flax_path(name), adapter_method))
        if p.requires_grad:
            named.append((name, p))
    schedules = {
        "ttt_no_wd": make_lr_schedule(lr_ssm_schedule, warmup_steps, total_steps, lr_ssm, lr_end),
        "ttt_wd": make_lr_schedule(lr_ssm_schedule, warmup_steps, total_steps, lr_ssm, lr_end),
        "other_no_wd": make_lr_schedule(lr_schedule, warmup_steps, total_steps, lr, lr_end),
        "other_wd": make_lr_schedule(lr_schedule, warmup_steps, total_steps, lr, lr_end),
    }
    wd = {"ttt_no_wd": 0.0, "ttt_wd": WEIGHT_DECAY_VALUE, "other_no_wd": 0.0, "other_wd": WEIGHT_DECAY_VALUE}
    return GroupedAdamW(named, schedules, wd, gradient_clipping_norm)


def build_optimizer_from_config(module: torch.nn.Module, job_config, adapter_method: str = "sft") -> GroupedAdamW:
    """build_optimizer with the reference-named config sections."""
    return build_optimizer(
        module,
        lr=job_config.optimizer.lr,
        lr_ssm=job_config.optimizer.lr_ssm,
        lr_end=job_config.optimizer.lr_end,
        lr_schedule=job_config.optimizer.lr_schedule,
        lr_ssm_schedule=job_config.optimizer.lr_ssm_schedule,
        warmup_steps=job_config.training.warmup_steps,
        total_steps=job_config.training.steps,
        gradient_clipping_norm=job_config.optimizer.gradient_clipping_norm,
        adapter_method=adapter_method,
    )
