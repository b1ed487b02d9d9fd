"""Kernel self-test: every CUDA kernel of the port against its plain PyTorch
version on the card, at small shapes chosen to discriminate (port of
ttt_video_dit_tpu/utils/selftest.py:kernel_selftest).

The CPU tests can only run the plain versions; this runs the kernels on the
card and holds each to its plain version (ops/*: the ``*_plain`` functions,
which round where the kernels round), so a benchmark that runs it before
timing doubles as a hardware parity check. After the kernels are built it
takes seconds. It keeps the JAX self-test's discriminators and metric,
max|kernel - plain| / max|plain|:

- full/ragged pairs at identical shapes (the ragged one takes one more
  mini-batch of the same arrays, so its last checkpoint group is short): a
  masked edge write shows as ragged >> full, plain bf16 noise as both alike;
- 12 local heads (48 heads at tp 4) with a ragged last group (NC 9, K 8);
- the LR gate at a large eta, where the state update moves the output;
- folded-window attention (3 windows of a ragged 417 tokens), forward and
  backward, and the backward launched twice: dq, dk and dv must be
  bit-equal (K4 sums each element in a fixed order);
- the sampling scans (B 2) at an even and an odd NC (K1's ring has two
  stages), and K7 bit for bit on a [12288, 3072] weight;
- the other mini-batches of each kernel's instantiations: K5, K5-train and
  K6 at CS 32 and 64 (full and ragged; an eta-gate case at 64), K1-train
  and K2 at CS 16, 32 and 48 (full and ragged; an eta-gate case at 16) and
  K1 at CS 32, 48 and 64 (the training kernel with no checkpoints), rows
  ``K5@CS64``, ``K2@CS16`` etc.;
- the half slabs: every training kernel at CS 8, 24, 40 and 56 (ragged; an
  eta-gate case at 8 and 56) and K1 and K5 at CS 8 and 24 (an odd NC), so
  a last mini-batch whose last 16-token slab holds 8 tokens ends every
  scan;
- the float32 kernels (float32 q/k/v): every TTT kernel at every CS of
  KERNEL_MINI_BATCHES, full and ragged (F32_TRAIN_CASES, F32_SAMPLE_CASES;
  an eta-gate case per variant), rows ``K1@f32``, ``K2@f32`` etc., at a
  tenth of the bf16 tolerances and on the output itself: nothing is rounded
  to bf16 on either side, so only float32 summation order separates them;
- head dim 128 (d3072 at 24 heads): K5 at CS 16 at an even and an odd NC
  and at a large eta (F128_SAMPLE_CASES), K5-train and K6 full, ragged and
  at a large eta (F128_TRAIN_CASES), K3, K3-lse (its output and its
  log-sum-exp, LSE_TOL) and K4 on three ragged windows of 417 tokens, and
  K4 launched twice (bit-equal, F128_RERUN_CHECK), rows ``K5@F128``,
  ``K3-lse@F128`` etc., at the tolerances of the head-dim-64 checks.

Every check's name ends with the kernel rows it drives, as PERF.md's table
names them ([K1] ... [K7]; a row at another mini-batch than the kernel's
first, [K5-train@CS64]). The training checks go through the autograd
Functions the model trains through (``ttt_mlp_train``, ``ttt_linear_train``,
``attention_train``) on loss = sum(out^2) (attention: sum(out * ct)), and
compare the loss, the input gradients dq/dk/dv, the gate's gradient and the
initial state's and LN affine's gradients (dstate: the worst of them, each
against its own maximum).

Usage::

    from ttt_video_dit_torch.utils.selftest import kernel_selftest
    result = kernel_selftest(torch.device("cuda"), log=print)  # {"ok", "checks", "tolerances", "seconds"}

``scripts/torch_kernel_smoke.py`` runs it from the command line.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np
import torch

from ttt_video_dit_torch.ops import attention, convert, ttt_linear_kernel, ttt_mlp_kernel
from ttt_video_dit_torch.ops.rope import interleaved_tables_prefixed, precompute_rope_3d

# Tolerances of the metric, each beside what it holds. The JAX self-test's where they hold against the plain
# versions' bf16 rounding points: a forward's loss 2e-4, input gradients 2e-2, the attention forward 2e-2 and
# backward 3e-2. The TTT initial-state and LN gradients: chip_smoke.py's SCALED_TOL for K2 and K6 (1e-2 of
# their maximum). K7 and K4's rerun: bit-exact (the value is the share of elements whose bits differ).
FWD_TOL = 2e-4
GRAD_TOL = 2e-2
STATE_GRAD_TOL = 1e-2
ATTENTION_FWD_TOL = 2e-2
ATTENTION_GRAD_TOL = 3e-2
# The log-sum-exp (float32 of values up to ~10 from bf16 q and k on both sides; only the summation order and the
# kernel's exp2 approximation differ, ~1e-6 of its size).
LSE_TOL = 1e-5
# The float32 kernels' (F32_*): a tenth of the bf16 ones each, the forward held on its output itself. Neither side
# rounds to bf16; float32 summation order over these short scans moves them by ~1e-6. One TF32 pass (~3 decimal
# digits) would not meet them.
F32_FWD_TOL = 2e-5
F32_GRAD_TOL = 2e-3
F32_STATE_GRAD_TOL = 1e-3

# The substitutes ``kernels=`` takes, each with the signature of the wrapper it stands in for, and the
# wrappers themselves (the kernel side by default).
KERNELS = {
    "ttt_mlp_forward": ttt_mlp_kernel.ttt_mlp_forward,  # K1
    "ttt_mlp_train": ttt_mlp_kernel.ttt_mlp_train,  # K1-train, K2
    "ttt_linear_forward": ttt_linear_kernel.ttt_linear_forward,  # K5
    "ttt_linear_train": ttt_linear_kernel.ttt_linear_train,  # K5-train, K6
    "attention": attention.attention,  # K3
    "attention_train": attention.attention_train,  # K3-lse, K4
    "attention_with_lse": attention.attention_with_lse,  # K3-lse: its log-sum-exp
    "convert_f32_bf16": convert.convert_f32_bf16,  # K7
}
PLAIN = {
    "ttt_mlp_forward": ttt_mlp_kernel.ttt_mlp_forward_plain,
    "ttt_mlp_train": lambda *a: ttt_mlp_kernel.ttt_mlp_train(*a, plain=True),
    "ttt_linear_forward": ttt_linear_kernel.ttt_linear_forward_plain,
    "ttt_linear_train": lambda *a: ttt_linear_kernel.ttt_linear_train(*a, plain=True),
    "attention": attention.attention_plain,
    "attention_train": lambda q, k, v: attention.attention_train(q, k, v, plain=True),
    "attention_with_lse": lambda q, k, v: attention.attention_plain(q, k, v, return_lse=True),
    "convert_f32_bf16": convert.convert_f32_bf16_plain,
}
# The launch counters of each row (module, attribute): each must move in a self-test of the kernels.
COUNTERS = {
    "K1": (ttt_mlp_kernel, "launches"), "K1-train": (ttt_mlp_kernel, "train_launches"),
    "K2": (ttt_mlp_kernel, "bwd_launches"), "K3": (attention, "launches"), "K3-lse": (attention, "lse_launches"),
    "K4": (attention, "bwd_launches"), "K5": (ttt_linear_kernel, "launches"),
    "K5-train": (ttt_linear_kernel, "train_launches"), "K6": (ttt_linear_kernel, "bwd_launches"),
    "K7": (convert, "launches"),
}
F = 64
F128 = "@F128"  # the row of a head-dim-128 kernel: "<row>@F128"
# The launch counters of the head-dim-128 rows.
F128_COUNTERS = {
    "K3": lambda: attention.f128_launches, "K3-lse": lambda: attention.f128_lse_launches,
    "K4": lambda: attention.f128_bwd_launches,
    **{r: lambda a=a: sum(n for (name, _), n in ttt_linear_kernel.f128_launches_by_cs.items() if name == a)
       for r, a in (("K5", "launches"), ("K5-train", "train_launches"), ("K6", "bwd_launches"))},
}
BASE_LR = {"ttt_mlp": 0.1, "ttt_linear": 1.0}  # the TOMLs' ttt_base_lr: eta = sigmoid(gate) x base / F / CS
STATE = {"ttt_mlp": ("W1", "b1", "W2", "b2"), "ttt_linear": ("W1", "b1")}
ROWS = {"ttt_mlp": ("K1", "K1-train", "K2"), "ttt_linear": ("K5", "K5-train", "K6")}  # sampling, forward, backward
# The mini-batch of each row's first kernel; the same kernel at another CS is the row "<row>@CS<n>".
ROW_CS = {"K1": 16, "K1-train": 64, "K2": 64, "K5": 16, "K5-train": 16, "K6": 16}


F32 = "@f32"  # the row of a float32 kernel: "<row>@f32", at every CS


def row(name: str, CS: int, dtype: torch.dtype = torch.bfloat16) -> str:
    """The row of kernel row ``name`` (K1 ...) at mini-batch ``CS``: ``name`` itself at its first CS; a float32
    kernel's is ``name`` + F32 at every CS."""
    if dtype == torch.float32:
        return name + F32
    return name if CS == ROW_CS[name] else f"{name}@CS{CS}"


def launch_count(row_name: str) -> int:
    """The launch counter of a row: COUNTERS', for "<row>@CS<n>" its kernel's launches_by_cs at CS n, for
    "<row>@f32" its float32 kernel's f32_launches_by_cs over every CS, for "<row>@F128" its head-dim-128
    kernel's (F128_COUNTERS)."""
    if row_name.endswith(F128):
        return F128_COUNTERS[row_name[: -len(F128)]]()
    if row_name.endswith(F32):
        mod, attr = COUNTERS[row_name[: -len(F32)]]
        return sum(n for (a, _), n in mod.f32_launches_by_cs.items() if a == attr)
    base, _, cs = row_name.partition("@CS")
    mod, attr = COUNTERS[base]
    return mod.launches_by_cs[attr, int(cs)] if cs else getattr(mod, attr)


# Training cases: name, variant, heads, NC of the shared arrays, NC this case takes, checkpoint group K, CS, eta
# as a multiple of the TOML's (the large ones: chip_smoke.py's LARGE_ETA_FACTOR at the TOMLs' CS, and for TTT-MLP
# 1,024 at CS 16, 512 at 8 and 3,584 at 56, for TTT-linear 50 at 8 and 350 at 56: eta ~0.1 every way).
TRAIN_CASES = (
    ("ttt_mlp full", "ttt_mlp", 8, 5, 4, 4, 64, 1),
    ("ttt_mlp ragged", "ttt_mlp", 8, 5, 5, 4, 64, 1),
    ("ttt_mlp h12 g6", "ttt_mlp", 12, 9, 9, 8, 64, 1),
    ("ttt_mlp eta-gate", "ttt_mlp", 8, 5, 5, 4, 64, 4096),
    ("ttt_linear full", "ttt_linear", 8, 9, 8, 4, 16, 1),
    ("ttt_linear ragged", "ttt_linear", 8, 9, 9, 4, 16, 1),
    ("ttt_linear eta-gate", "ttt_linear", 8, 9, 9, 4, 16, 100),
    ("ttt_linear cs32 full", "ttt_linear", 8, 5, 4, 2, 32, 1),
    ("ttt_linear cs32 ragged", "ttt_linear", 8, 5, 5, 2, 32, 1),
    ("ttt_linear cs64 full", "ttt_linear", 8, 5, 4, 2, 64, 1),
    ("ttt_linear cs64 ragged", "ttt_linear", 8, 5, 5, 2, 64, 1),
    ("ttt_linear cs64 eta-gate", "ttt_linear", 8, 5, 5, 2, 64, 100),
    ("ttt_mlp cs16 full", "ttt_mlp", 8, 9, 8, 4, 16, 1),
    ("ttt_mlp cs16 ragged", "ttt_mlp", 8, 9, 9, 4, 16, 1),
    ("ttt_mlp cs16 eta-gate", "ttt_mlp", 8, 9, 9, 4, 16, 1024),
    ("ttt_mlp cs32 full", "ttt_mlp", 8, 5, 4, 2, 32, 1),
    ("ttt_mlp cs32 ragged", "ttt_mlp", 8, 5, 5, 2, 32, 1),
    ("ttt_mlp cs48 full", "ttt_mlp", 8, 5, 4, 2, 48, 1),
    ("ttt_mlp cs48 ragged", "ttt_mlp", 8, 5, 5, 2, 48, 1),
    ("ttt_mlp cs8 ragged", "ttt_mlp", 8, 5, 5, 2, 8, 1),
    ("ttt_mlp cs24 ragged", "ttt_mlp", 8, 5, 5, 2, 24, 1),
    ("ttt_mlp cs40 ragged", "ttt_mlp", 8, 5, 5, 2, 40, 1),
    ("ttt_mlp cs56 ragged", "ttt_mlp", 8, 5, 5, 2, 56, 1),
    ("ttt_mlp cs8 eta-gate", "ttt_mlp", 8, 5, 5, 2, 8, 512),
    ("ttt_mlp cs56 eta-gate", "ttt_mlp", 8, 5, 5, 2, 56, 3584),
    ("ttt_linear cs8 ragged", "ttt_linear", 8, 5, 5, 2, 8, 1),
    ("ttt_linear cs24 ragged", "ttt_linear", 8, 5, 5, 2, 24, 1),
    ("ttt_linear cs40 ragged", "ttt_linear", 8, 5, 5, 2, 40, 1),
    ("ttt_linear cs56 ragged", "ttt_linear", 8, 5, 5, 2, 56, 1),
    ("ttt_linear cs8 eta-gate", "ttt_linear", 8, 5, 5, 2, 8, 50),
    ("ttt_linear cs56 eta-gate", "ttt_linear", 8, 5, 5, 2, 56, 350),
)
# Sampling cases: name, variant, batch, heads, NC of the shared arrays, NC this case takes, CS.
SAMPLE_CASES = (
    ("ttt_mlp sampling full", "ttt_mlp", 2, 8, 9, 8, 16),
    ("ttt_mlp sampling ragged", "ttt_mlp", 2, 8, 9, 9, 16),
    ("ttt_linear sampling full", "ttt_linear", 2, 8, 9, 8, 16),
    ("ttt_linear sampling ragged", "ttt_linear", 2, 8, 9, 9, 16),
    ("ttt_mlp sampling cs64 full", "ttt_mlp", 2, 8, 5, 4, 64),
    ("ttt_mlp sampling cs64 ragged", "ttt_mlp", 2, 8, 5, 5, 64),
    ("ttt_linear sampling cs32 full", "ttt_linear", 2, 8, 5, 4, 32),
    ("ttt_linear sampling cs32 ragged", "ttt_linear", 2, 8, 5, 5, 32),
    ("ttt_linear sampling cs64 full", "ttt_linear", 2, 8, 5, 4, 64),
    ("ttt_linear sampling cs64 ragged", "ttt_linear", 2, 8, 5, 5, 64),
    ("ttt_mlp sampling cs32 full", "ttt_mlp", 2, 8, 5, 4, 32),
    ("ttt_mlp sampling cs32 ragged", "ttt_mlp", 2, 8, 5, 5, 32),
    ("ttt_mlp sampling cs48 full", "ttt_mlp", 2, 8, 5, 4, 48),
    ("ttt_mlp sampling cs48 ragged", "ttt_mlp", 2, 8, 5, 5, 48),
    ("ttt_mlp sampling cs8 ragged", "ttt_mlp", 2, 8, 5, 5, 8),
    ("ttt_mlp sampling cs24 ragged", "ttt_mlp", 2, 8, 5, 5, 24),
    ("ttt_linear sampling cs8 ragged", "ttt_linear", 2, 8, 5, 5, 8),
    ("ttt_linear sampling cs24 ragged", "ttt_linear", 2, 8, 5, 5, 24),
)
# The float32 cases: each variant's training and sampling kernels at every CS of KERNEL_MINI_BATCHES, full and
# ragged (the shapes of the bf16 cases at CS 32-64: 8 heads, NC 5 of which the full case takes 4, K 2), and an
# eta-gate case per variant at the large eta of the bf16 ones; fields as TRAIN_CASES' and SAMPLE_CASES'.
F32_TRAIN_CASES = tuple(
    (f"{v} f32 cs{cs} {kind}", v, 8, 5, nc, 2, cs, 1) for v in ("ttt_mlp", "ttt_linear")
    for cs in ttt_mlp_kernel.KERNEL_MINI_BATCHES for kind, nc in (("full", 4), ("ragged", 5))) + (
    ("ttt_mlp f32 eta-gate", "ttt_mlp", 8, 5, 5, 4, 64, 4096),
    ("ttt_linear f32 eta-gate", "ttt_linear", 8, 9, 9, 4, 16, 100))
F32_SAMPLE_CASES = tuple(
    (f"{v} sampling f32 cs{cs} {kind}", v, 2, 8, 5, nc, cs) for v in ("ttt_mlp", "ttt_linear")
    for cs in ttt_mlp_kernel.KERNEL_MINI_BATCHES for kind, nc in (("full", 4), ("ragged", 5)))
# Head dim 128: K5 (its sampling kernel, the one ported at that width) at CS 16, B 2, 4 heads, NC 8 and 9 of one
# draw and 9 at 1,000x the TOMLs' eta (eta ~0.49, where the state update moves the output); fields name, batch,
# heads, NC of the shared arrays, NC this case takes, eta factor. K3 on 3 ragged windows of 417 tokens, 2 heads.
F128_SAMPLE_CASES = (
    ("ttt_linear sampling f128 full", 2, 4, 9, 8, 1),
    ("ttt_linear sampling f128 ragged", 2, 4, 9, 9, 1),
    ("ttt_linear sampling f128 eta-gate", 2, 4, 9, 9, 1000),
)
# K5-train and K6 at CS 16, B 1, 4 heads, NC 8 and 9 of one draw (K 4: the ragged case's last group is one
# mini-batch) and 9 at 200x the TOMLs' eta (eta ~0.1, as the head-dim-64 eta-gate case); fields as TRAIN_CASES'.
F128_TRAIN_CASES = (
    ("ttt_linear f128 full", "ttt_linear", 4, 9, 8, 4, 16, 1),
    ("ttt_linear f128 ragged", "ttt_linear", 4, 9, 9, 4, 16, 1),
    ("ttt_linear f128 eta-gate", "ttt_linear", 4, 9, 9, 4, 16, 200),
)
F128_ATTENTION_SHAPE = (3, 417, 2, 128)
ATTENTION_SHAPE = (3, 417, 4, 64)  # 3 windows of a ragged 417 tokens, 4 heads
RERUN_CHECK = "splash folded-windows rerun bit-equal [K4]"  # K4's determinism: two launches, the same bits
F128_RERUN_CHECK = "splash folded-windows f128 rerun bit-equal [K4@F128]"
CONVERT_SHAPE = (12288, 3072)  # the MLP's layer2 weight, [out, in]
# K7's first elements: ties, subnormals, signed zeros, +-inf, NaN and values past the bf16 maximum.
CONVERT_SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.39e38, 1e-40, -1e-45, 1.00390625,
                            1.01171875, -1.00390625, 3.0e-39], np.float32)


def bits_differ(a, b) -> float:
    """The share of the elements of two equal-shaped bf16 tensors whose bits differ (0: torch.equal bit for bit)."""
    return int((a.view(torch.int16) != b.view(torch.int16)).sum()) / a.numel()


def rel_err(a, b) -> float:
    """max|a - b| / max|b| (the JAX self-test's metric), in float32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / ((b.abs().max()) + 1e-8))


def ttt_arrays(rng, variant: str, B: int, H: int, NC: int, CS: int, F: int = F) -> dict:
    """Seeded inputs of a TTT scan (numpy float32): raw token-major q/k/v [B, NC, CS, H*F], gate logits
    [B, H, NC, CS], the rope tables [NC, CS, F] of an 8 x 8 grid after one text mini-batch (identity rows), the LN
    affine [H, F] and the variant's initial state, drawn as the JAX self-test draws them (head dim ``F``: 64, or
    128 for the F128 cases)."""
    f = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    a = dict(XQ=f(B, NC, CS, H * F), XK=f(B, NC, CS, H * F), XV=f(B, NC, CS, H * F), gate=f(B, H, NC, CS))
    cos, sin = precompute_rope_3d(F, 8, 8, (NC * CS - CS) // 64 + 1)
    cos, sin = interleaved_tables_prefixed(cos, sin, CS, NC * CS)
    a.update(rope_cos=cos.numpy().reshape(NC, CS, F), rope_sin=sin.numpy().reshape(NC, CS, F),
             ln_w=np.abs(f(H, F)) + np.float32(0.5), ln_b=f(H, F, scale=0.1))
    if variant == "ttt_mlp":
        a.update(W1=f(H, F, 4 * F, scale=0.02), b1=f(H, 1, 4 * F, scale=0.01), W2=f(H, 4 * F, F, scale=0.02),
                 b2=f(H, 1, F, scale=0.01))
    else:
        a.update(W1=f(H, F, F, scale=0.02), b1=f(H, 1, F, scale=0.01))
    return a


def take(a: dict, nc: int) -> dict:
    """The first ``nc`` mini-batches of :func:`ttt_arrays`' arrays."""
    out = dict(a)
    for k in ("XQ", "XK", "XV", "rope_cos", "rope_sin"):
        out[k] = a[k][:, :nc] if k.startswith("X") else a[k][:nc]
    out["gate"] = a["gate"][:, :, :nc]
    return out


def eta_scale(variant: str, CS: int, factor: float = 1, F: int = F) -> float:
    return factor * BASE_LR[variant] / F / CS


def _tensors(a: dict, variant: str, device, grad: bool, dtype: torch.dtype = torch.bfloat16) -> list:
    """The wrapper's leading arguments on ``device`` (q/k/v in ``dtype``), leaves that take gradients with
    ``grad``."""
    names = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b") + STATE[variant]
    out = []
    for n in names:
        t = torch.from_numpy(np.ascontiguousarray(a[n])).to(device)
        if n in ("XQ", "XK", "XV"):
            t = t.to(dtype)
        out.append(t.requires_grad_(grad and not n.startswith("rope")))
    return out


def ttt_loss_and_grads(fn, a: dict, variant: str, K: int, eta: float, device, dtype: torch.dtype = torch.bfloat16,
                       with_out: bool = False):
    """loss = sum(fn(...)^2) in float32 through a training scan ``fn`` (the wrapper's signature) on q/k/v in
    ``dtype``, and the gradients of q, k, v, the gate, ln_w, ln_b and the initial state, in that order; with
    ``with_out``, the output in place of the loss."""
    args = _tensors(a, variant, device, grad=True, dtype=dtype)
    out = fn(*args, eta, K)
    loss = (out.float() ** 2).sum()
    leaves = [t for t in args if t.requires_grad]
    return (out if with_out else loss).detach(), torch.autograd.grad(loss, leaves)


def attention_arrays(rng, shape: tuple = ATTENTION_SHAPE) -> dict:
    """q/k/v (bf16 once on the card) and the output cotangent ct of the folded-window checks, numpy float32."""
    return {n: rng.standard_normal(shape).astype(np.float32) for n in ("q", "k", "v", "ct")}


def attention_out_and_grads(fn, a: dict, device):
    """(out, the gradients (dq, dk, dv) of sum(out * ct)) through a training attention ``fn``
    (``attention_train``'s signature)."""
    q, k, v = (torch.from_numpy(a[n]).to(device).to(torch.bfloat16).requires_grad_(True) for n in ("q", "k", "v"))
    out = fn(q, k, v)
    loss = (out.float() * torch.from_numpy(a["ct"]).to(device)).sum()
    return out.detach(), torch.autograd.grad(loss, (q, k, v))


def convert_array(rng) -> np.ndarray:
    """K7's [12288, 3072] float32 weight (std 0.02) with CONVERT_SPECIAL first."""
    w = (rng.standard_normal(CONVERT_SHAPE, dtype=np.float32) * np.float32(0.02)).reshape(-1)
    w[: CONVERT_SPECIAL.size] = CONVERT_SPECIAL
    return w.reshape(CONVERT_SHAPE)


def kernel_selftest(device: torch.device, log: Optional[Callable[[str], None]] = None,
                    kernels: Optional[dict] = None) -> dict:
    """Every kernel against its plain version on ``device``. Returns {"ok": bool, "checks": {name: error},
    "tolerances": {name: tol}, "seconds": float}; an error is the metric of the module docstring (K7's and
    K4's rerun's: the share of elements whose bits differ).

    ``kernels``: substitutes for every entry of KERNELS (the harness's own tests pass the plain versions, or
    corrupted ones). Without them the kernels run, which needs a CUDA device: on any other device this raises
    rather than hold a plain version to itself, and it raises if a kernel's launch counter did not move. A
    kernel that does not build or launch raises too. TF32 is off for the run (the plain versions are the
    float32 references)."""
    if kernels is None:
        if device.type != "cuda":
            raise ValueError(f"kernel_selftest runs the CUDA kernels and needs a CUDA device, got {device}; "
                             "pass kernels= substitutes to check the harness itself")
        kernels = KERNELS
    elif set(kernels) != set(KERNELS):
        raise ValueError(f"kernels= must substitute exactly {sorted(KERNELS)}, got {sorted(kernels)}")
    t0 = time.perf_counter()
    rows = {row(r, case[6]) for case in TRAIN_CASES for r in ROWS[case[1]][1:]}
    rows |= {row(ROWS[case[1]][0], case[6]) for case in SAMPLE_CASES} | {"K3", "K3-lse", "K4", "K7"}
    rows |= {row(r, 0, torch.float32) for rows_ in ROWS.values() for r in rows_}
    rows |= {r + F128 for r in F128_COUNTERS}
    before = {r: launch_count(r) for r in rows}
    checks, tolerances = {}, {}

    def check(name: str, err: float, tol: float) -> None:
        checks[name], tolerances[name] = err, tol
        if log:
            log(f"  {name}: rel_err {err:.2e} (tol {tol:.0e}) {'ok' if err <= tol else 'FAIL'}")

    def exact(name: str, differ: float, what: str) -> None:
        checks[name], tolerances[name] = differ, 0.0
        if log:
            log(f"  {name}: a share of {differ:.2e} of the {what} (bit-equal needed) {'ok' if differ == 0 else 'FAIL'}")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        # The rows at a kernel's other mini-batches draw from generators of their own (the half slabs from a
        # third), so every other check's inputs are those it had before those rows were added.
        rng, wide_rng, half_rng = np.random.default_rng(0), np.random.default_rng(1), np.random.default_rng(2)
        f32_rng = np.random.default_rng(3)
        draw = lambda r, CS: half_rng if CS % 16 else wide_rng if "@" in row(r, CS) else rng
        shared = {}
        for name, variant, H, NC, nc, K, CS, factor in TRAIN_CASES:
            fwd_row, bwd_row = (row(r, CS) for r in ROWS[variant][1:])
            if (variant, 1, H, NC, CS) not in shared:
                shared[variant, 1, H, NC, CS] = ttt_arrays(draw(ROWS[variant][1], CS), variant, 1, H, NC, CS)
            a, eta = take(shared[variant, 1, H, NC, CS], nc), eta_scale(variant, CS, factor)
            loss_k, grads_k = ttt_loss_and_grads(kernels[f"{variant}_train"], a, variant, K, eta, device)
            loss_p, grads_p = ttt_loss_and_grads(PLAIN[f"{variant}_train"], a, variant, K, eta, device)
            check(f"{name} fwd [{fwd_row}]", rel_err(loss_k, loss_p), FWD_TOL)
            for g, w, what in zip(grads_k, grads_p, ("dq", "dk", "dv", "dgate")):
                check(f"{name} {what} [{bwd_row}]", rel_err(g, w), GRAD_TOL)
            check(f"{name} dstate [{bwd_row}]", max(rel_err(g, w) for g, w in zip(grads_k[4:], grads_p[4:])),
                  STATE_GRAD_TOL)
        for name, variant, B, H, NC, nc, CS in SAMPLE_CASES:
            if (variant, B, H, NC, CS) not in shared:
                shared[variant, B, H, NC, CS] = ttt_arrays(draw(ROWS[variant][0], CS), variant, B, H, NC, CS)
            args = _tensors(take(shared[variant, B, H, NC, CS], nc), variant, device, grad=False)
            eta = eta_scale(variant, CS)
            with torch.no_grad():
                got = kernels[f"{variant}_forward"](*args, eta).float()
                want = PLAIN[f"{variant}_forward"](*args, eta).float()
            check(f"{name} fwd [{row(ROWS[variant][0], CS)}]", rel_err((got**2).sum(), (want**2).sum()), FWD_TOL)
        # The float32 kernels, on draws of a generator of their own (every other check's inputs as before).
        for name, variant, H, NC, nc, K, CS, factor in F32_TRAIN_CASES:
            fwd_row, bwd_row = (row(r, CS, torch.float32) for r in ROWS[variant][1:])
            if ("f32", variant, 1, H, NC, CS) not in shared:
                shared["f32", variant, 1, H, NC, CS] = ttt_arrays(f32_rng, variant, 1, H, NC, CS)
            a, eta = take(shared["f32", variant, 1, H, NC, CS], nc), eta_scale(variant, CS, factor)
            f32 = dict(device=device, dtype=torch.float32, with_out=True)
            out_k, grads_k = ttt_loss_and_grads(kernels[f"{variant}_train"], a, variant, K, eta, **f32)
            out_p, grads_p = ttt_loss_and_grads(PLAIN[f"{variant}_train"], a, variant, K, eta, **f32)
            check(f"{name} fwd [{fwd_row}]", rel_err(out_k, out_p), F32_FWD_TOL)
            for g, w, what in zip(grads_k, grads_p, ("dq", "dk", "dv", "dgate")):
                check(f"{name} {what} [{bwd_row}]", rel_err(g, w), F32_GRAD_TOL)
            check(f"{name} dstate [{bwd_row}]", max(rel_err(g, w) for g, w in zip(grads_k[4:], grads_p[4:])),
                  F32_STATE_GRAD_TOL)
        for name, variant, B, H, NC, nc, CS in F32_SAMPLE_CASES:
            if ("f32", variant, B, H, NC, CS) not in shared:
                shared["f32", variant, B, H, NC, CS] = ttt_arrays(f32_rng, variant, B, H, NC, CS)
            args = _tensors(take(shared["f32", variant, B, H, NC, CS], nc), variant, device, grad=False,
                            dtype=torch.float32)
            eta = eta_scale(variant, CS)
            with torch.no_grad():
                got, want = kernels[f"{variant}_forward"](*args, eta), PLAIN[f"{variant}_forward"](*args, eta)
            check(f"{name} fwd [{row(ROWS[variant][0], CS, torch.float32)}]", rel_err(got, want), F32_FWD_TOL)

        # Head dim 128, on draws of a generator of its own (every other check's inputs as before).
        f128_rng = np.random.default_rng(4)
        for name, B, H, NC, nc, factor in F128_SAMPLE_CASES:
            if ("f128", B, H, NC) not in shared:
                shared["f128", B, H, NC] = ttt_arrays(f128_rng, "ttt_linear", B, H, NC, 16, F=128)
            args = _tensors(take(shared["f128", B, H, NC], nc), "ttt_linear", device, grad=False)
            eta = eta_scale("ttt_linear", 16, factor, F=128)
            with torch.no_grad():
                got = kernels["ttt_linear_forward"](*args, eta).float()
                want = PLAIN["ttt_linear_forward"](*args, eta).float()
            check(f"{name} fwd [K5{F128}]", rel_err((got**2).sum(), (want**2).sum()), FWD_TOL)
        q, k, v = (torch.from_numpy(f128_rng.standard_normal(F128_ATTENTION_SHAPE).astype(np.float32)).to(device)
                   .to(torch.bfloat16) for _ in range(3))
        with torch.no_grad():
            err = rel_err(kernels["attention"](q, k, v), PLAIN["attention"](q, k, v))
            lse_err = rel_err(kernels["attention_with_lse"](q, k, v)[1], PLAIN["attention_with_lse"](q, k, v)[1])
        check(f"splash folded-windows f128 fwd [K3{F128}]", err, ATTENTION_FWD_TOL)
        check(f"splash folded-windows f128 lse [K3-lse{F128}]", lse_err, LSE_TOL)
        for name, variant, H, NC, nc, K, CS, factor in F128_TRAIN_CASES:
            if ("f128 train", H, NC) not in shared:
                shared["f128 train", H, NC] = ttt_arrays(f128_rng, variant, 1, H, NC, CS, F=128)
            a, eta = take(shared["f128 train", H, NC], nc), eta_scale(variant, CS, factor, F=128)
            loss_k, grads_k = ttt_loss_and_grads(kernels[f"{variant}_train"], a, variant, K, eta, device)
            loss_p, grads_p = ttt_loss_and_grads(PLAIN[f"{variant}_train"], a, variant, K, eta, device)
            check(f"{name} fwd [K5-train{F128}]", rel_err(loss_k, loss_p), FWD_TOL)
            for g, w, what in zip(grads_k, grads_p, ("dq", "dk", "dv", "dgate")):
                check(f"{name} {what} [K6{F128}]", rel_err(g, w), GRAD_TOL)
            check(f"{name} dstate [K6{F128}]", max(rel_err(g, w) for g, w in zip(grads_k[4:], grads_p[4:])),
                  STATE_GRAD_TOL)
        a = attention_arrays(f128_rng, F128_ATTENTION_SHAPE)
        out_k, grads_k = attention_out_and_grads(kernels["attention_train"], a, device)
        out_p, grads_p = attention_out_and_grads(PLAIN["attention_train"], a, device)
        check(f"splash folded-windows f128 fwd-lse [K3-lse{F128}]", rel_err(out_k, out_p), ATTENTION_FWD_TOL)
        for g, w, what in zip(grads_k, grads_p, ("dq", "dk", "dv")):
            check(f"splash folded-windows f128 {what} [K4{F128}]", rel_err(g, w), ATTENTION_GRAD_TOL)
        again = attention_out_and_grads(kernels["attention_train"], a, device)[1]
        differ = bits_differ(torch.cat([g.reshape(-1) for g in grads_k]), torch.cat([g.reshape(-1) for g in again]))
        exact(F128_RERUN_CHECK, differ, "elements of dq, dk, dv differ between two launches")

        a = attention_arrays(rng)
        q, k, v = (torch.from_numpy(a[n]).to(device).to(torch.bfloat16) for n in ("q", "k", "v"))
        with torch.no_grad():
            err = rel_err(kernels["attention"](q, k, v), PLAIN["attention"](q, k, v))
        check("splash folded-windows fwd [K3]", err, ATTENTION_FWD_TOL)
        out_k, grads_k = attention_out_and_grads(kernels["attention_train"], a, device)
        out_p, grads_p = attention_out_and_grads(PLAIN["attention_train"], a, device)
        check("splash folded-windows fwd-lse [K3-lse]", rel_err(out_k, out_p), ATTENTION_FWD_TOL)
        for g, w, what in zip(grads_k, grads_p, ("dq", "dk", "dv")):
            check(f"splash folded-windows {what} [K4]", rel_err(g, w), ATTENTION_GRAD_TOL)
        again = attention_out_and_grads(kernels["attention_train"], a, device)[1]
        differ = bits_differ(torch.cat([g.reshape(-1) for g in grads_k]), torch.cat([g.reshape(-1) for g in again]))
        exact(RERUN_CHECK, differ, "elements of dq, dk, dv differ between two launches")

        w = torch.from_numpy(convert_array(rng)).to(device)
        with torch.no_grad():
            differ = bits_differ(kernels["convert_f32_bf16"](w), convert.convert_f32_bf16_plain(w))
        exact("convert bit-exact [K7]", differ, "elements differ from the plain cast")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if kernels is KERNELS:
        idle = sorted(r for r in rows if launch_count(r) == before[r])
        if idle:
            raise RuntimeError(f"kernel_selftest: no launch of {idle}: their wrappers took another path")
    ok = all(checks[n] <= tolerances[n] for n in checks)
    return {"ok": ok, "checks": checks, "tolerances": tolerances, "seconds": time.perf_counter() - t0}
