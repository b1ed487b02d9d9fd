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
  backward;
- the sampling scans (B 2, CS 16) at an even and an odd NC (K1's ring has two
  stages), and K7 bit for bit on a [12288, 3072] weight.

Every check's name ends with the kernel rows it drives, as PERF.md's table
names them ([K1] ... [K7]). The training checks go through the autograd
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
# their maximum). K7: bit-exact (the value is the share of elements whose bits differ).
FWD_TOL = 2e-4
GRAD_TOL = 2e-2
STATE_GRAD_TOL = 1e-2
ATTENTION_FWD_TOL = 2e-2
ATTENTION_GRAD_TOL = 3e-2

# The substitutes ``kernels=`` takes, each with the signature of the wrapper it stands in for, and the
# wrappers themselves (the kernel side by default).
KERNELS = {
    "ttt_mlp_forward": ttt_mlp_kernel.ttt_mlp_forward,  # K1
    "ttt_mlp_train": ttt_mlp_kernel.ttt_mlp_train,  # K1-train, K2
    "ttt_linear_forward": ttt_linear_kernel.ttt_linear_forward,  # K5
    "ttt_linear_train": ttt_linear_kernel.ttt_linear_train,  # K5-train, K6
    "attention": attention.attention,  # K3
    "attention_train": attention.attention_train,  # K3-lse, K4
    "convert_f32_bf16": convert.convert_f32_bf16,  # K7
}
PLAIN = {
    "ttt_mlp_forward": ttt_mlp_kernel.ttt_mlp_forward_plain,
    "ttt_mlp_train": lambda *a: ttt_mlp_kernel.ttt_mlp_train(*a, plain=True),
    "ttt_linear_forward": ttt_linear_kernel.ttt_linear_forward_plain,
    "ttt_linear_train": lambda *a: ttt_linear_kernel.ttt_linear_train(*a, plain=True),
    "attention": attention.attention_plain,
    "attention_train": lambda q, k, v: attention.attention_train(q, k, v, plain=True),
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
BASE_LR = {"ttt_mlp": 0.1, "ttt_linear": 1.0}  # the TOMLs' ttt_base_lr: eta = sigmoid(gate) x base / F / CS
STATE = {"ttt_mlp": ("W1", "b1", "W2", "b2"), "ttt_linear": ("W1", "b1")}
ROWS = {"ttt_mlp": ("K1", "K1-train", "K2"), "ttt_linear": ("K5", "K5-train", "K6")}  # sampling, forward, backward
# Training cases: name, variant, heads, NC of the shared arrays, NC this case takes, checkpoint group K, CS, eta
# as a multiple of the TOML's (the large ones: chip_smoke.py's LARGE_ETA_FACTOR, eta ~0.1 either way).
TRAIN_CASES = (
    ("ttt_mlp full", "ttt_mlp", 8, 5, 4, 4, 64, 1),
    ("ttt_mlp ragged", "ttt_mlp", 8, 5, 5, 4, 64, 1),
    ("ttt_mlp h12 g6", "ttt_mlp", 12, 9, 9, 8, 64, 1),
    ("ttt_mlp eta-gate", "ttt_mlp", 8, 5, 5, 4, 64, 4096),
    ("ttt_linear full", "ttt_linear", 8, 9, 8, 4, 16, 1),
    ("ttt_linear ragged", "ttt_linear", 8, 9, 9, 4, 16, 1),
    ("ttt_linear eta-gate", "ttt_linear", 8, 9, 9, 4, 16, 100),
)
# Sampling cases: name, variant, batch, heads, NC of the shared arrays, NC this case takes (CS 16).
SAMPLE_CASES = (
    ("ttt_mlp sampling full", "ttt_mlp", 2, 8, 9, 8),
    ("ttt_mlp sampling ragged", "ttt_mlp", 2, 8, 9, 9),
    ("ttt_linear sampling full", "ttt_linear", 2, 8, 9, 8),
    ("ttt_linear sampling ragged", "ttt_linear", 2, 8, 9, 9),
)
ATTENTION_SHAPE = (3, 417, 4, 64)  # 3 windows of a ragged 417 tokens, 4 heads
CONVERT_SHAPE = (12288, 3072)  # the MLP's layer2 weight, [out, in]
# K7's first elements: ties, subnormals, signed zeros, +-inf, NaN and values past the bf16 maximum.
CONVERT_SPECIAL = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 3.4e38, -3.39e38, 1e-40, -1e-45, 1.00390625,
                            1.01171875, -1.00390625, 3.0e-39], np.float32)


def rel_err(a, b) -> float:
    """max|a - b| / max|b| (the JAX self-test's metric), in float32."""
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).abs().max() / ((b.abs().max()) + 1e-8))


def ttt_arrays(rng, variant: str, B: int, H: int, NC: int, CS: int) -> dict:
    """Seeded inputs of a TTT scan (numpy float32): raw token-major q/k/v [B, NC, CS, H*F], gate logits
    [B, H, NC, CS], the rope tables [NC, CS, F] of an 8 x 8 grid after one text mini-batch (identity rows), the LN
    affine [H, F] and the variant's initial state, drawn as the JAX self-test draws them."""
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


def eta_scale(variant: str, CS: int, factor: float = 1) -> float:
    return factor * BASE_LR[variant] / F / CS


def _tensors(a: dict, variant: str, device, grad: bool) -> list:
    """The wrapper's leading arguments on ``device`` (q/k/v in bf16), leaves that take gradients with ``grad``."""
    names = ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b") + STATE[variant]
    out = []
    for n in names:
        t = torch.from_numpy(np.ascontiguousarray(a[n])).to(device)
        if n in ("XQ", "XK", "XV"):
            t = t.to(torch.bfloat16)
        out.append(t.requires_grad_(grad and not n.startswith("rope")))
    return out


def ttt_loss_and_grads(fn, a: dict, variant: str, K: int, eta: float, device):
    """loss = sum(fn(...)^2) in float32 through a training scan ``fn`` (the wrapper's signature), and the
    gradients of q, k, v, the gate, ln_w, ln_b and the initial state, in that order."""
    args = _tensors(a, variant, device, grad=True)
    out = fn(*args, eta, K)
    loss = (out.float() ** 2).sum()
    leaves = [t for t in args if t.requires_grad]
    return loss.detach(), torch.autograd.grad(loss, leaves)


def attention_arrays(rng) -> dict:
    """q/k/v (bf16 once on the card) and the output cotangent ct of the folded-window checks, numpy float32."""
    return {n: rng.standard_normal(ATTENTION_SHAPE).astype(np.float32) for n in ("q", "k", "v", "ct")}


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
    "tolerances": {name: tol}, "seconds": float}; an error is the metric of the module docstring (K7's: the
    share of elements whose bits differ).

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
    before = {row: getattr(mod, name) for row, (mod, name) in COUNTERS.items()}
    checks, tolerances = {}, {}

    def check(name: str, err: float, tol: float) -> None:
        checks[name], tolerances[name] = err, tol
        if log:
            log(f"  {name}: rel_err {err:.2e} (tol {tol:.0e}) {'ok' if err <= tol else 'FAIL'}")

    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        rng = np.random.default_rng(0)
        shared = {}
        for name, variant, H, NC, nc, K, CS, factor in TRAIN_CASES:
            _, fwd_row, bwd_row = ROWS[variant]
            if (variant, 1, H, NC, CS) not in shared:
                shared[variant, 1, H, NC, CS] = ttt_arrays(rng, variant, 1, H, NC, CS)
            a, eta = take(shared[variant, 1, H, NC, CS], nc), eta_scale(variant, CS, factor)
            loss_k, grads_k = ttt_loss_and_grads(kernels[f"{variant}_train"], a, variant, K, eta, device)
            loss_p, grads_p = ttt_loss_and_grads(PLAIN[f"{variant}_train"], a, variant, K, eta, device)
            check(f"{name} fwd [{fwd_row}]", rel_err(loss_k, loss_p), FWD_TOL)
            for g, w, what in zip(grads_k, grads_p, ("dq", "dk", "dv", "dgate")):
                check(f"{name} {what} [{bwd_row}]", rel_err(g, w), GRAD_TOL)
            check(f"{name} dstate [{bwd_row}]", max(rel_err(g, w) for g, w in zip(grads_k[4:], grads_p[4:])),
                  STATE_GRAD_TOL)
        for name, variant, B, H, NC, nc in SAMPLE_CASES:
            if (variant, B, H, NC, 16) not in shared:
                shared[variant, B, H, NC, 16] = ttt_arrays(rng, variant, B, H, NC, 16)
            args = _tensors(take(shared[variant, B, H, NC, 16], nc), variant, device, grad=False)
            eta = eta_scale(variant, 16)
            with torch.no_grad():
                got = kernels[f"{variant}_forward"](*args, eta).float()
                want = PLAIN[f"{variant}_forward"](*args, eta).float()
            check(f"{name} fwd [{ROWS[variant][0]}]", rel_err((got**2).sum(), (want**2).sum()), FWD_TOL)

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

        w = torch.from_numpy(convert_array(rng)).to(device)
        with torch.no_grad():
            got, want = kernels["convert_f32_bf16"](w), convert.convert_f32_bf16_plain(w)
            differ = int((got.view(torch.int16) != want.view(torch.int16)).sum()) / w.numel()
        checks["convert bit-exact [K7]"], tolerances["convert bit-exact [K7]"] = differ, 0.0
        if log:
            log(f"  convert bit-exact [K7]: {differ:.2e} of {w.numel()} elements differ (bit-exact needed) "
                f"{'ok' if differ == 0.0 else 'FAIL'}")
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    if kernels is KERNELS:
        idle = [row for row, (mod, name) in COUNTERS.items() if getattr(mod, name) == before[row]]
        if idle:
            raise RuntimeError(f"kernel_selftest: no launch of {idle}: their wrappers took another path")
    ok = all(checks[n] <= tolerances[n] for n in checks)
    return {"ok": ok, "checks": checks, "tolerances": tolerances, "seconds": time.perf_counter() - t0}
