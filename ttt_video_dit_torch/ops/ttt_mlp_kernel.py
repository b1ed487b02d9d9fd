"""Fused TTT-MLP scan: the CUDA kernels' wrappers, their plain versions, and
the autograd Function that trains through them.

Port of ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_mlp_kernel (K1, with
_fused_preproc and _eta_from_gate) and ops/pallas/ttt_backward.py:
_mlp_bwd_kernel (K2), in the fused-preprocessing, token-major,
in-kernel-gate form that ttt_vjp.py:ttt_mlp_fused_pre dispatches. Kernels:

- ``ttt_mlp_forward``: K1 for sampling (no state checkpoints),
  ``csrc/ttt_mlp_forward.cu:ttt_mlp_forward``: at CS = 16 its own kernel,
  at every other CS the training kernel with no checkpoints;
- ``ttt_mlp_forward_train``: K1 for training, which also writes the fp32
  state at the start of every group of K mini-batches (the last group may be
  ragged), ``csrc/ttt_mlp_forward.cu:ttt_mlp_forward_train``;
- ``ttt_mlp_backward``: K2, K1's VJP from those checkpoints,
  ``csrc/ttt_mlp_backward.cu``;
- ``TTTMLPFunction``: K1-train forward, K2 backward.

All three kernels take head_dim F = 64 and the mini-batches CS in
KERNEL_MINI_BATCHES, every multiple of 8 from 8 to 64: K1-train and K2 are
one template on the ceil(CS / 16) slabs of 16 tokens of
``csrc/ttt_mlp_train_step.cuh``, the last of which is a masked half slab
when CS is not a multiple of 16.

q/k/v may be bf16 or float32 (KERNEL_DTYPES), as the JAX kernels take any
float dtype and compute in it: bf16 launches the kernels above, float32
their float32 counterparts, which round nothing to bf16
(``csrc/ttt_mlp_forward_f32.cu`` for K1 and K1-train, one kernel with K = 0
for sampling, and ``csrc/ttt_mlp_backward_f32.cu`` for K2; counted in
``f32_launches_by_cs``).

Which scans the model sends to the kernels: ``routes_to_plain`` holds the
JAX package's shape test (``is_supported``: CS and F multiples of 8), and
``use_plain`` is the layer's route, counting in ``plain_routes`` the scans
on the card that the route sends to the plain versions.

Inputs are the RAW token-major projections and the pre-sigmoid LR-gate
logits; the scan applies L2-norm + rope to q/k, builds the
LN-reconstruction target from v - k, and scales eta = sigmoid(gate) *
eta_scale itself.

Shapes: XQ/XK/XV [B, NC, CS, H*F] (head h = columns h*F..(h+1)*F); gate
[B, H, NC, CS]; rope_cos/rope_sin [NC, CS, F] float32 (interleaved, identity
rows on text slots); ln_w/ln_b [H, F]; W1 [H, F, 4F], b1 [H, 1, 4F],
W2 [H, 4F, F], b2 [H, 1, F] (the learned initial state, shared by every
batch element). Outputs [B, NC, CS, H*F] in XQ's dtype. State checkpoints
are compact fp32: W1 [B, H, NG, F, 4F], b1 [B, H, NG, 1, 4F], W2
[B, H, NG, 4F, F], b2 [B, H, NG, 1, F], NG = ceil(NC / K).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ttt_video_dit_torch.ops import _build
from ttt_video_dit_torch.ops import ln as ln_ops
from ttt_video_dit_torch.ops.ln import gelu_bwd, gelu_tanh
from ttt_video_dit_torch.ops.rope import pair_swap
from ttt_video_dit_torch.ops.ttt_scan import scan_mini_batches, ttt_mlp_step
from ttt_video_dit_torch.parallel.sharded import refuse_dtensors

# Launches of each CUDA kernel (the plain versions do not count): K1 for
# sampling, K1 for training, K2 on bf16 q/k/v; and each by mini-batch,
# launches_by_cs[counter name, CS]. The float32 kernels' launches by the same
# keys: f32_launches_by_cs["launches" | "train_launches" | "bwd_launches", CS].
# plain_routes: the scans on a CUDA device that use_plain sent to the plain
# versions (a CS or F the JAX package does not give its kernel).
launches = 0
train_launches = 0
bwd_launches = 0
launches_by_cs = collections.Counter()
f32_launches_by_cs = collections.Counter()
plain_routes = 0

KERNEL_HEAD_DIM = 64
KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # q/k/v: the bf16 kernels, or the float32 ones
# The mini-batch sizes K1, K1-train and K2 take: csrc/ttt_mlp_forward.cu:ttt_mlp_forward's cases and
# csrc/ttt_mlp_block.cuh:with_slabs's (a test holds the three together).
KERNEL_MINI_BATCHES = (8, 16, 24, 32, 40, 48, 56, 64)


# ------------------------------------------------------------ plain versions


def _l2norm(x, eps: float = 1e-12):
    """torch F.normalize parity: x / max(||x||_2, eps) over the last dim."""
    return x / torch.clamp(torch.sqrt((x * x).sum(dim=-1, keepdim=True)), min=eps)


def _rope(x, cos, sin):
    """Interleaved-pair rotation with lane-duplicated [CS, F] tables: x*cos + (x@R)*sin."""
    return x * cos + pair_swap(x) * sin


def _target_ln(t, lnw, lnb, eps: float = 1e-8):
    """LN-reconstruction normalization, unbiased std with eps added to the
    std: (target, t_hat, s) with s = sqrt(var) + eps."""
    n = t.shape[-1]
    mu = t.mean(dim=-1, keepdim=True)
    var = t.var(dim=-1, keepdim=True, correction=0) * (n / max(n - 1, 1))
    s = torch.sqrt(var) + eps
    t_hat = (t - mu) / s
    return lnw * t_hat + lnb, t_hat, s


def _acc_dtype(dt):
    """The dtype the plain versions compute in: float64 for float64 inputs
    (the autograd checks), else float32."""
    return torch.promote_types(dt, torch.float32)


def _to_head_major(x, H, F):
    """token-major [B, NC, CS, H*F] -> [NC, B, H, CS, F] in the accumulation dtype."""
    B, NC, CS, _ = x.shape
    return x.reshape(B, NC, CS, H, F).permute(1, 0, 3, 2, 4).to(_acc_dtype(x.dtype))


def _to_token_major(x):
    """[NC, B, H, CS, F] -> token-major [B, NC, CS, H*F]."""
    NC, B, H, CS, F = x.shape
    return x.permute(1, 0, 3, 2, 4).reshape(B, NC, CS, H * F)


def _preproc(xq_raw, xk_raw, xv_raw, cos, sin, lnw, lnb):
    """The fused preprocessing of one mini-batch (float32): (XQ, XK, target,
    t_hat, s) from the raw projections."""
    XQ = _rope(_l2norm(xq_raw), cos, sin)
    XK = _rope(_l2norm(xk_raw), cos, sin)
    target, t_hat, s = _target_ln(xv_raw - XK, lnw, lnb)
    return XQ, XK, target, t_hat, s


def scan_forward_plain(step_fn, state, XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, eta_scale: float,
                       checkpoint_group: int | None = None):
    """The per-step loop of the fused forward kernels in PyTorch: the fused
    preprocessing, then ``step_fn`` (``ttt_scan.ttt_mlp_step`` or
    ``ttt_linear_step``) rounding to XQ's dtype at the kernel's points
    (XQ/XK after preprocessing, and the step's own); products of the rounded
    operands accumulate in float32. ``state`` is the initial state's
    parameters, shared by the batch. Float32 matmuls must not use TF32 for
    the kernel comparison (see chip_smoke.py).

    With ``checkpoint_group`` K, also returns the fp32 state at the start of
    every group of K mini-batches: (out, *state checkpoints), each
    [B, H, NG, ...]."""
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    dt, acc = XQ.dtype, _acc_dtype(XQ.dtype)
    rnd = lambda x: x.to(dt).to(acc)
    xq, xk, xv = (_to_head_major(x, H, F) for x in (XQ, XK, XV))
    eta = (torch.sigmoid(gate.to(acc)) * eta_scale).permute(2, 0, 1, 3)  # [NC, B, H, CS]
    cos, sin = rope_cos.to(acc), rope_sin.to(acc)
    lnw = ln_w.to(acc)[None, :, None, :]
    lnb = ln_b.to(acc)[None, :, None, :]
    state = tuple(p.to(acc).expand(B, *p.shape) for p in state)

    def step(state, n):
        XQf, XKf, target, _, _ = _preproc(xq[n], xk[n], xv[n], cos[n], sin[n], lnw, lnb)
        state, XQW = step_fn(state, rnd(XQf), rnd(XKf), target, eta[n], lnw, lnb, rnd)
        return state, XQW.to(dt)

    _, outs, ckpts = scan_mini_batches(step, state, NC, checkpoint_group)
    out = _to_token_major(torch.stack(outs))
    if not checkpoint_group:
        return out
    return (out, *(torch.stack([c[i] for c in ckpts], dim=2).contiguous() for i in range(len(state))))


def ttt_mlp_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale: float,
                          checkpoint_group: int | None = None):
    """K1's plain version (:func:`scan_forward_plain` over
    ``ttt_scan.ttt_mlp_step``): the output, and with ``checkpoint_group``
    (out, W1_ck, b1_ck, W2_ck, b2_ck)."""
    return scan_forward_plain(ttt_mlp_step, (W1, b1, W2, b2), XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b,
                              eta_scale, checkpoint_group)


def ttt_mlp_backward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck, b2_ck, dout,
                           eta_scale: float, checkpoint_group: int):
    """K2's algorithm in PyTorch, rounding to XQ's dtype where
    _mlp_bwd_kernel does. Per checkpoint group, last first: pass A re-runs
    the forward from the group's checkpoint and stashes each step's state
    (W in the compute dtype, which is exact: pass B uses W only rounded);
    pass B walks the group backwards through the hand-derived step VJP
    (ttt_backward.py:270-414) and carries the state cotangents.

    Returns (dXQ, dXK, dXV [B, NC, CS, H*F] in XQ's dtype, d_gate
    [B, H, NC, CS] in float32 (float64 for float64 inputs), dW1 [H, F, 4F], db1 [H, 1, 4F], dW2 [H, 4F, F],
    db2 [H, 1, F], dln_w [H, F], dln_b [H, F]): the initial-state and LN
    cotangents summed over the batch, as the shared parameters need them."""
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    K = checkpoint_group
    NG = W1_ck.shape[2]
    dt, acc = XQ.dtype, _acc_dtype(XQ.dtype)
    rnd = lambda x: x.to(dt).to(acc)
    colsum = lambda x: x.sum(dim=-2, keepdim=True)
    mm = torch.matmul
    tr = lambda x: x.transpose(-1, -2)
    xq, xk, xv, g_out = (_to_head_major(x, H, F) for x in (XQ, XK, XV, dout))
    sig = torch.sigmoid(gate.to(acc)).permute(2, 0, 1, 3)[..., None]  # [NC, B, H, CS, 1]
    eta = sig * eta_scale
    cos, sin = rope_cos.to(acc), rope_sin.to(acc)
    lnw = ln_w.to(acc)[None, :, None, :]
    lnb = ln_b.to(acc)[None, :, None, :]

    dxq, dxk, dxv = (torch.empty(NC, B, H, CS, F, dtype=dt, device=XQ.device) for _ in range(3))
    zeros = lambda *s: torch.zeros(*s, dtype=acc, device=XQ.device)
    dgate = zeros(NC, B, H, CS)
    dW1, db1, dW2, db2 = zeros(B, H, F, 4 * F), zeros(B, H, 1, 4 * F), zeros(B, H, 4 * F, F), zeros(B, H, 1, F)
    dlnw, dlnb = zeros(B, H, 1, F), zeros(B, H, 1, F)

    def forward_step(state, n):
        XQf, XKf, target, _, _ = _preproc(xq[n], xk[n], xv[n], cos[n], sin[n], lnw, lnb)
        return ttt_mlp_step(state, rnd(XQf), rnd(XKf), target, eta[n][..., 0], lnw, lnb, rnd)[0], None

    for g in reversed(range(NG)):
        n0 = g * K
        # Pass A: the forward from the checkpoint, stashing the state before each step.
        state = tuple(c[:, :, g].to(acc) for c in (W1_ck, b1_ck, W2_ck, b2_ck))
        _, _, stash = scan_mini_batches(lambda s, i: forward_step(s, n0 + i), state, min(K, NC - n0), 1)
        # Pass B: the step VJP, last step first.
        for i in reversed(range(len(stash))):
            n, (W1, b1, W2, b2) = n0 + i, stash[i]
            W1, W2 = rnd(W1), rnd(W2)
            XQf, XKf, target, t_hat, s_t = _preproc(xq[n], xk[n], xv[n], cos[n], sin[n], lnw, lnb)
            XQ_, XK_ = rnd(XQf), rnd(XKf)
            e = eta[n]
            d_out = g_out[n]
            # Recompute the step's forward intermediates.
            Z1 = mm(XK_, W1) + b1
            phi = gelu_bwd(Z1)
            X2c = rnd(gelu_tanh(Z1))
            Z2 = mm(X2c, W2) + b2
            z2_hat, std2 = ln_ops.ln_stats(Z2)
            g2 = ln_ops.ln_fused_l2(z2_hat, std2, target, lnw, lnb)
            P = mm(rnd(g2), tr(W2))
            g1 = P * phi
            G1, G2 = rnd(e * g1), rnd(e * g2)
            A1 = rnd(mm(XQ_, tr(XK_)))
            Zb1 = mm(XQ_, W1) - mm(A1, G1) + b1 - colsum(G1)
            Xb2c = rnd(gelu_tanh(Zb1))
            A2 = rnd(mm(Xb2c, tr(X2c)))
            Zb2 = mm(Xb2c, W2) - mm(A2, G2) + b2 - colsum(G2)
            zb2_hat, stdb2 = ln_ops.ln_stats(Zb2)

            # (1) out = XQ + LN(Zb2)
            dZb2, dgw, dgb = ln_ops.ln_fwd_vjp_rows(zb2_hat, stdb2, lnw, d_out)
            dlnw += colsum(dgw)
            dlnb += colsum(dgb)
            dZb2c = rnd(dZb2)
            # (2) Zb2 = Xb2 @ W2 - A2 @ G2 + b2'
            dXb2 = mm(dZb2c, tr(W2))
            dW2_step = mm(tr(Xb2c), dZb2c)
            dA2 = -mm(dZb2c, tr(G2))
            db2_tot = db2 + colsum(dZb2)
            dG2 = -mm(tr(A2), dZb2c) - db2_tot
            # (3) A2 = Xb2 @ X2^T
            dXb2 = dXb2 + mm(rnd(dA2), X2c)
            dX2 = mm(tr(rnd(dA2)), Xb2c)
            # (4) Xb2 = gelu(Zb1)
            dZb1 = gelu_bwd(Zb1) * dXb2
            dZb1c = rnd(dZb1)
            # (5) Zb1 = XQ @ W1 - A1 @ G1 + b1'
            dXQ = d_out + mm(dZb1c, tr(W1))
            dW1_step = mm(tr(XQ_), dZb1c)
            dA1 = -mm(dZb1c, tr(G1))
            db1_tot = db1 + colsum(dZb1)
            dG1 = -mm(tr(A1), dZb1c) - db1_tot
            # (6) the state updates W' = W - X^T G (the carries are dW')
            dX2 = dX2 - mm(G2, tr(rnd(dW2)))
            dG2 = dG2 - mm(X2c, rnd(dW2))
            dXK = -mm(G1, tr(rnd(dW1)))
            dG1 = dG1 - mm(XK_, rnd(dW1))
            # (7) A1 = XQ @ XK^T
            dXQ = dXQ + mm(rnd(dA1), XK_)
            dXK = dXK + mm(tr(rnd(dA1)), XQ_)
            # (8) G = eta * g
            de = (dG2 * g2).sum(dim=-1, keepdim=True) + (dG1 * g1).sum(dim=-1, keepdim=True)
            dg2, dg1 = e * dG2, e * dG1
            # (9) g1 = (g2 @ W2^T) * gelu'(Z1)
            dP = dg1 * phi
            dZ1 = dg1 * P * ln_ops.gelu_bwd2(Z1)
            dPc = rnd(dP)
            dg2 = dg2 + mm(dPc, W2)
            dW2_step = dW2_step + mm(tr(dPc), rnd(g2))
            # (10) g2 = ln_fused_l2(Z2, target)
            dZ2, dtarget, dgw2, dgb2 = ln_ops.ln_fused_l2_vjp_rows(z2_hat, std2, target, lnw, lnb, dg2)
            dlnw += colsum(dgw2)
            dlnb += colsum(dgb2)
            # (11) Z2 = X2 @ W2 + b2
            dZ2c = rnd(dZ2)
            dX2 = dX2 + mm(dZ2c, tr(W2))
            dW2_step = dW2_step + mm(tr(X2c), dZ2c)
            db2_new = db2_tot + colsum(dZ2)
            # (12) target = LN-reconstruction(XV - XK)
            dtv, dgw_t, dgb_t = ln_ops.target_ln_vjp(t_hat, s_t, lnw, dtarget)
            dlnw += colsum(dgw_t)
            dlnb += colsum(dgb_t)
            dXK = dXK - dtv
            # (13) X2 = gelu(Z1)
            dZ1 = dZ1 + phi * dX2
            dZ1c = rnd(dZ1)
            # (14) Z1 = XK @ W1 + b1
            dXK = dXK + mm(dZ1c, tr(W1))
            dW1_step = dW1_step + mm(tr(XK_), dZ1c)
            db1_new = db1_tot + colsum(dZ1)
            # (15) rope, then the L2 norm, back to the raw projections
            dxq[n] = ln_ops.l2norm_vjp(xq[n], ln_ops.rope_vjp(dXQ, cos[n], sin[n])).to(dt)
            dxk[n] = ln_ops.l2norm_vjp(xk[n], ln_ops.rope_vjp(dXK, cos[n], sin[n])).to(dt)
            dxv[n] = dtv.to(dt)
            dgate[n] = (de * e * (1.0 - sig[n]))[..., 0]
            dW1, db1, dW2, db2 = dW1 + dW1_step, db1_new, dW2 + dW2_step, db2_new

    sum_b = lambda x: x.sum(dim=0)
    return (_to_token_major(dxq), _to_token_major(dxk), _to_token_major(dxv), dgate.permute(1, 2, 0, 3).contiguous(),
            sum_b(dW1), sum_b(db1), sum_b(dW2), sum_b(db2), sum_b(dlnw)[:, 0], sum_b(dlnb)[:, 0])


# ------------------------------------------------------------ the route


def routes_to_plain(CS: int, F: int) -> bool:
    """Whether a scan of mini-batch CS and head dim F goes to the plain
    versions rather than the kernels: where the JAX package's shape test
    fails (ttt_video_dit_tpu/ops/pallas/ttt_mlp_kernel.py:is_supported, and
    ttt_linear_kernel.py's: CS % 8 == 0 and F % 8 == 0) and its layer runs
    the ttt_scan oracle instead (models/ttt/layer.py:_ttt_mlp, _ttt_linear).
    A shape that passes it but that the port's kernels do not take yet (F not
    64, CS above 64) still goes to the kernels, which raise naming the
    shapes they take."""
    return CS % 8 != 0 or F % 8 != 0


def use_plain(use_kernel: bool, CS: int, F: int, device: torch.device) -> bool:
    """The model's route for a scan: the plain versions with ``use_kernel``
    off or where :func:`routes_to_plain` holds, else the kernels. A scan on a
    CUDA device sent to the plain versions by the route (not by
    ``use_kernel``) counts in ``plain_routes``."""
    global plain_routes
    if not use_kernel:
        return True
    if not routes_to_plain(CS, F):
        return False
    if device.type == "cuda":
        plain_routes += 1
    return True


# ------------------------------------------------------------ CUDA kernels


def _lib(name: str = "ttt_mlp_forward"):
    lib = _build.load(name)
    if name == "ttt_mlp_forward" and lib.ttt_mlp_forward.argtypes is None:
        lib.ttt_mlp_forward.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        lib.ttt_mlp_forward.restype = ctypes.c_int
        lib.ttt_mlp_forward_smem_bytes.argtypes = [ctypes.c_int]
        lib.ttt_mlp_forward_smem_bytes.restype = ctypes.c_int
        lib.ttt_mlp_forward_train.argtypes = ([ctypes.c_void_p] * 18 + [ctypes.c_int] * 5
                                              + [ctypes.c_float, ctypes.c_void_p])
        lib.ttt_mlp_forward_train.restype = ctypes.c_int
        lib.ttt_mlp_forward_train_smem_bytes.argtypes = [ctypes.c_int]
        lib.ttt_mlp_forward_train_smem_bytes.restype = ctypes.c_int
        lib.ttt_mlp_forward_train_workspace_floats.argtypes = [ctypes.c_int]
        lib.ttt_mlp_forward_train_workspace_floats.restype = ctypes.c_longlong
    if name == "ttt_mlp_backward" and lib.ttt_mlp_backward.argtypes is None:
        lib.ttt_mlp_backward.argtypes = [ctypes.c_void_p] * 24 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
        lib.ttt_mlp_backward.restype = ctypes.c_int
        lib.ttt_mlp_backward_smem_bytes.argtypes = [ctypes.c_int]
        lib.ttt_mlp_backward_smem_bytes.restype = ctypes.c_int
        lib.ttt_mlp_backward_workspace_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ttt_mlp_backward_workspace_bytes.restype = ctypes.c_longlong
    if name in F32_LIBS and getattr(lib, name).argtypes is None:
        _f32_argtypes(lib, name, *F32_LIBS[name])
    return lib


# The float32 libraries: pointer arguments of the C entry, and the arguments of its workspace size (CS, or CS and K).
F32_LIBS = {"ttt_mlp_forward_f32": (18, 1), "ttt_mlp_backward_f32": (24, 2)}


def _f32_argtypes(lib, name: str, pointers: int, work_args: int) -> None:
    """ctypes signatures of a float32 library: ``name``(pointers, B, NC, H, CS, K, eta_scale, stream),
    ``name``_smem_bytes(CS) and ``name``_workspace_floats(CS[, K])."""
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * pointers + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    work = getattr(lib, f"{name}_workspace_floats")
    work.argtypes, work.restype = [ctypes.c_int] * work_args, ctypes.c_longlong


def check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2) -> None:
    """Raise ValueError unless the arguments are what the CUDA kernels take:
    F = 64, CS in KERNEL_MINI_BATCHES (a multiple of 8 up to 64, for
    sampling and training alike), token-major q/k/v all bf16 or all float32
    (KERNEL_DTYPES), float32 everything else, every tensor contiguous and on
    one CUDA device, shapes consistent."""
    if XQ.ndim != 4:
        raise ValueError(f"XQ must be token-major [B, NC, CS, H*F], got {tuple(XQ.shape)}")
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    if F != KERNEL_HEAD_DIM or CS not in KERNEL_MINI_BATCHES:
        raise ValueError(f"the TTT-MLP kernels support F={KERNEL_HEAD_DIM} and CS in {KERNEL_MINI_BATCHES}; "
                         f"got F={F}, CS={CS}")
    dt = qkv_dtype(XQ, XK, XV)
    expected = {
        "XQ": (XQ, (B, NC, CS, H * F), dt), "XK": (XK, (B, NC, CS, H * F), dt),
        "XV": (XV, (B, NC, CS, H * F), dt), "gate": (gate, (B, H, NC, CS), torch.float32),
        "rope_cos": (rope_cos, (NC, CS, F), torch.float32), "rope_sin": (rope_sin, (NC, CS, F), torch.float32),
        "ln_w": (ln_w, (H, F), torch.float32), "ln_b": (ln_b, (H, F), torch.float32),
    }
    if W1 is not None:
        expected.update({
            "W1": (W1, (H, F, 4 * F), torch.float32), "b1": (b1, (H, 1, 4 * F), torch.float32),
            "W2": (W2, (H, 4 * F, F), torch.float32), "b2": (b2, (H, 1, F), torch.float32),
        })
    _check_tensors(expected, XQ.device)


def qkv_dtype(XQ, XK, XV) -> torch.dtype:
    """The dtype of q/k/v, one of KERNEL_DTYPES for all three; raise ValueError otherwise."""
    if XQ.dtype not in KERNEL_DTYPES or XK.dtype != XQ.dtype or XV.dtype != XQ.dtype:
        raise ValueError(f"XQ, XK, XV: the kernels take all bfloat16 or all float32, got {XQ.dtype}, {XK.dtype}, "
                         f"{XV.dtype}")
    return XQ.dtype


ALIGNMENT = 16  # bytes: the TTT kernels copy 16-byte chunks (cp.async) and read 8-byte vectors


def check_aligned(name: str, t) -> None:
    """Raise ValueError unless ``t``'s data starts on a 16-byte boundary (a
    contiguous view at an odd offset would fault the kernel, not raise)."""
    if t.data_ptr() % ALIGNMENT:
        raise ValueError(f"{name} must start on a {ALIGNMENT}-byte boundary (data_ptr {t.data_ptr():#x})")


def _check_tensors(expected, device) -> None:
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device.type != "cuda" or t.device != device:
            raise ValueError(f"{name}: expected a tensor on {device} (CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        check_aligned(name, t)


_smem_checked: set = set()


def check_smem(lib, fn_name: str, cs: int, device) -> None:
    """Raise RuntimeError if the kernel that C entry ``fn_name`` launches at
    mini-batch ``cs`` needs more shared memory (``<fn_name>_smem_bytes(cs)``)
    than ``device`` lets a block opt in to; checked at the first launch of
    each (entry, CS, device)."""
    key = (fn_name, cs, device)
    if key in _smem_checked:
        return
    need = getattr(lib, f"{fn_name}_smem_bytes")(cs)
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if not 0 < need <= limit:
        raise RuntimeError(f"{fn_name} at CS={cs} needs {need} bytes of shared memory a block; {device} allows {limit}")
    _smem_checked.add(key)


def _launch(lib, fn_name: str, tensors, ints, eta_scale: float, device) -> None:
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, fn_name)(*(t.data_ptr() for t in tensors), *ints, float(eta_scale), stream)
    _build.check(lib, err, f"{fn_name} launch")


def ttt_mlp_forward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale: float):
    """Fused TTT-MLP forward for sampling (no checkpoints). CPU tensors take
    the plain version; CUDA tensors launch the kernel of their q/k/v dtype
    (or raise on arguments it does not take)."""
    global launches
    refuse_dtensors("ttt_mlp_forward", XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2)
    if XQ.device.type == "cpu":
        return ttt_mlp_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale)
    args = (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2)
    check_kernel_args(*args)
    B, NC, CS, _ = XQ.shape
    if XQ.dtype == torch.float32:
        return _forward_f32(*args, eta_scale, 0)[0]
    H = ln_w.shape[0]
    lib = _lib()
    check_smem(lib, "ttt_mlp_forward", CS, XQ.device)
    out = torch.empty_like(XQ)
    # Past CS = 16 the training kernel's LN targets go through a workspace (the CS-16 kernel takes none).
    floats = B * H * lib.ttt_mlp_forward_train_workspace_floats(CS) if CS != 16 else 4
    work = torch.empty(floats, dtype=torch.float32, device=XQ.device)
    _launch(lib, "ttt_mlp_forward", (*args, out, work), (B, NC, H, CS), eta_scale, XQ.device)
    launches += 1
    launches_by_cs["launches", CS] += 1
    return out


def _forward_f32(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale, K):
    """Launch the float32 K1 (K = 0: sampling, no checkpoints) or K1-train on checked arguments; counts the
    launch. Returns (out, W1_ck, b1_ck, W2_ck, b2_ck)."""
    B, NC, CS, _ = XQ.shape
    H, F = ln_w.shape
    NG = -(-NC // K) if K else 0
    lib = _lib("ttt_mlp_forward_f32")
    check_smem(lib, "ttt_mlp_forward_f32", CS, XQ.device)
    out = torch.empty_like(XQ)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=XQ.device)
    ckpts = (new(B, H, NG, F, 4 * F), new(B, H, NG, 1, 4 * F), new(B, H, NG, 4 * F, F), new(B, H, NG, 1, F))
    work = new(B * H * lib.ttt_mlp_forward_f32_workspace_floats(CS))
    _launch(lib, "ttt_mlp_forward_f32",
            (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, out, *ckpts, work),
            (B, NC, H, CS, K), eta_scale, XQ.device)
    f32_launches_by_cs["train_launches" if K else "launches", CS] += 1
    return (out, *ckpts)


@torch.library.custom_op(
    "ttt_video_dit_torch::ttt_mlp_forward_train", mutates_args=(),
    schema="(Tensor XQ, Tensor XK, Tensor XV, Tensor gate, Tensor rope_cos, Tensor rope_sin, Tensor ln_w, "
           "Tensor ln_b, Tensor W1, Tensor b1, Tensor W2, Tensor b2, float eta_scale, int checkpoint_group) "
           "-> (Tensor, Tensor, Tensor, Tensor, Tensor)")
def ttt_mlp_forward_train(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale,
                          checkpoint_group):
    """Fused TTT-MLP forward for training: (out, W1_ck, b1_ck, W2_ck, b2_ck),
    the fp32 state at the start of every group of ``checkpoint_group``
    mini-batches. A custom op (so a selective-checkpoint policy can name it,
    models/dit/dit.py), whatever the dtype: on CUDA tensors it launches the
    kernel of the q/k/v dtype or raises; on CPU tensors it runs the plain
    version."""
    global train_launches
    check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2)
    B, NC, CS, _ = XQ.shape
    H, F = ln_w.shape
    K = _group(checkpoint_group, NC)
    if XQ.dtype == torch.float32:
        return _forward_f32(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale, K)
    NG = -(-NC // K)
    lib = _lib()
    check_smem(lib, "ttt_mlp_forward_train", CS, XQ.device)
    out = torch.empty_like(XQ)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=XQ.device)
    ckpts = (new(B, H, NG, F, 4 * F), new(B, H, NG, 1, 4 * F), new(B, H, NG, 4 * F, F), new(B, H, NG, 1, F))
    work = new(B * H * lib.ttt_mlp_forward_train_workspace_floats(CS))
    _launch(lib, "ttt_mlp_forward_train",
            (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, out, *ckpts, work),
            (B, NC, H, CS, K), eta_scale, XQ.device)
    train_launches += 1
    launches_by_cs["train_launches", CS] += 1
    return (out, *ckpts)


@ttt_mlp_forward_train.register_fake
def _(XQ, *args):
    """Tensors with no data (meta) cannot launch the kernel: refuse them, as the argument checks do."""
    raise ValueError(f"ttt_mlp_forward_train takes CUDA tensors (the kernel) or CPU tensors (the plain version), "
                     f"got {XQ.device}")


@ttt_mlp_forward_train.register_kernel("cpu")
def _(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale, checkpoint_group):
    return ttt_mlp_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale,
                                 checkpoint_group=checkpoint_group)


def ttt_mlp_backward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck, b2_ck, dout,
                     eta_scale: float, checkpoint_group: int):
    """K2, the fused TTT-MLP backward from K1-train's checkpoints and the
    output cotangent ``dout`` (in q/k/v's dtype). Returns what
    :func:`ttt_mlp_backward_plain` returns. CPU tensors take the plain
    version; CUDA tensors launch the kernel of their q/k/v dtype or raise."""
    global bwd_launches
    refuse_dtensors("ttt_mlp_backward", XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck,
                    b2_ck, dout)
    if XQ.device.type == "cpu":
        return ttt_mlp_backward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck, b2_ck,
                                      dout, eta_scale, checkpoint_group)
    check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, None, None, None, None)
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    K = _group(checkpoint_group, NC)
    NG = -(-NC // K)
    _check_tensors({
        "W1_ck": (W1_ck, (B, H, NG, F, 4 * F), torch.float32), "b1_ck": (b1_ck, (B, H, NG, 1, 4 * F), torch.float32),
        "W2_ck": (W2_ck, (B, H, NG, 4 * F, F), torch.float32), "b2_ck": (b2_ck, (B, H, NG, 1, F), torch.float32),
        "dout": (dout, (B, NC, CS, HF), XQ.dtype),
    }, XQ.device)
    if XQ.dtype == torch.float32:
        return _backward_f32(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck, b2_ck, dout,
                             eta_scale, K)
    lib = _lib("ttt_mlp_backward")
    check_smem(lib, "ttt_mlp_backward", CS, XQ.device)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=XQ.device)
    dx = [torch.empty_like(XQ) for _ in range(3)]
    dgate = new(B, H, NC, CS)
    grads = (new(B, H, F, 4 * F), new(B, H, 1, 4 * F), new(B, H, 4 * F, F), new(B, H, 1, F), new(B, H, F), new(B, H, F))
    work = torch.empty(B * H * lib.ttt_mlp_backward_workspace_bytes(CS, K), dtype=torch.uint8, device=XQ.device)
    _launch(lib, "ttt_mlp_backward",
            (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck, b2_ck, dout,
             *dx, dgate, *grads, work),
            (B, NC, H, CS, K), eta_scale, XQ.device)
    bwd_launches += 1
    launches_by_cs["bwd_launches", CS] += 1
    return (*dx, dgate, *(g.sum(dim=0) for g in grads))


def _backward_f32(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck, b2_ck, dout, eta_scale,
                  K):
    """Launch the float32 K2 on checked arguments; counts the launch. Returns what ttt_mlp_backward returns."""
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    lib = _lib("ttt_mlp_backward_f32")
    check_smem(lib, "ttt_mlp_backward_f32", CS, XQ.device)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=XQ.device)
    dx = [torch.empty_like(XQ) for _ in range(3)]
    dgate = new(B, H, NC, CS)
    grads = (new(B, H, F, 4 * F), new(B, H, 1, 4 * F), new(B, H, 4 * F, F), new(B, H, 1, F), new(B, H, F), new(B, H, F))
    work = new(B * H * lib.ttt_mlp_backward_f32_workspace_floats(CS, K))
    _launch(lib, "ttt_mlp_backward_f32",
            (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, W2_ck, b2_ck, dout, *dx, dgate, *grads,
             work), (B, NC, H, CS, K), eta_scale, XQ.device)
    f32_launches_by_cs["bwd_launches", CS] += 1
    return (*dx, dgate, *(g.sum(dim=0) for g in grads))


def _group(checkpoint_group: int, NC: int) -> int:
    """The checkpoint group the scan uses: at least 1, at most NC."""
    return min(max(int(checkpoint_group), 1), NC)


class TTTMLPFunction(torch.autograd.Function):
    """The fused TTT-MLP scan with its gradient: K1-train forward (keeping the
    state checkpoints), K2 backward; the counterpart of
    ttt_vjp.py:ttt_mlp_fused_pre. Gradients flow to the raw XQ/XK/XV, the
    gate logits, ln_w/ln_b and W1/b1/W2/b2; the rope tables get none. With
    ``plain``, both passes run the plain versions on any device (the
    reference path that chip_smoke.py holds the kernels' gradients to)."""

    @staticmethod
    def forward(ctx, XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale, checkpoint_group,
                plain):
        K = _group(checkpoint_group, XQ.shape[1])
        fwd = ttt_mlp_forward_plain if plain else ttt_mlp_forward_train
        out, *ckpts = fwd(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale, K)
        ctx.save_for_backward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, *ckpts)
        ctx.eta_scale, ctx.K, ctx.plain = eta_scale, K, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, *ckpts = ctx.saved_tensors
        bwd = ttt_mlp_backward_plain if ctx.plain else ttt_mlp_backward
        dXQ, dXK, dXV, dgate, dW1, db1, dW2, db2, dlnw, dlnb = bwd(
            XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, *ckpts, dout.to(XQ.dtype).contiguous(),
            ctx.eta_scale, ctx.K)
        return dXQ, dXK, dXV, dgate, None, None, dlnw, dlnb, dW1, db1, dW2, db2, None, None, None


def ttt_mlp_train(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale: float,
                  checkpoint_group: int, plain: bool = False):
    """The fused TTT-MLP scan for training: autograd through K1-train and K2
    (or, with ``plain``, through their plain versions)."""
    refuse_dtensors("ttt_mlp_train", XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2)
    return TTTMLPFunction.apply(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale,
                                checkpoint_group, plain)
