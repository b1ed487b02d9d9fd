"""Fused TTT-linear scan: the CUDA kernels' wrappers, their plain versions,
and the autograd Function that trains through them.

Port of ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_linear_kernel (K5, with
_fused_preproc and _eta_from_gate) and ops/pallas/ttt_backward.py:
_linear_bwd_kernel (K6), in the fused-preprocessing, token-major,
in-kernel-gate form that ttt_vjp.py:ttt_linear_fused_pre dispatches.
Kernels (head_dim F = 64; mini-batch CS one of KERNEL_MINI_BATCHES, every
multiple of 8 from 8 to 64, for both sampling and training; one
instantiation each, the last 16-token slab a masked half slab when CS is
not a multiple of 16):

- ``ttt_linear_forward``: K5 for sampling (no state checkpoints),
  ``csrc/ttt_linear_forward.cu``;
- ``ttt_linear_forward_train``: K5 for training, which also writes the fp32
  state at the start of every group of K mini-batches (the last group may be
  ragged), the same kernel;
- ``ttt_linear_backward``: K6, K5's VJP from those checkpoints,
  ``csrc/ttt_linear_backward.cu``;
- ``TTTLinearFunction``: K5-train forward, K6 backward.

At head dim F = 128 (d3072 at 24 heads) all three, at the mini-batches
F128_MINI_BATCHES and on bf16 q/k/v: K5 and K5-train in
``csrc/ttt_linear_forward_f128.cu``, K6 in
``csrc/ttt_linear_backward_f128.cu``, counted in ``f128_launches_by_cs``
under the same names as the head-dim-64 counters.

q/k/v may be bf16 or float32 (ttt_mlp_kernel.KERNEL_DTYPES): float32 launches
the float32 counterparts, which round nothing to bf16
(``csrc/ttt_linear_forward_f32.cu`` for K5 and K5-train, K = 0 for sampling,
``csrc/ttt_linear_backward_f32.cu`` for K6; counted in
``f32_launches_by_cs``). ``use_plain`` is the layer's route, as in
ops/ttt_mlp_kernel.py (``routes_to_plain``: the JAX package's shape test),
counting in ``plain_routes``.

Inputs are the RAW token-major projections and the pre-sigmoid LR-gate
logits, as for the TTT-MLP kernels (ops/ttt_mlp_kernel.py). Shapes:
XQ/XK/XV [B, NC, CS, H*F]; gate [B, H, NC, CS]; rope_cos/rope_sin
[NC, CS, F] float32; ln_w/ln_b [H, F]; W1 [H, F, F], b1 [H, 1, F] (the
learned initial state, shared by every batch element). Outputs
[B, NC, CS, H*F] in XQ's dtype. State checkpoints are compact fp32:
W1 [B, H, NG, F, F], b1 [B, H, NG, 1, F], NG = ceil(NC / K).
"""

from __future__ import annotations

import collections
import ctypes

import torch

from ttt_video_dit_torch.ops import _build
from ttt_video_dit_torch.ops import ln as ln_ops
from ttt_video_dit_torch.ops.ttt_mlp_kernel import (
    _acc_dtype,
    _check_tensors,
    _f32_argtypes,
    _group,
    _launch,
    _preproc,
    _to_head_major,
    _to_token_major,
    check_smem,
    qkv_dtype,
    routes_to_plain,
    scan_forward_plain,
)
from ttt_video_dit_torch.ops.ttt_scan import scan_mini_batches, ttt_linear_step
from ttt_video_dit_torch.parallel.sharded import refuse_dtensors

# Launches of each CUDA kernel (the plain versions do not count): K5 for
# sampling, K5 for training, K6 on bf16 q/k/v; and the same by mini-batch,
# launches_by_cs[counter name, CS] (all head dim 64); the float32 kernels' by the
# same keys in f32_launches_by_cs, the head-dim-128 kernels' in
# f128_launches_by_cs. plain_routes: the scans on a CUDA device that use_plain
# sent to the plain versions.
launches = 0
train_launches = 0
bwd_launches = 0
launches_by_cs = collections.Counter()
f32_launches_by_cs = collections.Counter()
f128_launches_by_cs = collections.Counter()
plain_routes = 0

KERNEL_HEAD_DIM = 64
# The mini-batch sizes K5 and K6 are built for: csrc/ttt_mlp_block.cuh:with_slabs instantiates these (a test
# holds the two lists together); the C entries take CS and refuse any other.
KERNEL_MINI_BATCHES = (8, 16, 24, 32, 40, 48, 56, 64)
# Head dim 128: K5, K5-train and K6, bf16, at these mini-batches (the cases of
# csrc/ttt_linear_f128.cuh:with_mini_batch; a test holds the two together).
F128_HEAD_DIM = 128
F128_MINI_BATCHES = (16,)


# ------------------------------------------------------------ plain versions


def ttt_linear_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale: float,
                             checkpoint_group: int | None = None):
    """K5's plain version: the per-step loop of _linear_kernel
    (``ops/ttt_mlp_kernel.py:scan_forward_plain`` over
    ``ttt_scan.ttt_linear_step``), rounding to XQ's dtype where the kernel
    does. With ``checkpoint_group`` K: (out, W1_ck, b1_ck)."""
    return scan_forward_plain(ttt_linear_step, (W1, b1), XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b,
                              eta_scale, checkpoint_group)


def ttt_linear_backward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, dout,
                              eta_scale: float, checkpoint_group: int, trace: dict | None = None):
    """K6's algorithm in PyTorch, rounding to XQ's dtype where
    _linear_bwd_kernel does. Per checkpoint group, last first: pass A re-runs
    the forward from the group's checkpoint and stashes each step's state;
    pass B walks the group backwards through the step VJP of
    ttt_backward.py:501-584, line by line, and carries the state cotangents.

    Returns (dXQ, dXK, dXV [B, NC, CS, H*F] in XQ's dtype, d_gate
    [B, H, NC, CS] in float32 (float64 for float64 inputs), dW1 [H, F, F],
    db1 [H, 1, F], dln_w [H, F], dln_b [H, F]): the initial-state and LN
    cotangents summed over the batch, as the shared parameters need them.

    With ``trace`` (a dict), ``trace[n]`` gets mini-batch n's rounded
    operands of dXK's products, dXK's LN-target term, Z1 and the fp32
    carry dW, head-major [B, H, ., .] (scripts/k6_tolerance_seeds.py reads
    them)."""
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
    dW1, db1 = zeros(B, H, F, F), zeros(B, H, 1, F)
    dlnw, dlnb = zeros(B, H, 1, F), zeros(B, H, 1, F)

    def forward_step(state, n):
        XQf, XKf, target, _, _ = _preproc(xq[n], xk[n], xv[n], cos[n], sin[n], lnw, lnb)
        return ttt_linear_step(state, rnd(XQf), rnd(XKf), target, eta[n][..., 0], lnw, lnb, rnd)[0], None

    for g in reversed(range(NG)):
        n0 = g * K
        # Pass A: the forward from the checkpoint, stashing the state before each step.
        state = (W1_ck[:, :, g].to(acc), b1_ck[:, :, g].to(acc))
        _, _, stash = scan_mini_batches(lambda s, i: forward_step(s, n0 + i), state, min(K, NC - n0), 1)
        # Pass B: the step VJP, last step first.
        for i in reversed(range(len(stash))):
            n, (W1, b1) = n0 + i, stash[i]
            W1 = rnd(W1)
            XQf, XKf, target, t_hat, s_t = _preproc(xq[n], xk[n], xv[n], cos[n], sin[n], lnw, lnb)
            XQ_, XK_ = rnd(XQf), rnd(XKf)
            e = eta[n]
            d_out = g_out[n]

            Z1 = mm(XK_, W1) + b1
            z1_hat, std1 = ln_ops.ln_stats(Z1)
            g1 = ln_ops.ln_fused_l2(z1_hat, std1, target, lnw, lnb)
            Gs = rnd(e * g1)
            A1 = rnd(mm(XQ_, tr(XK_)))
            Zb1 = mm(XQ_, W1) - mm(A1, Gs) + b1 - colsum(Gs)
            zb1_hat, stdb1 = ln_ops.ln_stats(Zb1)

            # out = XQ + LN(Zb1)
            dZb1, dgw, dgb = ln_ops.ln_fwd_vjp_rows(zb1_hat, stdb1, lnw, d_out)
            dlnw += colsum(dgw)
            dlnb += colsum(dgb)
            dZb1c = rnd(dZb1)
            # Zb1 = XQ @ W1 - A1 @ Gs + b1'
            dXQ = d_out + mm(dZb1c, tr(W1))
            dW1_step = mm(tr(XQ_), dZb1c)
            dA1 = -mm(dZb1c, tr(Gs))
            db1_tot = db1 + colsum(dZb1)
            dG = -mm(tr(A1), dZb1c) - db1_tot
            # W1' = W1 - XK^T Gs (the carry is dW1')
            dW1_step = dW1_step + dW1
            dXK = -mm(Gs, tr(rnd(dW1)))
            dG = dG - mm(XK_, rnd(dW1))
            # A1 = XQ @ XK^T
            dXQ = dXQ + mm(rnd(dA1), XK_)
            dXK = dXK + mm(tr(rnd(dA1)), XQ_)
            # Gs = eta * g1
            de = (dG * g1).sum(dim=-1, keepdim=True)
            dg1 = e * dG
            # g1 = ln_fused_l2(Z1, target)
            dZ1, dtarget, dgw2, dgb2 = ln_ops.ln_fused_l2_vjp_rows(z1_hat, std1, target, lnw, lnb, dg1)
            dlnw += colsum(dgw2)
            dlnb += colsum(dgb2)
            # target = LN-reconstruction(XV - XK)
            dtv, dgw_t, dgb_t = ln_ops.target_ln_vjp(t_hat, s_t, lnw, dtarget)
            dlnw += colsum(dgw_t)
            dlnb += colsum(dgb_t)
            dXK = dXK - dtv
            # Z1 = XK @ W1 + b1
            dZ1c = rnd(dZ1)
            dXK = dXK + mm(dZ1c, tr(W1))
            dW1_step = dW1_step + mm(tr(XK_), dZ1c)
            db1_new = db1_tot + colsum(dZ1)
            # rope, then the L2 norm, back to the raw projections
            dxq[n] = ln_ops.l2norm_vjp(xq[n], ln_ops.rope_vjp(dXQ, cos[n], sin[n])).to(dt)
            dxk[n] = ln_ops.l2norm_vjp(xk[n], ln_ops.rope_vjp(dXK, cos[n], sin[n])).to(dt)
            dxv[n] = dtv.to(dt)
            dgate[n] = (de * e * (1.0 - sig[n]))[..., 0]
            if trace is not None:
                trace[n] = dict(XQ=XQ_, W=W1, Z1=Z1, Gs=Gs, dW=rnd(dW1), dW32=dW1, dA1=rnd(dA1), dZ1=dZ1c, dtv=dtv)
            dW1, db1 = dW1_step, db1_new

    sum_b = lambda x: x.sum(dim=0)
    return (_to_token_major(dxq), _to_token_major(dxk), _to_token_major(dxv), dgate.permute(1, 2, 0, 3).contiguous(),
            sum_b(dW1), sum_b(db1), sum_b(dlnw)[:, 0], sum_b(dlnb)[:, 0])


# ------------------------------------------------------------ the route


def use_plain(use_kernel: bool, CS: int, F: int, device: torch.device) -> bool:
    """The model's route for a scan, as ttt_mlp_kernel.use_plain: the plain
    versions with ``use_kernel`` off or where ``routes_to_plain(CS, F)``
    holds; a scan on a CUDA device sent there by the route counts in
    ``plain_routes``."""
    global plain_routes
    if not use_kernel:
        return True
    if not routes_to_plain(CS, F):
        return False
    if device.type == "cuda":
        plain_routes += 1
    return True


# ------------------------------------------------------------ CUDA kernels


def _lib(name: str = "ttt_linear_forward"):
    lib = _build.load(name)
    if name == "ttt_linear_forward" and lib.ttt_linear_forward.argtypes is None:
        lib.ttt_linear_forward.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                                           + [ctypes.c_float, ctypes.c_void_p])
        lib.ttt_linear_forward.restype = ctypes.c_int
    if name == "ttt_linear_backward" and lib.ttt_linear_backward.argtypes is None:
        lib.ttt_linear_backward.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 5
                                            + [ctypes.c_float, ctypes.c_void_p])
        lib.ttt_linear_backward.restype = ctypes.c_int
        lib.ttt_linear_backward_stash_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ttt_linear_backward_stash_bytes.restype = ctypes.c_int
    if name == "ttt_linear_forward_f128" and lib.ttt_linear_forward_f128.argtypes is None:
        lib.ttt_linear_forward_f128.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 5
                                                + [ctypes.c_float, ctypes.c_void_p])
        lib.ttt_linear_forward_f128.restype = ctypes.c_int
    if name == "ttt_linear_backward_f128" and lib.ttt_linear_backward_f128.argtypes is None:
        lib.ttt_linear_backward_f128.argtypes = ([ctypes.c_void_p] * 21 + [ctypes.c_int] * 5
                                                 + [ctypes.c_float, ctypes.c_void_p])
        lib.ttt_linear_backward_f128.restype = ctypes.c_int
        lib.ttt_linear_backward_f128_stash_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
        lib.ttt_linear_backward_f128_stash_bytes.restype = ctypes.c_int
    if name in F32_LIBS and getattr(lib, name).argtypes is None:
        _f32_argtypes(lib, name, *F32_LIBS[name])
    smem = getattr(lib, f"{name}_smem_bytes")
    smem.argtypes, smem.restype = [ctypes.c_int], ctypes.c_int
    return lib


# The float32 libraries: pointer arguments of the C entry, and the arguments of its workspace size (CS, or CS and K).
F32_LIBS = {"ttt_linear_forward_f32": (14, 1), "ttt_linear_backward_f32": (20, 2)}


# The head dims and mini-batches the kernels take, {F: (CS, ...)}: the sampling K5 and the training kernels
# (K5-train, K6) alike.
KERNEL_SHAPES = {KERNEL_HEAD_DIM: KERNEL_MINI_BATCHES, F128_HEAD_DIM: F128_MINI_BATCHES}


def check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1) -> None:
    """Raise ValueError unless the arguments are what the CUDA kernels take:
    F and CS in KERNEL_SHAPES, token-major q/k/v all bf16 or
    all float32 (bf16 at F = 128), float32 everything else, every tensor
    contiguous and on one CUDA device, shapes consistent (W1/b1 may be None
    for the backward, which starts from checkpoints)."""
    if XQ.ndim != 4:
        raise ValueError(f"XQ must be token-major [B, NC, CS, H*F], got {tuple(XQ.shape)}")
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    if CS not in KERNEL_SHAPES.get(F, ()):
        raise ValueError(f"the TTT-linear kernels take head dim F: mini-batches CS {KERNEL_SHAPES}; got F={F}, "
                         f"CS={CS}")
    dt = qkv_dtype(XQ, XK, XV)
    if F == F128_HEAD_DIM and dt != torch.bfloat16:
        raise ValueError(f"the TTT-linear kernel at F={F} takes bfloat16 q/k/v, got {dt}")
    expected = {
        "XQ": (XQ, (B, NC, CS, H * F), dt), "XK": (XK, (B, NC, CS, H * F), dt),
        "XV": (XV, (B, NC, CS, H * F), dt), "gate": (gate, (B, H, NC, CS), torch.float32),
        "rope_cos": (rope_cos, (NC, CS, F), torch.float32), "rope_sin": (rope_sin, (NC, CS, F), torch.float32),
        "ln_w": (ln_w, (H, F), torch.float32), "ln_b": (ln_b, (H, F), torch.float32),
    }
    if W1 is not None:
        expected.update({"W1": (W1, (H, F, F), torch.float32), "b1": (b1, (H, 1, F), torch.float32)})
    _check_tensors(expected, XQ.device)


def _forward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale, K):
    """Launch K5 of q/k/v's dtype and head dim (the float32 one counts itself
    in f32_launches_by_cs, the head-dim-128 one in f128_launches_by_cs);
    K = 0 writes no checkpoints. Returns (out, W1_ck, b1_ck)."""
    check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1)
    B, NC, CS, _ = XQ.shape
    H, F = ln_w.shape
    NG = -(-NC // K) if K else 0
    out = torch.empty_like(XQ)
    new = lambda *s: torch.empty(*s, dtype=torch.float32, device=XQ.device)
    ckpts = (new(B, H, NG, F, F), new(B, H, NG, 1, F))
    args = (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, out, *ckpts)
    if F == F128_HEAD_DIM:
        lib = _lib("ttt_linear_forward_f128")
        check_smem(lib, "ttt_linear_forward_f128", CS, XQ.device)
        _launch(lib, "ttt_linear_forward_f128", args, (B, NC, H, CS, K), eta_scale, XQ.device)
        f128_launches_by_cs["train_launches" if K else "launches", CS] += 1
        return out, *ckpts
    if XQ.dtype == torch.float32:
        lib = _lib("ttt_linear_forward_f32")
        check_smem(lib, "ttt_linear_forward_f32", CS, XQ.device)
        work = new(B * H * lib.ttt_linear_forward_f32_workspace_floats(CS))
        _launch(lib, "ttt_linear_forward_f32", (*args, work), (B, NC, H, CS, K), eta_scale, XQ.device)
        f32_launches_by_cs["train_launches" if K else "launches", CS] += 1
        return out, *ckpts
    lib = _lib()
    check_smem(lib, "ttt_linear_forward", CS, XQ.device)
    _launch(lib, "ttt_linear_forward", args, (B, NC, H, CS, K), eta_scale, XQ.device)
    return out, *ckpts


def ttt_linear_forward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale: float):
    """Fused TTT-linear forward for sampling (no checkpoints). CPU tensors
    take the plain version; CUDA tensors launch the kernel (or raise on
    arguments it does not take)."""
    global launches
    refuse_dtensors("ttt_linear_forward", XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1)
    if XQ.device.type == "cpu":
        return ttt_linear_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale)
    out = _forward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale, 0)[0]
    if XQ.dtype != torch.float32 and ln_w.shape[1] == KERNEL_HEAD_DIM:
        launches += 1
        launches_by_cs["launches", XQ.shape[2]] += 1
    return out


@torch.library.custom_op(
    "ttt_video_dit_torch::ttt_linear_forward_train", mutates_args=(),
    schema="(Tensor XQ, Tensor XK, Tensor XV, Tensor gate, Tensor rope_cos, Tensor rope_sin, Tensor ln_w, "
           "Tensor ln_b, Tensor W1, Tensor b1, float eta_scale, int checkpoint_group) -> (Tensor, Tensor, Tensor)")
def ttt_linear_forward_train(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale, checkpoint_group):
    """Fused TTT-linear forward for training: (out, W1_ck, b1_ck), the fp32
    state at the start of every group of ``checkpoint_group`` mini-batches.
    A custom op (so a selective-checkpoint policy can name it,
    models/dit/dit.py): on CUDA tensors it launches the kernel or raises; on
    CPU tensors it runs the plain version."""
    global train_launches
    result = _forward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale,
                      _group(checkpoint_group, XQ.shape[1]))
    if XQ.dtype != torch.float32 and ln_w.shape[1] == KERNEL_HEAD_DIM:
        train_launches += 1
        launches_by_cs["train_launches", XQ.shape[2]] += 1
    return result


@ttt_linear_forward_train.register_fake
def _(XQ, *args):
    """Tensors with no data (meta) cannot launch the kernel: refuse them, as the argument checks do."""
    raise ValueError(f"ttt_linear_forward_train takes CUDA tensors (the kernel) or CPU tensors (the plain version), "
                     f"got {XQ.device}")


@ttt_linear_forward_train.register_kernel("cpu")
def _(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale, checkpoint_group):
    return ttt_linear_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale,
                                    checkpoint_group=checkpoint_group)


def ttt_linear_backward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, dout, eta_scale: float,
                        checkpoint_group: int):
    """K6, the fused TTT-linear backward from K5-train's checkpoints and the
    output cotangent ``dout`` (in q/k/v's dtype). Returns what
    :func:`ttt_linear_backward_plain` returns. CPU tensors take the plain
    version; CUDA tensors launch the kernel of their q/k/v dtype or raise."""
    global bwd_launches
    refuse_dtensors("ttt_linear_backward", XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, dout)
    if XQ.device.type == "cpu":
        return ttt_linear_backward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, dout,
                                         eta_scale, checkpoint_group)
    check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, None, None)
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    K = _group(checkpoint_group, NC)
    NG = -(-NC // K)
    _check_tensors({
        "W1_ck": (W1_ck, (B, H, NG, F, F), torch.float32), "b1_ck": (b1_ck, (B, H, NG, 1, F), torch.float32),
        "dout": (dout, (B, NC, CS, HF), XQ.dtype),
    }, XQ.device)
    new = lambda *s, dtype=torch.float32: torch.empty(*s, dtype=dtype, device=XQ.device)
    dx = [torch.empty_like(XQ) for _ in range(3)]
    dgate = new(B, H, NC, CS)
    grads = (new(B, H, F, F), new(B, H, 1, F), new(B, H, F), new(B, H, F))
    ins = (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1_ck, b1_ck, dout, *dx, dgate, *grads)
    if XQ.dtype == torch.float32:
        lib = _lib("ttt_linear_backward_f32")
        check_smem(lib, "ttt_linear_backward_f32", CS, XQ.device)
        work = new(B * H * lib.ttt_linear_backward_f32_workspace_floats(CS, K))
        _launch(lib, "ttt_linear_backward_f32", (*ins, work), (B, NC, H, CS, K), eta_scale, XQ.device)
        f32_launches_by_cs["bwd_launches", CS] += 1
        return (*dx, dgate, *(g.sum(dim=0) for g in grads))
    # K6's pass A writes each step's operands for pass B: a bf16 and a float32 workspace of K steps a scan.
    name = "ttt_linear_backward" if F == KERNEL_HEAD_DIM else "ttt_linear_backward_f128"
    lib = _lib(name)
    check_smem(lib, name, CS, XQ.device)
    step_bytes = [getattr(lib, f"{name}_stash_bytes")(part, CS) for part in (0, 1)]
    stash = (new(B * H * K * step_bytes[0] // 2, dtype=torch.bfloat16), new(B * H * K * step_bytes[1] // 4))
    _launch(lib, name, (*ins, *stash), (B, NC, H, CS, K), eta_scale, XQ.device)
    if F == KERNEL_HEAD_DIM:
        bwd_launches += 1
        launches_by_cs["bwd_launches", CS] += 1
    else:
        f128_launches_by_cs["bwd_launches", CS] += 1
    return (*dx, dgate, *(g.sum(dim=0) for g in grads))


class TTTLinearFunction(torch.autograd.Function):
    """The fused TTT-linear scan with its gradient: K5-train forward (keeping
    the state checkpoints), K6 backward; the counterpart of
    ttt_vjp.py:ttt_linear_fused_pre. Gradients flow to the raw XQ/XK/XV, the
    gate logits, ln_w/ln_b and W1/b1; the rope tables get none. With
    ``plain``, both passes run the plain versions on any device."""

    @staticmethod
    def forward(ctx, XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale, checkpoint_group, plain):
        K = _group(checkpoint_group, XQ.shape[1])
        fwd = ttt_linear_forward_plain if plain else ttt_linear_forward_train
        out, *ckpts = fwd(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale, K)
        ctx.save_for_backward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, *ckpts)
        ctx.eta_scale, ctx.K, ctx.plain = eta_scale, K, plain
        return out

    @staticmethod
    def backward(ctx, dout):
        XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, *ckpts = ctx.saved_tensors
        bwd = ttt_linear_backward_plain if ctx.plain else ttt_linear_backward
        dXQ, dXK, dXV, dgate, dW1, db1, dlnw, dlnb = bwd(
            XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, *ckpts, dout.to(XQ.dtype).contiguous(),
            ctx.eta_scale, ctx.K)
        return dXQ, dXK, dXV, dgate, None, None, dlnw, dlnb, dW1, db1, None, None, None


def ttt_linear_train(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale: float,
                     checkpoint_group: int, plain: bool = False):
    """The fused TTT-linear scan for training: autograd through K5-train and
    K6 (or, with ``plain``, through their plain versions)."""
    refuse_dtensors("ttt_linear_train", XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1)
    return TTTLinearFunction.apply(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, eta_scale,
                                   checkpoint_group, plain)
