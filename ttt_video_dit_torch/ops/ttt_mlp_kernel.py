"""Fused TTT-MLP forward scan: the CUDA kernel's wrapper and its plain version.

Port of ttt_video_dit_tpu/ops/pallas/ttt_forward.py:_mlp_kernel (with
_fused_preproc and _eta_from_gate), ttt_mlp_forward, and the fused-preproc
token-major dispatch of ops/pallas/ttt_mlp_kernel.py:ttt_mlp /
ttt_vjp.py:ttt_mlp_fused_pre, forward only (inference needs no state
checkpoints). The kernel is ``csrc/ttt_mlp_forward.cu``.

Inputs are the RAW token-major projections and the pre-sigmoid LR-gate
logits; the scan applies L2-norm + rope to q/k, builds the
LN-reconstruction target from v - k, and scales eta = sigmoid(gate) *
eta_scale itself.

Shapes: XQ/XK/XV [B, NC, CS, H*F] (head h = columns h*F..(h+1)*F); gate
[B, H, NC, CS]; rope_cos/rope_sin [NC, CS, F] float32 (interleaved, identity
rows on text slots); ln_w/ln_b [H, F]; W1 [H, F, 4F], b1 [H, 1, 4F],
W2 [H, 4F, F], b2 [H, 1, F] (the learned initial state, shared by every
batch element). Returns [B, NC, CS, H*F] in XQ's dtype.
"""

from __future__ import annotations

import ctypes

import torch

from ttt_video_dit_torch.ops import _build
from ttt_video_dit_torch.ops.rope import pair_swap
from ttt_video_dit_torch.ops.ttt_scan import ttt_mlp_step

# Launches of the CUDA kernel (the plain version does not count).
launches = 0

KERNEL_HEAD_DIM = 64
KERNEL_MINI_BATCH = 16


# ------------------------------------------------------------ plain version


def _l2norm(x, eps: float = 1e-12):
    """torch F.normalize parity: x / max(||x||_2, eps) over the last dim."""
    return x / torch.clamp(torch.sqrt((x * x).sum(dim=-1, keepdim=True)), min=eps)


def _rope(x, cos, sin):
    """Interleaved-pair rotation with lane-duplicated [CS, F] tables: x*cos + (x@R)*sin."""
    return x * cos + pair_swap(x) * sin


def _target_ln(t, lnw, lnb, eps: float = 1e-8):
    """LN-reconstruction normalization: unbiased std, eps added to the std."""
    n = t.shape[-1]
    mu = t.mean(dim=-1, keepdim=True)
    var = t.var(dim=-1, keepdim=True, correction=0) * (n / max(n - 1, 1))
    return lnw * ((t - mu) / (torch.sqrt(var) + eps)) + lnb


def ttt_mlp_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale: float):
    """The per-step loop of _mlp_kernel in PyTorch: the fused preprocessing,
    then ``ttt_scan.ttt_mlp_step`` rounding to XQ's dtype at the kernel's
    points (XQ/XK after preprocessing, and the step's own); products of the
    rounded operands accumulate in float32. Float32 matmuls must not use TF32
    for the kernel comparison (see chip_smoke.py)."""
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    dt = XQ.dtype
    rnd = lambda x: x.to(dt).float()
    # token-major [B, NC, CS, H*F] -> [NC, B, H, CS, F] float32
    to_hm = lambda x: x.reshape(B, NC, CS, H, F).permute(1, 0, 3, 2, 4).float()
    xq, xk, xv = to_hm(XQ), to_hm(XK), to_hm(XV)
    eta = (torch.sigmoid(gate.float()) * eta_scale).permute(2, 0, 1, 3)  # [NC, B, H, CS]
    cos, sin = rope_cos.float(), rope_sin.float()
    lnw = ln_w.float()[None, :, None, :]
    lnb = ln_b.float()[None, :, None, :]
    state = tuple(p.float().expand(B, *p.shape) for p in (W1, b1, W2, b2))

    out = torch.empty(NC, B, H, CS, F, dtype=dt, device=XQ.device)
    for n in range(NC):
        XQf = _rope(_l2norm(xq[n]), cos[n], sin[n])
        XKf = _rope(_l2norm(xk[n]), cos[n], sin[n])
        target = _target_ln(xv[n] - XKf, lnw, lnb)
        state, XQW = ttt_mlp_step(state, rnd(XQf), rnd(XKf), target, eta[n], lnw, lnb, rnd)
        out[n] = XQW.to(dt)
    return out.permute(1, 0, 3, 2, 4).reshape(B, NC, CS, HF)


# ------------------------------------------------------------ CUDA kernel


def _lib():
    lib = _build.load("ttt_mlp_forward")
    fn = lib.ttt_mlp_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2) -> None:
    """Raise ValueError unless the arguments are what the CUDA kernel takes:
    F = 64, CS = 16, bf16 token-major q/k/v, float32 everything else, every
    tensor contiguous and on one CUDA device, shapes consistent."""
    if XQ.ndim != 4:
        raise ValueError(f"XQ must be token-major [B, NC, CS, H*F], got {tuple(XQ.shape)}")
    B, NC, CS, HF = XQ.shape
    H, F = ln_w.shape
    if F != KERNEL_HEAD_DIM or CS != KERNEL_MINI_BATCH:
        raise ValueError(f"the TTT-MLP kernel supports F={KERNEL_HEAD_DIM}, CS={KERNEL_MINI_BATCH}; got F={F}, CS={CS}")
    expected = {
        "XQ": (XQ, (B, NC, CS, H * F), torch.bfloat16), "XK": (XK, (B, NC, CS, H * F), torch.bfloat16),
        "XV": (XV, (B, NC, CS, H * F), torch.bfloat16), "gate": (gate, (B, H, NC, CS), torch.float32),
        "rope_cos": (rope_cos, (NC, CS, F), torch.float32), "rope_sin": (rope_sin, (NC, CS, F), torch.float32),
        "ln_w": (ln_w, (H, F), torch.float32), "ln_b": (ln_b, (H, F), torch.float32),
        "W1": (W1, (H, F, 4 * F), torch.float32), "b1": (b1, (H, 1, 4 * F), torch.float32),
        "W2": (W2, (H, 4 * F, F), torch.float32), "b2": (b2, (H, 1, F), torch.float32),
    }
    for name, (t, shape, dtype) in expected.items():
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if t.device.type != "cuda" or t.device != XQ.device:
            raise ValueError(f"{name}: expected a tensor on {XQ.device} (CUDA), got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def ttt_mlp_forward(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale: float):
    """Fused TTT-MLP forward. CPU tensors take the plain version; CUDA tensors
    launch the kernel (or raise on arguments it does not take)."""
    global launches
    if XQ.device.type == "cpu":
        return ttt_mlp_forward_plain(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, eta_scale)
    check_kernel_args(XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2)
    B, NC, _, _ = XQ.shape
    H = ln_w.shape[0]
    out = torch.empty_like(XQ)
    lib = _lib()
    ptrs = [t.data_ptr() for t in (XQ, XK, XV, gate, rope_cos, rope_sin, ln_w, ln_b, W1, b1, W2, b2, out)]
    with torch.cuda.device(XQ.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ttt_mlp_forward(*ptrs, B, NC, H, float(eta_scale), stream)
    _build.check(lib, err, "ttt_mlp_forward launch")
    launches += 1
    return out
