"""Window attention forward: the CUDA kernel's wrapper and its plain version.

Port of ttt_video_dit_tpu/ops/attention.py:attention (the splash-attention
forward reached through _splash_padded / _splash_kernel). The kernel is
``csrc/attention_forward.cu``; it masks the ragged KV edge itself, so the
splash padding and block tuning have no counterpart here. Attention windows
ride as batch: q/k/v [B * windows, S, H, F].
"""

from __future__ import annotations

import ctypes

import torch

from ttt_video_dit_torch.ops import _build

# Launches of the CUDA kernel (the plain version does not count).
launches = 0

KERNEL_HEAD_DIM = 64
_BLOCK_Q = 256


def attention_plain(q, k, v, block_q: int = _BLOCK_Q):
    """softmax(q k^T / sqrt(F)) v per window and head, in float32, one block
    of ``block_q`` query rows at a time (the way _chunked bounds its live
    memory: a full score tensor at S = 18,048 x 48 heads would be ~62 GB in
    float32). q/k/v [BC, S, H, F]; returns [BC, S, H, F] in q's dtype."""
    BC, S, H, F = q.shape
    scale = 1.0 / (F**0.5)
    kt = k.float().permute(0, 2, 3, 1)  # [BC, H, F, S]
    vh = v.float().permute(0, 2, 1, 3)  # [BC, H, S, F]
    out = torch.empty_like(q)
    for s0 in range(0, S, block_q):
        qb = q[:, s0 : s0 + block_q].float().permute(0, 2, 1, 3) * scale  # [BC, H, bq, F]
        p = torch.softmax(qb @ kt, dim=-1)
        out[:, s0 : s0 + block_q] = (p @ vh).permute(0, 2, 1, 3).to(q.dtype)
    return out


def _lib():
    lib = _build.load("attention_forward")
    fn = lib.attention_forward
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def check_kernel_args(q, k, v) -> None:
    """Raise ValueError unless q/k/v are what the CUDA kernel takes: equal
    [BC, S, H, 64] bf16 shapes, contiguous, 16-byte aligned, on one CUDA device."""
    if q.ndim != 4 or q.shape[-1] != KERNEL_HEAD_DIM:
        raise ValueError(f"the attention kernel takes [BC, S, H, {KERNEL_HEAD_DIM}], got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expected {tuple(q.shape)} bfloat16, got {tuple(t.shape)} {t.dtype}")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: expected a tensor on {q.device} (CUDA), got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def attention(q, k, v):
    """Non-causal attention per window: q/k/v [BC, S, H, F] -> [BC, S, H, F].
    CPU tensors take the plain version; CUDA tensors launch the kernel (or
    raise on arguments it does not take)."""
    global launches
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    check_kernel_args(q, k, v)
    BC, S, H, F = q.shape
    out = torch.empty_like(q)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.attention_forward(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), BC, S, H,
                                    1.0 / (F**0.5), stream)
    _build.check(lib, err, "attention_forward launch")
    launches += 1
    return out
