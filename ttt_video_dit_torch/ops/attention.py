"""Window attention: the CUDA kernels' wrappers, their plain versions, and the
autograd Function that trains through them.

Port of ttt_video_dit_tpu/ops/attention.py:attention (the splash-attention
forward K3 and its custom-VJP backward K4, reached through _splash_padded /
_splash_kernel). The kernels are ``csrc/attention_forward.cu`` (forward,
optionally writing the log-sum-exp) and ``csrc/attention_backward.cu``, at
head dim 64; and, at head dim 128 (d3072 at 24 heads),
``csrc/attention_forward_f128.cu`` (the forward, optionally writing the
log-sum-exp) and ``csrc/attention_backward_f128.cu``. They
mask the ragged KV edge themselves, so the splash padding and block tuning
have no counterpart here. The backward is the splash backward's non-fused
form: dk and dv in one kernel, dq in one of its own, each output element one
sum in registers in a fixed order, so the same inputs give the same gradient
bits on every launch. Attention windows ride as batch: q/k/v
[B * windows, S, H, F]; the log-sum-exp is [B * windows, H, S] float32, the
natural log of the row sums of exp(q k^T / sqrt(F)).

The kernels take bf16; the JAX package gives its splash kernel bf16 only and
sends every other dtype to XLA (ttt_video_dit_tpu/ops/attention.py:433-440:
_direct up to 4,096 tokens, _chunked above). ``routes_to_plain`` is that
dtype test, and ``use_plain`` the model's route, counting in
``plain_routes`` the calls on the card it sends to the plain versions (the
kernels still take bf16 windows of any length, which the JAX package sends
to _direct up to 4,096 tokens: the same function).
"""

from __future__ import annotations

import ctypes

import torch

from ttt_video_dit_torch.ops import _build
from ttt_video_dit_torch.parallel.sharded import refuse_dtensors

# Launches of each CUDA kernel (the plain versions do not count): the forward
# for sampling, the forward that writes the log-sum-exp, the backward, at head
# dim 64; the same three at head dim 128.
launches = 0
lse_launches = 0
bwd_launches = 0
f128_launches = 0
f128_lse_launches = 0
f128_bwd_launches = 0
# Calls on a CUDA device that use_plain sent to the plain versions (a dtype other than bf16).
plain_routes = 0

KERNEL_HEAD_DIM = 64
# The head dims the kernels take: the sampling forward (K3) and the training kernels (the log-sum-exp forward
# K3-lse, the backward K4) alike.
HEAD_DIMS = (64, 128)
_BLOCK_Q = 256


def attention_plain(q, k, v, block_q: int = _BLOCK_Q, return_lse: bool = False):
    """softmax(q k^T / sqrt(F)) v per window and head, in float32 (float64 for
    float64 inputs), one block of ``block_q`` query rows at a time (the way
    _chunked bounds its live memory: a full score tensor at S = 18,048 x 48
    heads would be ~62 GB in float32). q/k/v [BC, S, H, F]; returns
    [BC, S, H, F] in q's dtype, and with ``return_lse`` also the
    log-sum-exp [BC, H, S]."""
    BC, S, H, F = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / (F**0.5)
    kt = k.to(acc).permute(0, 2, 3, 1)  # [BC, H, F, S]
    vh = v.to(acc).permute(0, 2, 1, 3)  # [BC, H, S, F]
    out = torch.empty_like(q)
    lse = torch.empty(BC, H, S, dtype=acc, device=q.device) if return_lse else None
    for s0 in range(0, S, block_q):
        qb = q[:, s0 : s0 + block_q].to(acc).permute(0, 2, 1, 3) * scale  # [BC, H, bq, F]
        logits = qb @ kt
        out[:, s0 : s0 + block_q] = (torch.softmax(logits, dim=-1) @ vh).permute(0, 2, 1, 3).to(q.dtype)
        if return_lse:
            lse[:, :, s0 : s0 + block_q] = torch.logsumexp(logits, dim=-1)
    return (out, lse) if return_lse else out


def attention_backward_plain(q, k, v, out, lse, dout, block_q: int = _BLOCK_Q):
    """The flash backward's formula in float32 (float64 for float64 inputs),
    ``block_q`` query rows at a time: P = exp(q k^T / sqrt(F) - lse),
    D = rowsum(dout * out), dV = P^T dout, dS = P * (dout V^T - D),
    dQ = dS K / sqrt(F), dK = dS^T Q / sqrt(F). Returns (dq, dk, dv) in q's dtype."""
    BC, S, H, F = q.shape
    acc = torch.promote_types(q.dtype, torch.float32)
    scale = 1.0 / (F**0.5)
    hm = lambda x: x.to(acc).permute(0, 2, 1, 3)  # [BC, H, S, F]
    kh, vh = hm(k), hm(v)
    dq = torch.empty_like(q)
    dk = torch.zeros(BC, H, S, F, dtype=acc, device=q.device)
    dv = torch.zeros(BC, H, S, F, dtype=acc, device=q.device)
    for s0 in range(0, S, block_q):
        sl = slice(s0, s0 + block_q)
        qb, ob, dob = hm(q[:, sl]), hm(out[:, sl]), hm(dout[:, sl])
        p = torch.exp(qb @ kh.transpose(-1, -2) * scale - lse[:, :, sl, None].to(acc))  # [BC, H, bq, S]
        D = (dob * ob).sum(dim=-1, keepdim=True)
        dv += p.transpose(-1, -2) @ dob
        ds = p * (dob @ vh.transpose(-1, -2) - D)
        dq[:, sl] = (ds @ kh * scale).permute(0, 2, 1, 3).to(q.dtype)
        dk += ds.transpose(-1, -2) @ qb * scale
    back = lambda x: x.permute(0, 2, 1, 3).to(q.dtype)
    return dq, back(dk), back(dv)


def routes_to_plain(dtype: torch.dtype) -> bool:
    """Whether attention at ``dtype`` goes to the plain versions rather than
    the kernels: every dtype but bf16, as the JAX package sends only bf16 to
    its splash kernel."""
    return dtype != torch.bfloat16


def use_plain(use_kernel: bool, dtype: torch.dtype, device: torch.device) -> bool:
    """The model's route for one attention call: the plain versions with
    ``use_kernel`` off or where :func:`routes_to_plain` holds, else the
    kernels. A call on a CUDA device sent to the plain versions by the route
    (not by ``use_kernel``) counts in ``plain_routes``."""
    global plain_routes
    if not use_kernel:
        return True
    if not routes_to_plain(dtype):
        return False
    if device.type == "cuda":
        plain_routes += 1
    return True


def _lib(name: str = "attention_forward"):
    lib = _build.load(name)
    if name == "attention_forward" and lib.attention_forward.argtypes is None:
        lib.attention_forward.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
        lib.attention_forward.restype = ctypes.c_int
    if name == "attention_forward_f128" and lib.attention_forward_f128.argtypes is None:
        lib.attention_forward_f128.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [ctypes.c_float,
                                                                                           ctypes.c_void_p]
        lib.attention_forward_f128.restype = ctypes.c_int
        lib.attention_forward_f128_smem_bytes.restype = ctypes.c_int
    for bwd in ("attention_backward", "attention_backward_f128"):
        if name == bwd and getattr(lib, bwd).argtypes is None:
            getattr(lib, bwd).argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
            getattr(lib, bwd).restype = ctypes.c_int
    if name == "attention_backward_f128":
        lib.attention_backward_f128_smem_bytes.restype = ctypes.c_int
    return lib


def check_kernel_args(q, k, v) -> None:
    """Raise ValueError unless q/k/v are what the CUDA kernels take: equal
    [BC, S, H, F] bf16 shapes with F in HEAD_DIMS, contiguous,
    16-byte aligned, on one CUDA device, with BC and H within a grid
    dimension (65,535). The kernels read them by TMA, which needs a
    16-byte-aligned base and strides that are multiples of 16 bytes:
    contiguous [..., H, F] bf16 has 2 F and H x 2 F."""
    if q.ndim != 4 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"the attention kernels take [BC, S, H, F] with F in {HEAD_DIMS}, got {tuple(q.shape)}")
    if q.shape[0] > 65535 or q.shape[2] > 65535:
        raise ValueError(f"the attention kernel takes at most 65,535 windows and heads, got {tuple(q.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.shape != q.shape or t.dtype != torch.bfloat16:
            raise ValueError(f"{name}: expected {tuple(q.shape)} bfloat16, got {tuple(t.shape)} {t.dtype}")
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name}: expected a tensor on {q.device} (CUDA), got {t.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


_smem_checked: set = set()


def check_smem(lib, name: str, device) -> None:
    """Raise RuntimeError if the head-dim-128 kernels of library ``name``
    (the forward; the backward's dk/dv and dq kernels, the larger of the
    two) need more shared memory a block than ``device`` lets a block opt in
    to; checked at the first launch of each on each device."""
    if (name, device) in _smem_checked:
        return
    need = getattr(lib, f"{name}_smem_bytes")()
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if not 0 < need <= limit:
        raise RuntimeError(f"{name} needs {need} bytes of shared memory a block; {device} allows {limit}")
    _smem_checked.add((name, device))


def _forward(q, k, v, with_lse: bool):
    """Launch K3 of q's head dim, 64 or 128, writing the log-sum-exp with ``with_lse``."""
    check_kernel_args(q, k, v)
    BC, S, H, F = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(BC, H, S, dtype=torch.float32, device=q.device) if with_lse else None
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr() if with_lse else None)
    if F == KERNEL_HEAD_DIM:
        name, lib = "attention_forward", _lib()
    else:
        name, lib = "attention_forward_f128", _lib("attention_forward_f128")
        check_smem(lib, name, q.device)
    with torch.cuda.device(q.device):
        err = getattr(lib, name)(*ptrs, BC, S, H, 1.0 / (F**0.5), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, f"{name} launch")
    return out, lse


def attention(q, k, v):
    """Non-causal attention per window: q/k/v [BC, S, H, F] -> [BC, S, H, F].
    CPU tensors take the plain version; CUDA tensors launch the kernel of
    their head dim, 64 or 128 (or raise on arguments it does not take).
    Writes no log-sum-exp."""
    global launches, f128_launches
    refuse_dtensors("attention", q, k, v)
    if q.device.type == "cpu":
        return attention_plain(q, k, v)
    out, _ = _forward(q, k, v, with_lse=False)
    if q.shape[-1] == KERNEL_HEAD_DIM:
        launches += 1
    else:
        f128_launches += 1
    return out


@torch.library.custom_op("ttt_video_dit_torch::attention_with_lse", mutates_args=(),
                         schema="(Tensor q, Tensor k, Tensor v) -> (Tensor, Tensor)")
def attention_with_lse(q, k, v):
    """K3 that also returns the log-sum-exp [BC, H, S] float32 for the
    backward. A custom op (so a selective-checkpoint policy can name it,
    models/dit/dit.py): on CUDA tensors it launches the kernel or raises; on
    CPU tensors it runs the plain version."""
    global lse_launches, f128_lse_launches
    out, lse = _forward(q, k, v, with_lse=True)
    if q.shape[-1] == KERNEL_HEAD_DIM:
        lse_launches += 1
    else:
        f128_lse_launches += 1
    return out, lse


@attention_with_lse.register_fake
def _(q, k, v):
    """Tensors with no data (meta) cannot launch the kernel: refuse them, as the argument checks do."""
    raise ValueError(f"attention_with_lse takes CUDA tensors (the kernel) or CPU tensors (the plain version), "
                     f"got {q.device}")


@attention_with_lse.register_kernel("cpu")
def _(q, k, v):
    return attention_plain(q, k, v, return_lse=True)


def attention_backward(q, k, v, out, lse, dout):
    """K4: (dq, dk, dv) of attention from the forward's output and
    log-sum-exp. CPU tensors take the plain version; CUDA tensors launch the
    kernel of their head dim, 64 or 128 (or raise on arguments it does not
    take). Each output element is one sum in a fixed order (dk and dv in one
    kernel, dq in another), so the same inputs give the same bits on every
    launch."""
    global bwd_launches, f128_bwd_launches
    refuse_dtensors("attention_backward", q, k, v, out, lse, dout)
    if q.device.type == "cpu":
        return attention_backward_plain(q, k, v, out, lse, dout)
    check_kernel_args(q, k, v)
    check_kernel_args(q, out, dout)
    BC, S, H, F = q.shape
    if lse.shape != (BC, H, S) or lse.dtype != torch.float32 or not lse.is_contiguous() or lse.device != q.device:
        raise ValueError(f"lse: expected contiguous ({BC}, {H}, {S}) float32 on {q.device}, got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}")
    dq, dk, dv = (torch.empty_like(q) for _ in range(3))
    delta = torch.empty(BC, H, S, dtype=torch.float32, device=q.device)  # D = rowsum(dout * out)
    name = "attention_backward" if F == KERNEL_HEAD_DIM else "attention_backward_f128"
    lib = _lib(name)
    if F != KERNEL_HEAD_DIM:
        check_smem(lib, name, q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = getattr(lib, name)(*(t.data_ptr() for t in (q, k, v, out, lse, dout, dq, dk, dv, delta)),
                                 BC, S, H, 1.0 / (F**0.5), stream)
    _build.check(lib, err, f"{name} launch")
    if F == KERNEL_HEAD_DIM:
        bwd_launches += 1
    else:
        f128_bwd_launches += 1
    return dq, dk, dv


class AttentionFunction(torch.autograd.Function):
    """Window attention with its gradient: K3 (with the log-sum-exp) forward,
    K4 backward; the counterpart of the splash custom VJP (call_fwd/call_bwd).
    With ``plain``, both passes run the plain versions on any device (chunked,
    so the backward never holds a full score matrix)."""

    @staticmethod
    def forward(ctx, q, k, v, plain):
        out, lse = attention_plain(q, k, v, return_lse=True) if plain else attention_with_lse(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.plain = plain
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        bwd = attention_backward_plain if ctx.plain else attention_backward
        return (*bwd(q, k, v, out, lse, dout.to(q.dtype).contiguous()), None)


def attention_train(q, k, v, plain: bool = False):
    """Window attention for training: autograd through K3 and K4 (or, with
    ``plain``, through their plain versions)."""
    refuse_dtensors("attention_train", q, k, v)
    return AttentionFunction.apply(q, k, v, plain)
