"""3D rotary position embeddings over (frame, height, width) latent grids
(port of ttt_video_dit_tpu/ops/rope.py).

Adjacent feature pairs ``(x[2i], x[2i+1])`` are rotated by angles drawn from
temporal/height/width frequency bands of sizes ``d/8, 3d/16, 3d/16`` (in
pairs), concatenated per position in ``(t, h, w)`` row-major order. Text
positions get identity rows (cos 1, sin 0). Tables are float32 and are built
once per geometry by the callers.
"""

from __future__ import annotations

import numpy as np
import torch


def _rope_freq_bands(head_dim: int, theta: float):
    dim_t = head_dim // 4
    dim_h = head_dim // 8 * 3
    dim_w = head_dim // 8 * 3
    band = lambda d: 1.0 / (theta ** (np.arange(0, d, 2)[: d // 2].astype(np.float32) / d))
    return band(dim_t), band(dim_h), band(dim_w)


def precompute_rope_3d(head_dim: int, height: int, width: int, num_frames: int, theta: float = 10000.0):
    """Returns (cos, sin), float32 CPU tensors [num_frames * height * width, head_dim // 2]."""
    freqs_t, freqs_h, freqs_w = (torch.from_numpy(np.asarray(f, np.float32)) for f in _rope_freq_bands(head_dim, theta))
    T, H, W = num_frames, height, width
    ang_t = torch.arange(T, dtype=torch.float32)[:, None] * freqs_t[None, :]
    ang_h = torch.arange(H, dtype=torch.float32)[:, None] * freqs_h[None, :]
    ang_w = torch.arange(W, dtype=torch.float32)[:, None] * freqs_w[None, :]
    ang = torch.cat(
        [
            ang_t[:, None, None, :].expand(T, H, W, -1),
            ang_h[None, :, None, :].expand(T, H, W, -1),
            ang_w[None, None, :, :].expand(T, H, W, -1),
        ],
        dim=-1,
    ).reshape(T * H * W, -1)
    return torch.cos(ang), torch.sin(ang)


def pair_swap(x):
    """x @ R with (x @ R)[2i] = -x[2i+1], (x @ R)[2i+1] = x[2i] (exact in any dtype)."""
    return torch.stack([-x[..., 1::2], x[..., 0::2]], dim=-1).flatten(-2)


def apply_rope(x, cos, sin, seq_axis: int = -2):
    """Rotate adjacent feature pairs of ``x`` ([..., D], sequence at
    ``seq_axis``) by the angles of cos/sin ([L', D/2], L' >= sequence length).
    The combine runs in float32; the result has x's dtype."""
    seq_axis = seq_axis % x.ndim
    L, D = x.shape[seq_axis], x.shape[-1]
    shape = [1] * x.ndim
    shape[seq_axis], shape[-1] = L, D
    cos_il = cos[:L].to(device=x.device, dtype=torch.float32).repeat_interleave(2, dim=-1).reshape(shape)
    sin_il = sin[:L].to(device=x.device, dtype=torch.float32).repeat_interleave(2, dim=-1).reshape(shape)
    out = x.float() * cos_il + pair_swap(x).float() * sin_il
    return out.to(x.dtype)


def _prefixed(cos, sin, prefix: int, total_len: int):
    Dh = cos.shape[-1]
    L_vid = total_len - prefix
    cos_p = torch.cat([torch.ones(prefix, Dh, dtype=torch.float32, device=cos.device), cos[:L_vid].float()])
    sin_p = torch.cat([torch.zeros(prefix, Dh, dtype=torch.float32, device=sin.device), sin[:L_vid].float()])
    return cos_p, sin_p


def interleaved_tables_prefixed(cos, sin, prefix: int, total_len: int):
    """[total_len, D] lane-duplicated cos/sin tables with identity rows for the
    first ``prefix`` positions: the table form the fused TTT kernel reads."""
    cos_p, sin_p = _prefixed(cos, sin, prefix, total_len)
    return cos_p.repeat_interleave(2, dim=-1), sin_p.repeat_interleave(2, dim=-1)


def apply_rope_prefixed(x, cos, sin, prefix: int, seq_axis: int = 1):
    """Rope with the first ``prefix`` sequence positions (text) left unrotated."""
    seq_axis = seq_axis % x.ndim
    cos_p, sin_p = _prefixed(cos, sin, prefix, x.shape[seq_axis])
    return apply_rope(x, cos_p, sin_p, seq_axis)
