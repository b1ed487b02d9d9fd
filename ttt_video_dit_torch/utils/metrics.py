"""Analytic FLOP counting and MFU (port of ttt_video_dit_tpu/utils/metrics.py).

Counts matmul FLOPs only (2*m*n*k), forward pass; a training step is counted
as 3x forward (forward + 2x backward). Rematerialized recompute is *not*
counted as useful work (standard MFU convention). The peak is the NVIDIA
H100's dense bf16 tensor-core rate.
"""

from __future__ import annotations

from dataclasses import dataclass

from ttt_video_dit_torch.config.model_config import ModelConfig

# Dense bf16 tensor-core peak of one NVIDIA H100 SXM (NVIDIA's data sheet, at 700 W).
H100_BF16_DENSE_FLOPS = 989e12


def device_peak_flops() -> float:
    return H100_BF16_DENSE_FLOPS


@dataclass(frozen=True)
class FlopBreakdown:
    attention_proj: float
    attention_sdpa: float
    mlp: float
    ttt_proj: float
    ttt_scan: float
    embed_head: float

    @property
    def total(self) -> float:
        return (
            self.attention_proj + self.attention_sdpa + self.mlp + self.ttt_proj + self.ttt_scan + self.embed_head
        )


def dit_forward_flops(cfg: ModelConfig, batch_size: int, text_length: int) -> FlopBreakdown:
    """Matmul FLOPs of one DiT forward at this config's geometry."""
    D = cfg.model_dim
    Hn, F = cfg.num_heads, cfg.head_dim
    T = cfg.compressed_num_frames
    tpf = cfg.tokens_per_frame
    C = cfg.num_chunks
    TL = text_length
    L_layers = cfg.num_layers
    B = batch_size

    L_seq = C * TL + T * tpf  # full sequence (text + video tokens)
    WF = cfg.prefix_temporal_length + cfg.attn_length
    S_win = TL + WF * tpf  # tokens per attention window
    attn_tokens = C * S_win  # total tokens fed through attention projections

    # Segment-local attention: q/k/v/o projections + SDPA per window.
    attention_proj = L_layers * B * 4 * 2 * attn_tokens * D * D
    attention_sdpa = L_layers * B * C * 2 * 2 * S_win * S_win * D  # QK^T + AV

    # MLP: two D<->4D matmuls over the full sequence.
    mlp = L_layers * B * 2 * 2 * L_seq * D * 4 * D

    # TTT: two directions; wq/wk/wv/wo projections each direction.
    ttt_proj = L_layers * 2 * B * 4 * 2 * L_seq * D * D

    # TTT inner scan per mini-batch of CS tokens per head (dual form):
    CS = cfg.mini_batch_size
    if cfg.ssm_layer == "ttt_linear":
        # Z1 (CS,F,F); Attn1 (CS,CS,F); Attn@G (CS,CS,F); XQ@W1 (CS,F,F);
        # W1 update (F,CS,F)  => 3*CS*F^2 + 2*CS^2*F   (x2 flops per MAC)
        per_token = 2 * (3 * F * F + 2 * CS * F)
    else:
        # 7 F<->4F matmuls (Z1, Z2, gZ1, Z1_bar, Z2_bar, W1/W2 updates) plus
        # 4 CS x CS mixing terms (Attn1, Attn1@G1, Attn2, Attn2@G2).
        per_token = 2 * (7 * 4 * F * F + CS * (2 * F + 2 * 4 * F))
    ttt_scan = L_layers * 2 * B * Hn * L_seq * per_token

    # Patch embed + text proj + final layer + adaLN modulations.
    embed_head = B * (
        2 * T * tpf * (cfg.patch_size**2 * cfg.in_channels) * D  # patchify
        + 2 * C * TL * cfg.text_dim * D
        + 2 * T * tpf * D * (cfg.patch_size**2 * cfg.out_channels)
        + L_layers * 2 * 2 * cfg.time_embed_dim * 6 * D
    )
    return FlopBreakdown(attention_proj, attention_sdpa, mlp, ttt_proj, ttt_scan, embed_head)


def train_step_flops(cfg: ModelConfig, batch_size: int, text_length: int) -> float:
    return 3.0 * dit_forward_flops(cfg, batch_size, text_length).total


def mfu(step_flops: float, step_time_s: float, n_devices: int = 1) -> float:
    return step_flops / (step_time_s * n_devices * device_peak_flops())
