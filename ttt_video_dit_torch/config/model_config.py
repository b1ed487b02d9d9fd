"""Model architecture configuration and presets.

The port's own copy of ttt_video_dit_tpu/config/model_config.py: same fields,
defaults and presets (tests/test_torch_entry.py holds it to the original).
The port imports nothing of the JAX package.

Mirrors the knobs of the reference's ``ModelConfig``
(reference: ttt/models/configs.py:8-126) — same preset names ("debug", "5B"),
same video-duration presets (3sec..63sec latent frame counts), same TTT knobs —
so reference TOML configs and checkpoints map over directly.
"""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass
from typing import TYPE_CHECKING

if TYPE_CHECKING:
    from ttt_video_dit_torch.config.job_config import JobConfig

PREDEFINED_CONFIGS = {
    "debug": {"model_dim": 512, "num_heads": 8, "num_layers": 6},
    "5B": {"model_dim": 3072, "num_heads": 48, "num_layers": 42, "text_dim": 4096},
}

VIDEO_DURATION_CONFIGS = {
    "3sec": {"compressed_num_frames": 13},
    "9sec": {"compressed_num_frames": 37},
    "18sec": {"compressed_num_frames": 73},
    "30sec": {"compressed_num_frames": 121},
    "63sec": {"compressed_num_frames": 253},
}


@dataclass
class ModelConfig:
    model_dim: int
    num_heads: int
    num_layers: int

    ssm_layer: str = "ttt_mlp"  # "ttt_mlp" | "ttt_linear"
    layer_norm_eps: float = 1e-6

    # TTT inner-loop knobs
    mini_batch_size: int = 64
    ttt_base_lr: float = 0.1
    rope_theta: float = 10000.0
    scan_checkpoint_group_size: int = 16
    # Pallas TTT kernels vs. pure lax.scan oracle. Both directions are fused
    # Pallas kernels and beat the XLA scan (v5e, 3s geometry, 16 heads:
    # fwd 10.4 vs 14.4 ms; fwd+bwd 32.9 vs 42.1 ms); the oracle remains the
    # numerical reference (parity-tested values and gradients).
    use_kernel: bool = True
    # Fused Pallas backward (ttt_backward.py) vs the hybrid XLA
    # checkpoint-group backward (ttt_vjp.py fallback); both parity-tested.
    use_fused_backward: bool = True
    # Fuse the TTT preprocessing (L2-norm + rope + LN-reconstruction target,
    # plus its backward) into the Pallas kernels instead of XLA elementwise
    # passes (~100 ms/step of fusions + layout copies at the d3072 bench
    # geometry). Requires use_kernel + use_fused_backward.
    fuse_ttt_preproc: bool = True

    adapter_method: str = "none"  # none | sft | qkvo

    # Network
    time_embed_dim: int = 512
    sigma_interval: int = 1000
    patch_size: int = 2
    in_channels: int = 16
    out_channels: int = 16
    scale_factor: float = 1.0

    # Rope / latent geometry
    latent_height: int = 30
    latent_width: int = 45
    compressed_num_frames: int = 13
    theta: float = 10000.0

    # Text conditioning
    text_dim: int = 512

    # Segment-local attention
    gating_alpha_init: float = 0.1
    attn_length: int = 12  # frames of fresh context per attention window
    prefix_temporal_length: int = 1  # overlapping prefix frames per window

    # Compile the layer stack as one lax.scan over stacked params instead of
    # an unrolled Python loop: HLO size (and compile time) stops scaling with
    # depth (measured v5e: 42 unrolled layers compile in ~15 min). Param tree
    # becomes {scan_layers/layer/...: [L, ...]} — use stack_layer_params() to
    # convert checkpoints; the HF converter targets the unrolled layout.
    scan_layers: bool = False
    # Splash-attention block profile. The kernel shares the Mosaic
    # scoped-vmem stack with remat fusions, which at the old 16 MB limit
    # forced a vmem-lean 1024-block profile under scan-over-layers
    # (ops/attention.py:_splash_spec). At the 100 MB scoped limit the tuned
    # blocks fit beside the scan loop everywhere measured and are faster
    # (d3072x4L scan 36.06 vs 31.43 % MFU, d512x42L 25.2 vs 17.7), so the
    # default is tuned; set True to force lean (the recovery knob for a
    # Mosaic scoped-vmem compile error at an untried geometry).
    splash_lean_blocks: bool | None = None
    # Remat
    # Wrap each layer group in jax.checkpoint (the reference always does,
    # reference: dit.py:494-502); disable for single-chip benches where
    # activations fit HBM and recompute is pure overhead.
    remat_transformer_layers: bool = True
    remat_transformer_layer_group_size: int = 1
    remat_forward_ssm: bool = False
    remat_reverse_ssm: bool = False
    remat_attention: bool = False
    remat_mlp: bool = False
    remat_seq_modeling_block: bool = False
    shard_transformer_inputs: bool = False
    # Checkpoint policy applied to every remat region: "none" | "save_seq"
    # (save the splash/TTT sequential-kernel residuals so remat recompute
    # covers only dense matmuls + elementwise — the sequential scans never
    # run twice; see models/dit/dit.py:_ckpt_policy).
    remat_policy: str = "none"

    # Computation dtype ("bfloat16" | "float32"); params are always float32.
    dtype: str = "bfloat16"

    @property
    def head_dim(self) -> int:
        return self.model_dim // self.num_heads

    @property
    def tokens_per_frame(self) -> int:
        """latent_height/width are already the *token grid* dims (latent
        pixels / patch_size): 30 x 45 = 1350 tokens per 480x720 frame
        (reference: configs.py:35-37, dit.py:475)."""
        return self.latent_height * self.latent_width

    @property
    def num_chunks(self) -> int:
        """Number of 3-second attention segments in the configured duration."""
        return max(1, (self.compressed_num_frames - self.prefix_temporal_length) // self.attn_length)

    def approx_param_count(self) -> int:
        """Rough total parameter count (dominant matmul kernels only) — used
        to size the splash fused-backward scratch budget against the HBM the
        training state occupies (ops/attention.py:_fused_bwd_ok). Per layer:
        attention q/k/v/o (4 D^2) + MLP (8 D^2) + TTT wq/wk/wv/wo (4 D^2) +
        adaLN vid/text modulations (12 D T_e) + TTT fast weights (8 F^2 H).
        Bias/norm/gate terms are noise at these widths."""
        D, L, Te, F, H = self.model_dim, self.num_layers, self.time_embed_dim, self.head_dim, self.num_heads
        per_layer = 16 * D * D + 12 * D * Te + 8 * F * F * H
        stem = self.text_dim * D + 2 * Te * Te + 4 * self.in_channels * D
        return L * per_layer + stem

    @classmethod
    def get_preset(cls, preset: str, video_length: str, job_config: "JobConfig | None" = None) -> "ModelConfig":
        if preset not in PREDEFINED_CONFIGS:
            raise ValueError(f"Unknown model preset {preset!r}; options: {sorted(PREDEFINED_CONFIGS)}")
        if video_length not in VIDEO_DURATION_CONFIGS:
            raise ValueError(f"Unknown video duration {video_length!r}; options: {sorted(VIDEO_DURATION_CONFIGS)}")
        config = cls(**PREDEFINED_CONFIGS[preset], **VIDEO_DURATION_CONFIGS[video_length])
        if job_config is not None:
            config.update(job_config)
        return config

    def update(self, job_config: "JobConfig") -> None:
        if job_config.training.adapter_method is not None:
            self.adapter_method = job_config.training.adapter_method

        self.scale_factor = job_config.model.scale_factor

        self.remat_transformer_layer_group_size = job_config.remat.transformer_checkpoint_layer_group_size
        self.remat_forward_ssm = job_config.remat.forward_ssm
        self.remat_reverse_ssm = job_config.remat.reverse_ssm
        self.remat_attention = job_config.remat.attention
        self.remat_mlp = job_config.remat.mlp
        self.remat_seq_modeling_block = job_config.remat.seq_modeling_block
        self.shard_transformer_inputs = job_config.remat.shard_transformer_inputs
        self.remat_policy = job_config.remat.policy

        self.ssm_layer = job_config.model.ssm_layer
        self.mini_batch_size = job_config.model.mini_batch_size
        self.ttt_base_lr = job_config.model.ttt_base_lr
        self.use_fused_backward = job_config.model.use_fused_backward
        self.fuse_ttt_preproc = job_config.model.fuse_ttt_preproc
        self.scan_layers = job_config.model.scan_layers
        self.splash_lean_blocks = {"auto": None, "on": True, "off": False}[job_config.model.splash_lean_blocks]
        if job_config.model.latent_height is not None:
            self.latent_height = job_config.model.latent_height
        if job_config.model.latent_width is not None:
            self.latent_width = job_config.model.latent_width
        if job_config.model.num_layers is not None:
            self.num_layers = job_config.model.num_layers
        if job_config.model.model_dim is not None:
            self.model_dim = job_config.model.model_dim
        if job_config.model.num_heads is not None:
            self.num_heads = job_config.model.num_heads
        # TOML configs may express this as 1e6 (float) to disable checkpoints.
        self.scan_checkpoint_group_size = int(job_config.remat.scan_checkpoint_group_size)
        self.dtype = job_config.parallelism.fsdp_unsharded_dtype

    def __str__(self) -> str:
        return json.dumps(asdict(self), indent=4)


@dataclass
class VaeModelConfig:
    """3D causal VAE architecture knobs (reference: ttt/models/configs.py:128-160)."""

    double_z: bool = True
    z_channels: int = 16
    resolution: int = 256
    in_channels: int = 3
    out_ch: int = 3
    ch: int = 128
    ch_mult: tuple = (1, 2, 2, 4)
    attn_resolutions: tuple = ()
    num_res_blocks: int = 3
    dropout: float = 0.0
    gather_norm: bool = True
    temporal_tiling_window: int = 16
    use_silu: bool = False

    @classmethod
    def get_encoder_config(cls, version: float = 1.0, temporal_tiling_window: int = 16) -> "VaeModelConfig":
        if version == 1.0:
            return cls(temporal_tiling_window=temporal_tiling_window)
        if version == 1.5:
            return cls(use_silu=True, temporal_tiling_window=temporal_tiling_window)
        raise ValueError("ver1.0 or ver1.5 supported")

    @classmethod
    def get_decoder_config(cls, version: float = 1.0, temporal_tiling_window: int = 2) -> "VaeModelConfig":
        if version == 1.0:
            return cls(gather_norm=False, temporal_tiling_window=temporal_tiling_window)
        if version == 1.5:
            return cls(gather_norm=False, use_silu=True, temporal_tiling_window=temporal_tiling_window)
        raise ValueError("ver1.0 or ver1.5 supported")
