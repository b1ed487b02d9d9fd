"""Job configuration: dataclass sections auto-reflected into argparse flags and
merged with TOML files.

The port's own copy of ttt_video_dit_tpu/config/job_config.py: same fields,
defaults and presets (tests/test_torch_entry.py holds it to the original).
The port imports nothing of the JAX package.

Mirrors the section/field names of the reference config system
(reference: ttt/infra/config_manager.py) so the reference's ``configs/*.toml``
files port 1:1. Precedence: command line > TOML > dataclass default.

TPU-specific differences from the reference:
- ``[parallelism]`` keeps ``dp_replicate`` / ``dp_sharding`` / ``tp_sharding``
  but they now size the axes of one global ``jax.sharding.Mesh`` instead of a
  torch DeviceMesh (reference: ttt/infra/parallelisms.py:57-89).
- ``[comm]`` timeouts are unnecessary under XLA collectives; the section is
  accepted (so reference TOMLs parse) but ignored.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tomllib
from collections import defaultdict
from dataclasses import dataclass, field, fields
from typing import Any, Dict, Optional, Type, Union, get_args, get_origin, get_type_hints


def _optional_base_type(annotation) -> type:
    """The X of an ``Optional[X]`` annotation when X is a scalar CLI type;
    str otherwise (argparse needs a concrete converter for None-default
    fields, and `type(None)` defaults are annotation-only information)."""
    if annotation is not None and get_origin(annotation) is Union:
        args = [a for a in get_args(annotation) if a is not type(None)]
        if len(args) == 1 and args[0] in (int, float, str):
            return args[0]
    return str


@dataclass
class JobSection:
    """Job-level options."""

    config_file: Optional[str] = field(default=None, metadata={"help": "Job config file (TOML)"})
    exp_name: str = field(default="default job", metadata={"help": "Description of the job"})
    dump_folder: str = field(
        default=os.path.join(os.getcwd(), "exp"), metadata={"help": "Location to dump logs/checkpoints"}
    )
    seed: int = field(default=42, metadata={"help": "Random seed for the job"})
    profile_dir: Optional[str] = field(
        default=None, metadata={"help": "Capture a jax.profiler trace of steps 10-13 into this directory"}
    )
    platform: Optional[str] = field(
        default=None,
        metadata={"help": "Force a JAX platform (e.g. 'cpu' for local smokes; env overrides may be ignored)"},
    )


@dataclass
class ModelSection:
    """Model options."""

    name: str = field(default="cogvideo", metadata={"help": "Which model to train", "choices": ["cogvideo"]})
    size: str = field(default="5B", metadata={"help": "Which model size to train (debug, 5B)"})
    video_length: str = field(default="3sec", metadata={"help": "Video duration preset (3sec..63sec)"})
    norm_eps: float = field(default=1e-6, metadata={"help": "Eps of layer normalization"})
    scale_factor: float = field(default=1.0, metadata={"help": "Latent scale factor"})
    ssm_layer: str = field(
        default="ttt_mlp",
        metadata={"help": "Type of TTT layer", "choices": ["ttt_mlp", "ttt_linear"]},
    )
    ttt_base_lr: float = field(default=0.1, metadata={"help": "Base inner-loop learning rate for TTT"})
    mini_batch_size: int = field(default=64, metadata={"help": "TTT inner-loop mini-batch size"})
    use_fused_backward: bool = field(
        default=True,
        metadata={"help": "Fused Pallas TTT backward kernels (vs XLA checkpoint-group recompute)"},
    )
    fuse_ttt_preproc: bool = field(
        default=True,
        metadata={"help": "Fuse TTT preprocessing (L2-norm/rope/LN-target) into the Pallas kernels"},
    )
    latent_height: Optional[int] = field(
        default=None, metadata={"help": "Override latent token-grid height (debug/smoke geometries)"}
    )
    latent_width: Optional[int] = field(
        default=None, metadata={"help": "Override latent token-grid width (debug/smoke geometries)"}
    )
    num_layers: Optional[int] = field(
        default=None,
        metadata={"help": "Override preset depth (depth-reduced evals; e.g. the single-chip "
                  "real-width fabricated-5B sample artifact)"},
    )
    model_dim: Optional[int] = field(
        default=None, metadata={"help": "Override preset model dim (width-reduced smoke runs)"}
    )
    num_heads: Optional[int] = field(
        default=None, metadata={"help": "Override preset head count (with --model.model_dim)"}
    )
    scan_layers: bool = field(
        default=False,
        metadata={
            "help": "lax.scan over transformer layers: one-layer HLO regardless of "
            "depth (the 42-layer configuration; params become stacked [L, ...])",
            "action": "store_true",
        },
    )
    splash_lean_blocks: str = field(
        default="auto",
        metadata={
            "help": "Splash-attention block profile: 'auto'/'off' use the tuned "
            "blocks (measured faster everywhere at the 100 MB scoped-vmem limit, "
            "docs/performance.md); 'on' forces the vmem-lean 1024 profile (the "
            "recovery knob for a Mosaic scoped-vmem compile error)",
            "choices": ["auto", "on", "off"],
        },
    )


@dataclass
class TrainingSection:
    """Training options."""

    adapter_method: Optional[str] = field(
        default=None,
        metadata={"help": "Fine-tuning method: sft (full) or qkvo (adapters)", "choices": ["sft", "qkvo"]},
    )
    dataset_path: Optional[str] = field(default=None, metadata={"help": "Path to the dataset root"})
    jsonl_paths: Optional[str] = field(default=None, metadata={"help": "JSONL metadata path(s), comma separated"})
    global_batch_size: int = field(default=8, metadata={"help": "Global batch size"})
    grad_accum_steps: int = field(default=1, metadata={"help": "Gradient accumulation steps"})
    warmup_steps: int = field(default=50, metadata={"help": "LR scheduler warmup steps"})
    steps: int = field(default=5000, metadata={"help": "How many train steps to run"})
    gc_freq: int = field(default=50, metadata={"help": "Python GC interval, in steps"})
    text_dropout_prob: float = field(default=0.1, metadata={"help": "Per-sample text-conditioning dropout"})


@dataclass
class EvalSection:
    """Sampling/eval options (only parsed in eval mode)."""

    input_file: Optional[str] = field(default=None, metadata={"help": "Path to a json/jsonl storyboard file"})
    output_dir: str = field(default="./output", metadata={"help": "Directory for generated results"})

    image_width: int = field(default=720, metadata={"help": "Width of the generated video"})
    image_height: int = field(default=480, metadata={"help": "Height of the generated video"})
    sampling_fps: int = field(default=16, metadata={"help": "Frames per second of generated video"})
    sampling_num_frames: int = field(default=13, metadata={"help": "Number of latent frames to sample"})
    latent_channels: int = field(default=16, metadata={"help": "Number of latent channels"})

    num_denoising_steps: int = field(default=50, metadata={"help": "Number of denoising steps"})
    scale_factor: float = field(default=0.7, metadata={"help": "Latent scale factor for sampling"})
    dtype: str = field(default="bfloat16", metadata={"help": "Sampling dtype", "choices": ["bfloat16", "float32"]})

    vae_checkpoint_path: Optional[str] = field(default=None, metadata={"help": "VAE checkpoint for decoding"})
    vae_scale_factor: float = field(default=1.0, metadata={"help": "Scale factor used during VAE decoding"})

    txt_maxlen: int = field(default=498, metadata={"help": "Maximum token length for T5 input"})
    t5_model_dir: Optional[str] = field(default=None, metadata={"help": "Directory path to the T5 model"})
    t5_backend: str = field(
        default="auto",
        metadata={
            "help": "Text-encoder backend of the JAX package (flax on-device, torch on the host); the PyTorch "
            "port has one backend, its own T5 encoder on the entry's device, and ignores this",
            "choices": ["auto", "flax", "torch"],
        },
    )


@dataclass
class GuiderSection:
    """Classifier-free guidance options."""

    scale: int = field(default=6, metadata={"help": "CFG scale"})
    exp: int = field(default=5, metadata={"help": "Dynamic CFG cosine-ramp exponent"})
    num_steps: int = field(default=50, metadata={"help": "Number of guidance steps"})


@dataclass
class DenoiserSection:
    """Denoiser options."""

    num_idx: int = field(default=1000, metadata={"help": "Number of discretization indices"})
    quantize_c_noise: bool = field(default=False, metadata={"help": "Quantize c_noise", "action": "store_true"})


@dataclass
class DiscretizationSection:
    """Discretization options."""

    shift_scale: float = field(default=1.0, metadata={"help": "Shift scale for the discretization"})


@dataclass
class OptimizerSection:
    """Optimizer options."""

    name: str = field(default="AdamW", metadata={"help": "Optimizer", "choices": ["AdamW"]})
    lr: float = field(default=1e-4, metadata={"help": "LR for non-TTT parameters"})
    lr_end: float = field(default=0.0, metadata={"help": "Final LR after decay (all groups)"})
    lr_ssm: float = field(default=1e-4, metadata={"help": "LR for TTT parameters"})
    lr_schedule: str = field(default="linear", metadata={"help": "LR schedule [cosine, linear]"})
    lr_ssm_schedule: str = field(default="linear", metadata={"help": "TTT LR schedule [cosine, linear]"})
    gradient_clipping_norm: float = field(default=0.1, metadata={"help": "Global gradient-norm clip"})


@dataclass
class CheckpointSection:
    """Checkpoint options."""

    init_state_dir: Optional[str] = field(default=None, metadata={"help": "Path to pretrained model weights"})
    interval: int = field(default=0, metadata={"help": "Checkpoint interval in steps (0 = off)"})
    resume: bool = field(default=False, metadata={"help": "Resume experiment", "action": "store_true"})
    resume_step: int = field(default=-1, metadata={"help": "Step to resume from (-1 = latest)"})
    timeout_minutes: int = field(default=0, metadata={"help": "Job wall clock, for timeout-aware checkpointing"})


@dataclass
class ParallelismSection:
    """Parallelism options — sizes of the global mesh axes (replica, fsdp, tensor)."""

    fsdp_unsharded_dtype: str = field(
        default="bfloat16",
        metadata={"help": "Computation dtype", "choices": ["float32", "bfloat16"]},
    )
    tp_sharding: int = field(default=1, metadata={"help": "Size of the 'tensor' mesh axis"})
    dp_sharding: int = field(default=8, metadata={"help": "Size of the 'fsdp' mesh axis"})
    dp_replicate: int = field(default=1, metadata={"help": "Size of the 'replica' mesh axis"})


@dataclass
class RematSection:
    """Rematerialization (activation checkpointing) options."""

    transformer_checkpoint_layer_group_size: int = field(
        default=1, metadata={"help": "Number of transformer layers per remat group"}
    )
    scan_checkpoint_group_size: int = field(default=16, metadata={"help": "TTT scan checkpoint group size"})
    forward_ssm: bool = field(default=False, metadata={"help": "Remat forward TTT", "action": "store_true"})
    reverse_ssm: bool = field(default=False, metadata={"help": "Remat reverse TTT", "action": "store_true"})
    attention: bool = field(default=False, metadata={"help": "Remat attention", "action": "store_true"})
    mlp: bool = field(default=False, metadata={"help": "Remat MLP", "action": "store_true"})
    seq_modeling_block: bool = field(
        default=False, metadata={"help": "Remat the whole sequence-modeling block", "action": "store_true"}
    )
    shard_transformer_inputs: bool = field(
        default=False,
        metadata={"help": "Shard inter-layer-group activations over the tensor axis", "action": "store_true"},
    )
    policy: str = field(
        default="none",
        metadata={
            "help": "Remat checkpoint policy: 'none' recomputes everything inside "
            "a rematted region; 'save_seq' saves the sequential-kernel residuals "
            "(splash attention out+logsumexp, TTT scan output + state checkpoints) "
            "so only the cheap dense/elementwise work is recomputed"
        },
    )


@dataclass
class CommSection:
    """Communication options.

    Accepted so reference TOMLs parse; XLA collectives need no timeout plumbing.
    """

    init_timeout_seconds: int = field(default=1200, metadata={"help": "(ignored on TPU)"})


@dataclass
class WandBSection:
    """Weights & Biases options."""

    disable: bool = field(default=False, metadata={"help": "Disable WandB logging", "action": "store_true"})
    project: str = field(default="ttt-video", metadata={"help": "WandB project name"})
    entity: str = field(default="default", metadata={"help": "WandB entity name"})
    log_interval: int = field(default=50, metadata={"help": "WandB log interval"})
    alert: bool = field(default=False, metadata={"help": "Send alerts on milestones", "action": "store_true"})


_TRAIN_SECTIONS: Dict[str, Type] = {
    "job": JobSection,
    "model": ModelSection,
    "training": TrainingSection,
    "optimizer": OptimizerSection,
    "checkpoint": CheckpointSection,
    "parallelism": ParallelismSection,
    "remat": RematSection,
    "comm": CommSection,
    "wandb": WandBSection,
}

_EVAL_SECTIONS: Dict[str, Type] = {
    "eval": EvalSection,
    "guider": GuiderSection,
    "denoiser": DenoiserSection,
    "discretization": DiscretizationSection,
}


class JobConfig:
    """Parses ``--section.field`` flags merged with a TOML config file.

    Usage::

        config = JobConfig()            # or JobConfig(eval_mode=True)
        config.parse_args([...])
        config.model.size               # "5B"
    """

    job: JobSection
    model: ModelSection
    training: TrainingSection
    optimizer: OptimizerSection
    checkpoint: CheckpointSection
    parallelism: ParallelismSection
    remat: RematSection
    comm: CommSection
    wandb: WandBSection
    eval: EvalSection
    guider: GuiderSection
    denoiser: DenoiserSection
    discretization: DiscretizationSection

    def __init__(self, eval_mode: bool = False):
        self._sections: Dict[str, Type] = dict(_TRAIN_SECTIONS)
        if eval_mode:
            self._sections.update(_EVAL_SECTIONS)

        for name, cls in self._sections.items():
            setattr(self, name, cls())

        self.config_map: Optional[Dict[str, Dict[str, Any]]] = None
        self.parser = argparse.ArgumentParser(description="ttt-video-dit-tpu arg parser")
        self._build_parser()

    def _build_parser(self) -> None:
        for section_name, section_cls in self._sections.items():
            hints = get_type_hints(section_cls)
            for f in fields(section_cls):
                arg_name = f"--{section_name}.{f.name}"
                meta = f.metadata
                kwargs: Dict[str, Any] = {"help": meta.get("help", "")}
                action = meta.get("action")
                if action:
                    kwargs["action"] = action
                else:
                    if f.default is None:
                        # Optional[X]: parse as X from the dataclass annotation
                        # (a str-parsed `--model.latent_height 4` would poison
                        # shape math downstream); default None either way.
                        kwargs["type"] = _optional_base_type(hints.get(f.name))
                        kwargs["default"] = None
                    else:
                        kwargs["type"] = type(f.default)
                        kwargs["default"] = f.default
                    if meta.get("choices"):
                        kwargs["choices"] = meta["choices"]
                self.parser.add_argument(arg_name, **kwargs)

    def parse_args(self, args_list=None) -> "JobConfig":
        if args_list is None:
            args_list = sys.argv[1:]
        args, cmd_args = self._parse_cmdline(args_list)

        args_dict = self._to_two_level_dict(args)
        config_file = args_dict.get("job", {}).get("config_file")
        if config_file is not None:
            with open(config_file, "rb") as f:
                for k, v in tomllib.load(f).items():
                    args_dict[k] |= v

        # Command line overrides TOML.
        for section, section_args in self._to_two_level_dict(cmd_args).items():
            for k, v in section_args.items():
                args_dict[section][k] = v

        self.config_map = dict(args_dict)

        for section_name, values in args_dict.items():
            if section_name not in self._sections:
                continue  # e.g. eval sections in a train-mode parse
            section_cls = self._sections[section_name]
            valid = {f.name for f in fields(section_cls)}
            unexpected = set(values) - valid
            if unexpected:
                raise TypeError(
                    f"Invalid field(s) in [{section_name}]: {', '.join(sorted(unexpected))}. "
                    f"Valid fields: {', '.join(sorted(valid))}"
                )
            setattr(self, section_name, section_cls(**values))

        self._validate()
        return self

    def _parse_cmdline(self, args_list):
        args = self.parser.parse_args(args_list)
        # Aux parser captures only explicitly-passed flags (no defaults), so
        # command line can override TOML without clobbering unspecified keys.
        aux = argparse.ArgumentParser(argument_default=argparse.SUPPRESS)
        for arg, val in vars(args).items():
            if isinstance(val, bool):
                aux.add_argument("--" + arg, action="store_true" if val else "store_false")
            else:
                aux.add_argument("--" + arg, type=type(val) if val is not None else str)
        cmd_args, _ = aux.parse_known_args(args_list)
        return args, cmd_args

    @staticmethod
    def _to_two_level_dict(args: argparse.Namespace) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = defaultdict(dict)
        for k, v in vars(args).items():
            section, key = k.split(".", 1)
            out[section][key] = v
        return out

    def _validate(self) -> None:
        assert self.model.name, "model.name required"
        assert self.model.size, "model.size required"
        if self.remat.shard_transformer_inputs:
            assert self.parallelism.tp_sharding > 1, "Sharding transformer inputs requires tensor parallelism"

    def to_dict(self) -> dict:
        assert self.config_map is not None, "parse_args must run before to_dict"
        return self.config_map

    def __str__(self) -> str:
        return json.dumps(self.to_dict(), indent=4, default=str)
