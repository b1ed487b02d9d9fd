"""HF CogVideoX-5b transformer shards -> the port's DiT state dict (port of
ttt_video_dit_tpu/models/dit/from_hf.py).

The same key map as the JAX package's: every diffusers name it takes
(``transformer_blocks.<i>.attn1.to_q.weight``, ``patch_embed.proj.weight``,
``norm_out.linear.bias``, ...) maps to the port's key. HF's Linear weights
are already [out, in] and its patch conv already OIHW, so no tensor is
transposed. TTT parameters keep their initialisation (the reference loads
with strict=False for the same reason). The shards stream through
``utils/safetensors.py`` one tensor at a time and land as float32 masters.

CLI (counterpart of scripts/convert_from_hf.py): builds the model the
sampling entry builds from the same flags, on the CPU with random weights
from ``--job.seed``, overlays the HF tensors, and writes it with
``training/checkpoint.py:save_pretrained`` for ``--checkpoint.init_state_dir``:

    python -m ttt_video_dit_torch.models.dit.from_hf --hf-dir /ckpts/CogVideoX-5b/transformer \\
        --output /ckpts/ttt-torch/cogvideox-5b-init [--job.config_file TOML --model.num_layers N]

Flags other than ``--hf-dir``, ``--output`` and ``--ssm-layer`` are the
sampling entry's (``JobConfig``) flags. The TTT variant is the model's
(``--model.ssm_layer`` or the TOML's); ``--ssm-layer``, where given,
overrides it.
"""

from __future__ import annotations

import argparse

import torch

from ttt_video_dit_torch.utils import safetensors

_TOP = {
    "patch_embed.proj.weight": "patch_embedding.vid_proj.weight",
    "patch_embed.proj.bias": "patch_embedding.vid_proj.bias",
    "patch_embed.text_proj.weight": "patch_embedding.text_proj.weight",
    "patch_embed.text_proj.bias": "patch_embedding.text_proj.bias",
    "norm_final.weight": "transformer_norm.weight",
    "norm_final.bias": "transformer_norm.bias",
    "norm_out.norm.weight": "final_layer.norm.weight",
    "norm_out.norm.bias": "final_layer.norm.bias",
    "norm_out.linear.weight": "final_layer.adaLN_modulation.weight",
    "norm_out.linear.bias": "final_layer.adaLN_modulation.bias",
    "proj_out.weight": "final_layer.linear.weight",
    "proj_out.bias": "final_layer.linear.bias",
    "time_embedding.linear_1.weight": "time_embed_0.weight",
    "time_embedding.linear_1.bias": "time_embed_0.bias",
    "time_embedding.linear_2.weight": "time_embed_2.weight",
    "time_embedding.linear_2.bias": "time_embed_2.bias",
}
_BLOCK = {
    "attn1.norm_q": "seq_modeling_block.attention.q_norm",
    "attn1.norm_k": "seq_modeling_block.attention.k_norm",
    "attn1.to_q": "seq_modeling_block.attention.q",
    "attn1.to_k": "seq_modeling_block.attention.k",
    "attn1.to_v": "seq_modeling_block.attention.v",
    "attn1.to_out.0": "seq_modeling_block.attention.o",
    "ff.net.0.proj": "mlp.layer1",
    "ff.net.2": "mlp.layer2",
    "norm1.linear": "pre_seq_adaLN_modulation",
    "norm1.norm": "pre_seq_layernorm",
    "norm2.linear": "pre_mlp_adaLN_modulation",
    "norm2.norm": "pre_mlp_layernorm",
}


def hf_key(key: str):
    """The port's state-dict key for one HF tensor name, or None for a name
    the map does not take. Names match as substrings, in the JAX map's order,
    so the two maps take the same names."""
    for hf_name, name in _TOP.items():
        if hf_name in key:
            return "dit." + name
    if "transformer_blocks" in key:
        layer = key.split(".")[1]
        for hf_name, name in _BLOCK.items():
            for leaf in ("weight", "bias"):
                if f".{hf_name}.{leaf}" in key:
                    return f"dit.layers.{layer}.{name}.{leaf}"
    return None


def map_hf_tensor(key: str, value: torch.Tensor):
    """(the port's state-dict key, the tensor) for one HF tensor, or None for
    a name the map does not take (HF's layouts are the port's: no transpose)."""
    name = hf_key(key)
    return None if name is None else (name, value)


def convert_hf_checkpoint(hf_dir: str, model: torch.nn.Module) -> int:
    """Overlay HF CogVideoX weights (a safetensors file or shard directory)
    onto ``model`` (a ``CogVideoX``) in place, as float32. Every mapped tensor
    must name one of the model's parameters, at its shape. Returns the count
    of tensors mapped; the rest (TTT parameters) keep their values."""
    return safetensors.load_into(model, hf_dir, rename=hf_key, strict=False)


def converted_model(hf_dir: str, cfg, seed: int = 0):
    """A float32 ``CogVideoX`` of ``cfg`` on the CPU: random weights from
    ``seed`` (init_params_, as the entries draw them), then the HF tensors.
    Returns (model, number of tensors mapped)."""
    from ttt_video_dit_torch.models.dit.diffusion import CogVideoX
    from ttt_video_dit_torch.models.dit.dit import init_params_

    model = CogVideoX(cfg)
    init_params_(model, torch.Generator().manual_seed(seed))
    return model, convert_hf_checkpoint(hf_dir, model)


def main(argv=None) -> int:
    from ttt_video_dit_torch.sample import model_config, parse_args
    from ttt_video_dit_torch.training.checkpoint import save_pretrained

    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--hf-dir", required=True, help="HF CogVideoX transformer: a safetensors file or shard dir")
    parser.add_argument("--output", required=True, help="directory for the port's params-only checkpoint")
    parser.add_argument("--ssm-layer", choices=["ttt_mlp", "ttt_linear"],
                        help="override the model's TTT variant (default: the TOML's or --model.ssm_layer)")
    args, rest = parser.parse_known_args(argv)
    job = parse_args(rest)
    cfg = model_config(job)
    if args.ssm_layer:
        cfg.ssm_layer = args.ssm_layer
    print(f"building d{cfg.model_dim} x {cfg.num_heads} heads x {cfg.num_layers} layers ({cfg.ssm_layer}) on the CPU; "
          "TTT parameters keep this init", flush=True)
    model, n_mapped = converted_model(args.hf_dir, cfg, job.job.seed)
    print(f"mapped {n_mapped} HF tensors", flush=True)
    save_pretrained(args.output, model)
    print(f"saved params-only checkpoint to {args.output}", flush=True)
    return n_mapped


if __name__ == "__main__":
    main()
