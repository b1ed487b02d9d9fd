"""The PyTorch port's entries on the ttt-linear TOMLs on a CPU-only host
(python -m ttt_video_dit_torch.sample / .train with ``--job.platform cpu``)
at a tiny size, and the FLOP count the training entry's MFU uses for
``ttt_linear``, against the JAX package's.
"""

from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttt_video_dit_torch import sample, train  # noqa: E402
from ttt_video_dit_torch.utils import metrics as t_metrics  # noqa: E402
from ttt_video_dit_tpu.utils import metrics as j_metrics  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


TINY_LINEAR_TRAIN = [
    "--job.config_file", "configs/train/ttt-linear/3s.toml", "--model.num_layers", "2", "--model.model_dim", "128",
    "--model.num_heads", "2", "--model.latent_height", "2", "--model.latent_width", "2", "--training.steps", "2",
    "--training.global_batch_size", "1", "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1",
    "--job.platform", "cpu",
]


def test_train_entry_runs_ttt_linear_on_cpu(tmp_path, monkeypatch):
    """train.main on configs/train/ttt-linear/3s.toml at a tiny size on the CPU:
    two finite steps, the qkvo adapter freezing the MLP, adaLN and embedding
    weights while the TTT state trains, the layer stack pinned (scan_layers),
    and the MFU numerator is utils/metrics.py's ttt_linear count, the JAX
    package's."""
    monkeypatch.chdir(REPO)
    summary = train.main(train.parse_args(TINY_LINEAR_TRAIN + ["--job.dump_folder", str(tmp_path)]))
    cfg, model = summary["model_config"], summary["model"]
    assert cfg.ssm_layer == "ttt_linear" and cfg.adapter_method == "qkvo" and cfg.scan_layers
    assert len(summary["losses"]) == 2 and np.isfinite(summary["losses"] + summary["grad_norms"]).all()
    params = dict(model.named_parameters())
    assert params["dit.layers.0.seq_modeling_block.ssm.W1"].shape == (2, 64, 64)
    assert params["dit.layers.0.seq_modeling_block.ssm.W1"].grad is not None
    assert not params["dit.layers.0.mlp.layer1.weight"].requires_grad
    assert params["dit.layers.0.seq_modeling_block.attention.q.weight"].requires_grad
    assert summary["step_flops"] == t_metrics.train_step_flops(cfg, 1, summary["text_length"])
    assert summary["step_flops"] == j_metrics.train_step_flops(cfg, 1, summary["text_length"])


def test_sample_entry_runs_ttt_linear_on_cpu(tmp_path, monkeypatch):
    """sample.main on configs/eval/ttt-linear/3s.toml at a tiny size on the CPU:
    three evals, finite latents of the expected shape."""
    monkeypatch.chdir(REPO)
    argv = ["--job.config_file", "configs/eval/ttt-linear/3s.toml", "--eval.input_file", "inputs/example.json",
            "--eval.num_denoising_steps", "3", "--guider.num_steps", "3", "--eval.image_height", "64",
            "--eval.image_width", "64", "--eval.txt_maxlen", "16", "--model.latent_height", "4",
            "--model.latent_width", "4", "--model.model_dim", "128", "--model.num_heads", "2", "--model.num_layers",
            "2", "--eval.output_dir", str(tmp_path), "--job.platform", "cpu"]
    summary = sample.main(sample.parse_args(argv))
    latents = np.load(tmp_path / "video_0_0_latents.npy")
    assert summary["model_config"].ssm_layer == "ttt_linear" and len(summary["eval_seconds"]) == 3
    assert latents.shape == (13, 16, 8, 8) and np.isfinite(latents).all()


@pytest.mark.parametrize("batch", [1, 2])
def test_ttt_linear_flops_match_jax(monkeypatch, batch):
    """The FLOP count MFU divides by, for ttt_linear at the 3 s train TOML's
    widths: the port's utils/metrics.py gives the JAX package's count, with
    the TTT scan at 3 CS F^2 + 2 CS^2 F multiply-adds a mini-batch."""
    monkeypatch.chdir(REPO)
    job = train.parse_args(TINY_LINEAR_TRAIN[:2])
    cfg = train.model_config(job)
    assert cfg.ssm_layer == "ttt_linear" and cfg.model_dim == 3072
    assert t_metrics.train_step_flops(cfg, batch, 498) == j_metrics.train_step_flops(cfg, batch, 498)
    breakdown = t_metrics.dit_forward_flops(cfg, batch, 498)
    L = cfg.compressed_num_frames * cfg.tokens_per_frame + 498
    F, CS = cfg.head_dim, cfg.mini_batch_size
    assert breakdown.ttt_scan == cfg.num_layers * 2 * batch * cfg.num_heads * L * 2 * (3 * F * F + 2 * CS * F)
