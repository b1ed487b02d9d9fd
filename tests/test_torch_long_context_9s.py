"""The 9 s geometry of the PyTorch port on the CPU: the DiT's training loss
and gradients against the JAX package's at the 9 s structure (3 scenes, 37
frames, windows of 1 + 12 frames, NC = 20 in checkpoint groups of 6, the
last of 2; tolerances as tests/test_torch_long_context.py states them), and
both entries on the 9 s TOMLs at a tiny width: the sampling entry from a
3-scene storyboard, the training entry at the TOMLs' own settings (qkvo,
remat policy none, CS 64 / K 16 and CS 16 / K 4), one card, no
[parallelism] warning.
"""

import io
import json
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_long_context import VARIANTS, check_loss_and_gradients_match_jax  # noqa: E402
from ttt_video_dit_torch import sample, train  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("variant", VARIANTS)
def test_9s_loss_and_gradients_match_jax(variant):
    check_loss_and_gradients_match_jax("9s_3_scenes", variant)


TINY = ["--model.model_dim", "32", "--model.num_heads", "2", "--model.latent_height", "2", "--model.latent_width", "2",
        "--job.platform", "cpu"]


@pytest.mark.parametrize("variant", VARIANTS)
def test_sampling_entry_on_the_9s_toml(tmp_path, monkeypatch, variant):
    """configs/eval/<variant>/9s.toml from a 3-scene storyboard: finite
    [37, 16, h, w] latents, 3 windows, no [parallelism] warning."""
    monkeypatch.chdir(REPO)
    board = tmp_path / "board.json"
    board.write_text(json.dumps([[{"text": f"scene {i}", "neg_text": "blurry"} for i in range(3)]]))
    job = sample.parse_args(["--job.config_file", f"configs/eval/{variant.replace('_', '-')}/9s.toml",
                             "--eval.input_file", str(board), "--eval.num_denoising_steps", "2",
                             "--guider.num_steps", "2", "--eval.image_height", "32", "--eval.image_width", "32",
                             "--eval.txt_maxlen", "4", "--model.num_layers", "1", "--eval.output_dir",
                             str(tmp_path / "out")] + TINY)
    out = io.StringIO()
    with redirect_stdout(out):
        summary = sample.main(job)
    assert "WARNING: [parallelism]" not in out.getvalue()
    assert (summary["seq_len"], summary["windows"]) == (3 * 4 + 37 * 4, 3)
    latents = np.load(summary["latents"][0])
    assert latents.shape == (37, 16, 4, 4) and np.isfinite(latents).all()


@pytest.mark.parametrize("variant", VARIANTS)
def test_training_entry_on_the_9s_toml(tmp_path, monkeypatch, variant):
    """configs/train/<variant>/9s.toml at 2 layers, 2 steps, one card: its
    qkvo adapter, policy none, CS and K; finite losses and grad norms. The
    entry's text length keeps L a multiple of CS (at 4 tokens a frame):
    TTT-MLP 548, NC 28 in groups of 16, the last of 12; TTT-linear 500,
    NC 103 in groups of 4, the last of 3."""
    monkeypatch.chdir(REPO)
    job = train.parse_args(["--job.config_file", f"configs/train/{variant.replace('_', '-')}/9s.toml",
                            "--model.num_layers", "2", "--training.steps", "2", "--training.global_batch_size", "1",
                            "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1",
                            "--job.dump_folder", str(tmp_path)] + TINY)
    summary = train.main(job)
    cfg = summary["model_config"]
    assert (cfg.adapter_method, cfg.remat_policy, cfg.compressed_num_frames, cfg.num_chunks) == ("qkvo", "none", 37, 3)
    assert (cfg.mini_batch_size, cfg.scan_checkpoint_group_size) == ((64, 16) if variant == "ttt_mlp" else (16, 4))
    L = cfg.num_chunks * summary["text_length"] + 37 * cfg.tokens_per_frame
    assert (summary["text_length"], L // cfg.mini_batch_size) == ((548, 28) if variant == "ttt_mlp" else (500, 103))
    assert len(summary["losses"]) == 2 and np.isfinite(summary["losses"] + summary["grad_norms"]).all()
