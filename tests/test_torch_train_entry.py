"""The PyTorch port's training entry (python -m ttt_video_dit_torch.train) on a
CPU-only host, and the pieces around the train step that need no JAX draws:
the entry runs at a tiny size when the CPU is asked for, raises without a
card otherwise, refuses parallelism sizes that do not multiply to the world
size (one process without torchrun) and names what a data,
resume or weights flag points at when it is missing, and starts
from weights loaded with --checkpoint.init_state_dir as from the same
weights in memory (its logs and checkpoints go to a temporary
--job.dump_folder); text
dropout zeroes whole samples; a model trains after sampling in one process;
convert.py carries a training-config flax tree (the TOMLs' scan_layers =
true: layers stacked, unstacked by the converter) onto the port's unrolled
model, so the JAX and port train steps can start from the same weights.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import __graft_entry__  # noqa: E402
from ttt_video_dit_torch import convert, train  # noqa: E402
from ttt_video_dit_torch.models.dit.diffusion import CogVideoX as TorchCogVideoX  # noqa: E402
from ttt_video_dit_torch.models.dit.dit import init_params_  # noqa: E402
from ttt_video_dit_torch.training.train_step import apply_text_dropout  # noqa: E402
from ttt_video_dit_tpu.config.job_config import JobConfig as JJob  # noqa: E402
from ttt_video_dit_tpu.config.model_config import ModelConfig as JModel  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.training import setup as j_setup  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
CFG = dataclasses.replace(__graft_entry__._flagship_config(tiny=True), use_kernel=True, num_layers=1)
FRAMES, SCENES, TEXT_LEN, LAT = 37, 3, 9, 2  # 3 * 9 + 37 * 1 = 64 tokens, NC = 8


TINY_TRAIN = [
    "--job.config_file", "configs/train/ttt-mlp/3s.toml", "--model.num_layers", "2", "--model.model_dim", "128",
    "--model.num_heads", "2", "--model.latent_height", "2", "--model.latent_width", "2", "--model.mini_batch_size",
    "8", "--remat.scan_checkpoint_group_size", "4", "--training.steps", "2", "--training.global_batch_size", "1",
    "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1", "--parallelism.fsdp_unsharded_dtype",
    "float32",
]


def test_train_entry_runs_two_steps_on_cpu_when_asked(tmp_path):
    """python -m ttt_video_dit_torch.train at the tiny size on the CPU: two
    steps with finite loss and grad norm, no MFU (no device metric on a CPU)."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}  # one torch thread, as in-process
    proc = subprocess.run([sys.executable, "-m", "ttt_video_dit_torch.train", *TINY_TRAIN, "--job.platform", "cpu",
                           "--job.dump_folder", str(tmp_path)],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    steps = [ln for ln in proc.stdout.splitlines() if ln.startswith("step ")]
    assert len(steps) == 2 and "mfu n/a (cpu)" in steps[0]
    losses = [float(ln.split(" loss ")[1].split()[0]) for ln in steps]
    assert np.isfinite(losses).all() and "training complete" in proc.stdout


def test_train_entry_needs_gpu_unless_cpu_is_asked_for(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only behaviour")
    monkeypatch.chdir(REPO)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(train.parse_args(TINY_TRAIN))


@pytest.mark.parametrize("flag", [["--training.jsonl_paths", "meta.jsonl"], ["--checkpoint.resume"],
                                  ["--checkpoint.init_state_dir", "weights/"], ["--parallelism.dp_sharding", "2"],
                                  ["--parallelism.dp_replicate", "2"], ["--parallelism.tp_sharding", "2"]])
def test_train_entry_refuses_unported_flags(tmp_path, monkeypatch, flag):
    """Each flag that points at something missing or asks for what the world
    cannot hold raises, naming it. Multi-GPU is ported (torchrun, the
    (replica, fsdp, tensor) mesh): without torchrun the world is one process,
    so a ``--parallelism.*`` size of 2 makes a mesh the world cannot hold and
    raises ValueError naming the flag, as the JAX entry's build_mesh asserts.
    Real data (``--training.jsonl_paths``), resume (``--checkpoint.resume``)
    and loading weights (``--checkpoint.init_state_dir``) are ported: a JSONL
    file that does not exist, a checkpoint directory that holds no checkpoint
    and a weights directory that holds none each raise, naming it."""
    monkeypatch.chdir(REPO)
    error, match = ValueError, flag[0].replace(".", r"\.") + " 2"
    if flag[0] == "--checkpoint.init_state_dir":
        error, match = FileNotFoundError, "weights/"
    elif flag[0] == "--training.jsonl_paths":
        error, match = FileNotFoundError, "meta.jsonl"
    elif flag[0] == "--checkpoint.resume":
        error, match = FileNotFoundError, re.escape(f"no checkpoint found under {tmp_path / 'checkpoint'}")
    with pytest.raises(error, match=match):
        train.main(train.parse_args(TINY_TRAIN + flag + ["--job.platform", "cpu", "--job.dump_folder", str(tmp_path)]))


def test_train_entry_starts_from_loaded_weights(tmp_path, monkeypatch):
    """--checkpoint.init_state_dir: two steps from weights loaded from a
    save_pretrained directory equal two steps from the same weights built in
    memory (same losses, grad norms and trained parameters, bit for bit), and
    differ from the steps from the seed's own random weights."""
    from ttt_video_dit_torch.training.checkpoint import save_pretrained

    monkeypatch.chdir(REPO)
    args = TINY_TRAIN + ["--job.platform", "cpu", "--job.dump_folder", str(tmp_path / "run")]
    cfg = train.model_config(train.parse_args(args))
    save_pretrained(str(tmp_path / "w"), train.build_model(cfg, torch.device("cpu"), seed=7))
    loaded = train.main(train.parse_args(args + ["--checkpoint.init_state_dir", str(tmp_path / "w")]))
    build = train.build_model
    monkeypatch.setattr(train, "build_model", lambda cfg, device, seed, init_state_dir=None: build(cfg, device, 7))
    in_memory = train.main(train.parse_args(args))
    monkeypatch.setattr(train, "build_model", build)
    fresh = train.main(train.parse_args(args))
    assert loaded["losses"] == in_memory["losses"] and loaded["grad_norms"] == in_memory["grad_norms"]
    assert loaded["losses"][0] != fresh["losses"][0]
    got, want = dict(loaded["model"].named_parameters()), dict(in_memory["model"].named_parameters())
    assert got.keys() == want.keys() and all(torch.equal(got[n], want[n]) for n in got)



def test_text_dropout_zeroes_whole_samples():
    text = torch.ones(4, 2, 3, 5)
    out = apply_text_dropout(text, 0.5, keep=torch.tensor([1, 0, 1, 0]))
    assert out[0].eq(1).all() and out[1].eq(0).all() and out[3].eq(0).all()
    assert apply_text_dropout(text, 0.0) is text
    drawn = apply_text_dropout(torch.ones(4000, 1), 0.25, torch.Generator().manual_seed(0))
    assert abs(float(drawn.mean()) - 0.75) < 0.03



def test_training_after_sampling_in_one_process():
    """The cached gather indices and rope tables built by a sampling forward
    (inference mode) serve a later training forward + backward: a tiny DiT
    trains after sampling in the same process."""
    cfg = CFG
    model = init_params_(TorchCogVideoX(cfg), torch.Generator().manual_seed(0)).train()
    vid = torch.randn(1, FRAMES, cfg.in_channels, LAT, LAT)
    text = torch.randn(1, SCENES, TEXT_LEN, cfg.text_dim)
    with torch.inference_mode():
        model.denoise(vid, torch.tensor([0.5]), text, torch.tensor([500.0]))
    loss = model(vid, text, (torch.tensor([0]), torch.tensor([1000])), torch.Generator().manual_seed(0)).mean()
    loss.backward()
    assert torch.isfinite(loss) and all(p.grad is not None and torch.isfinite(p.grad).all() for p in model.parameters())


def _check_training_config_tree(argv):
    job = JJob()
    job.parse_args(argv)
    jcfg = JModel.get_preset(job.model.size, job.model.video_length, job)
    tcfg = train.model_config(train.parse_args(argv))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg) and jcfg.scan_layers
    tl = train.synthetic_text_length(tcfg)
    params = j_setup.init_params(CogVideoX(jcfg), jcfg, None, jax.random.PRNGKey(0), text_length=tl)
    assert "scan_layers" in params["params"]["dit"]
    port = convert.load_flax_params(TorchCogVideoX(tcfg), jax.tree.map(np.asarray, params))
    sd, flat = port.state_dict(), convert.flax_to_state_dict(jax.tree.map(np.asarray, params))
    n_stacked = sum(len(x) for x in jax.tree.leaves(params["params"]["dit"]["scan_layers"]))
    n_other = len(jax.tree.leaves(params)) - len(jax.tree.leaves(params["params"]["dit"]["scan_layers"]))
    assert len(sd) == len(flat) == n_stacked + n_other
    for name, value in flat.items():
        np.testing.assert_array_equal(sd[name].numpy(), value.numpy())
    assert any(name.startswith("dit.layers.1.") for name in sd) and not any("scan" in name for name in sd)
    return sd


def test_convert_maps_a_training_config_tree(monkeypatch):
    """convert.py carries every leaf of a training-config flax tree (the 3 s
    TTT-MLP train TOML at tiny width, scan_layers = true: each layer leaf
    stacked over the layers, as JAX's init_params builds it) onto the port's
    unrolled model from the same flags: strict load, equal values."""
    monkeypatch.chdir(REPO)
    _check_training_config_tree(TINY_TRAIN)


def test_convert_maps_a_ttt_linear_training_config_tree(monkeypatch):
    """The same for the 3 s TTT-linear train TOML (W1 [H, F, F], no W2)."""
    monkeypatch.chdir(REPO)
    argv = [a.replace("ttt-mlp", "ttt-linear") for a in TINY_TRAIN]
    argv[argv.index("--model.mini_batch_size") + 1] = "16"
    sd = _check_training_config_tree(argv)
    assert sd["dit.layers.1.seq_modeling_block.ssm.W1"].shape == (2, 64, 64)
