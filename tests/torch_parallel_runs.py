"""Shared pieces of the multi-rank tests of the PyTorch port
(``tests/test_torch_parallel_*.py``): the tiny entry flags, a torchrun
launcher of gloo ranks on the CPU, the one-process reference run, and a
worker that runs the training entry under torchrun with given draws.

Each rank runs one torch thread (``OMP_NUM_THREADS=1``). The launcher is
``python -m torch.distributed.run --standalone --nproc_per_node N`` with a
timeout; rank 0 writes the stats history and the checkpoints under the dump
folder, which the tests read. This module imports neither JAX nor the JAX
package, so the torchrun workers do not load them.

Worker (the training entry with the global batch's draws read from a file
instead of drawn, e.g. the JAX step's draws)::

    python -m torch.distributed.run --standalone --nproc_per_node 4 tests/torch_parallel_runs.py \\
        DRAWS.npz <the entry's flags>
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

from ttt_video_dit_torch.training import optimizer as t_opt
from ttt_video_dit_torch.utils import safetensors

REPO = Path(__file__).resolve().parent.parent
# The tiny model of __graft_entry__._flagship_config(tiny=True) through the entry's flags: d128, 8 heads,
# 37 latent frames (3 scenes), CS 8, K 4, 2 layers, float32; 2x2 latents (one token a frame).
TINY_MODEL = ["--model.num_layers", "2", "--model.model_dim", "128", "--model.num_heads", "8", "--model.latent_height",
              "2", "--model.latent_width", "2", "--model.video_length", "9sec", "--parallelism.fsdp_unsharded_dtype",
              "float32", "--job.platform", "cpu"]
TTT_MLP = ["--job.config_file", "configs/train/ttt-mlp/3s.toml", "--model.mini_batch_size", "8",
           "--remat.scan_checkpoint_group_size", "4"]  # adapter sft, remat save_seq
TTT_LINEAR = ["--job.config_file", "configs/train/ttt-linear/3s.toml", "--model.mini_batch_size", "8",
              "--remat.scan_checkpoint_group_size", "4"]  # adapter qkvo
# Learning rates large enough that 2 steps move every trained tensor visibly (the TOMLs warm up over 100 steps).
OPTIMIZER = ["--optimizer.lr", "1e-3", "--optimizer.lr_ssm", "1e-2", "--optimizer.lr_end", "1e-4",
             "--training.warmup_steps", "1"]
LRS = {"other": 1e-3, "ttt": 1e-2}


def train_flags(variant: list, dp_replicate: int, dp_sharding: int, tp_sharding: int, steps: int = 2,
                global_batch: int = 2) -> list:
    return [*variant, *TINY_MODEL, *OPTIMIZER, "--training.steps", str(steps), "--training.global_batch_size",
            str(global_batch), "--parallelism.dp_replicate", str(dp_replicate), "--parallelism.dp_sharding",
            str(dp_sharding), "--parallelism.tp_sharding", str(tp_sharding)]


def torchrun(nproc: int, args: list, timeout: int = 240) -> subprocess.CompletedProcess:
    """``args`` (``-m module ...`` or a script) under ``nproc`` gloo ranks on the CPU; raises on a non-zero exit."""
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc), *args]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    if proc.returncode:
        raise AssertionError(f"torchrun x{nproc} exited {proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-4000:]}")
    return proc


def stats(dump_folder) -> list:
    """The stats history rank 0 wrote: one record a step."""
    with open(Path(dump_folder) / "logs" / "all_stats.jsonl", encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def reference_run(flags: list, data_ranks: int, draws_file=None) -> dict:
    """The training entry's computation in this process for the whole global
    batch: the same model from the seed (or ``--checkpoint.init_state_dir``,
    or with ``--checkpoint.resume`` model, moments and data sampler from
    ``--checkpoint.resume_step``), the global batch one process draws, the
    global sigma bounds stratified over ``data_ranks`` and the global draws
    of each step (from the step's generator, or ``draws_file``'s). Returns
    the losses and grad norms of the steps it took, the trained model's state
    dict and the optimizer."""
    from ttt_video_dit_torch import train
    from ttt_video_dit_torch.models.dit.schedule import StratifiedSigmaBuckets
    from ttt_video_dit_torch.training.checkpoint import Checkpointer
    from ttt_video_dit_torch.training.optimizer import build_optimizer_from_config
    from ttt_video_dit_torch.training.train_step import global_draws, rank_draws, step_generator, train_step

    job = train.parse_args(flags)
    cfg = train.model_config(job)
    tr, cpu = job.training, torch.device("cpu")
    model = train.build_model(cfg, cpu, job.job.seed, job.checkpoint.init_state_dir)
    optimizer = build_optimizer_from_config(model, job, cfg.adapter_method)
    data, _ = train.build_data(job, cfg)
    start = 0
    if job.checkpoint.resume:
        ckpt = Checkpointer(os.path.join(job.job.dump_folder, "checkpoint"))
        start, sampler_state, _ = ckpt.restore(job.checkpoint.resume_step, model, optimizer)
        data.sampler.load_state_dict(sampler_state)
    lo, hi = StratifiedSigmaBuckets.create(cfg.sigma_interval, data_ranks).sample_bounds(tr.global_batch_size,
                                                                                       data_ranks)
    given = None if draws_file is None else np.load(draws_file)
    batches, losses, norms = data.batches(tr.global_batch_size), [], []
    for step in range(start, tr.steps):
        host = next(batches)
        batch = {"vid": torch.from_numpy(host["vid"]), "text": torch.from_numpy(host["text"]),
                 "sigma_lo": torch.from_numpy(lo), "sigma_hi": torch.from_numpy(hi)}
        if given is None:
            draws = global_draws(step_generator(job.job.seed, optimizer.count, cpu), tr.global_batch_size,
                                 batch["vid"].shape[1:], tr.text_dropout_prob, lo, hi, cpu)
        else:
            draws = {k: torch.from_numpy(given[f"{k}_{step}"]) for k in ("keep", "idx", "noise")}
        out = train_step(model, optimizer, batch, grad_accum_steps=tr.grad_accum_steps,
                         text_dropout_prob=tr.text_dropout_prob, draws=rank_draws(draws, 0, 1, tr.grad_accum_steps))
        losses.append(float(out["loss"]))
        norms.append(float(out["grad_norm"]))
    batches.close()
    return {"losses": losses, "grad_norms": norms, "state": {k: v.detach().clone() for k, v in model.state_dict().items()},
            "optimizer": optimizer}


def held_to_reference(dump, flags, data_ranks: int, steps: int = 2, draws_file=None) -> dict:
    """The run in ``dump`` (its stats history and last checkpoint) against
    :func:`reference_run` of ``flags``: losses rtol 1e-5, grad norms rtol
    1e-4, trained parameters within 2 % of their group's learning rate +
    1e-4 |p|, frozen ones exactly (tests/test_torch_parallel_train.py says
    why). Returns the reference."""
    want = reference_run(flags, data_ranks, draws_file)
    got = stats(dump)
    assert [r["global_step"] for r in got] == list(range(1, steps + 1))
    got = got[len(got) - len(want["losses"]):]  # a resumed reference takes the last steps only
    np.testing.assert_allclose([r["train/loss"] for r in got], want["losses"], rtol=1e-5)
    np.testing.assert_allclose([r["gradient_norm"] for r in got], want["grad_norms"], rtol=1e-4)
    params = safetensors.load_file(str(dump / "checkpoint" / str(steps) / "model.safetensors"))
    trainable = {path for path, _ in want["optimizer"].params}
    assert set(params) == set(want["state"])
    for name, ref in want["state"].items():
        path = t_opt.flax_path(name)
        if path not in trainable:
            torch.testing.assert_close(params[name], ref, rtol=0, atol=0, msg=name)
            continue
        lr = LRS["ttt" if t_opt.is_ttt_parameter(path) else "other"]
        np.testing.assert_allclose(params[name].numpy(), ref.numpy(), rtol=1e-4, atol=0.02 * lr, err_msg=name)
    return want


def _run_with_given_draws(draws_file: str, argv: list) -> None:
    """The training entry, each step's global draws read from ``draws_file``
    (``keep_<step>``, ``idx_<step>``, ``noise_<step>``)."""
    from ttt_video_dit_torch import train
    from ttt_video_dit_torch.training import train_step

    given = np.load(draws_file)
    steps = iter(range(10**6))

    def read_draws(generator, global_batch_size, vid_shape, text_dropout_prob, sigma_lo, sigma_hi, device):
        step = next(steps)
        return {k: torch.from_numpy(given[f"{k}_{step}"]).to(device) for k in ("keep", "idx", "noise")}

    train_step.global_draws = read_draws
    train.main(train.parse_args(argv))


if __name__ == "__main__":
    _run_with_given_draws(sys.argv[1], sys.argv[2:])
