"""The PyTorch port at world 4 (replica 2 x tp 2: HSDP over two data ranks,
the heads over two tensor ranks; gloo on the CPU, torchrun) against the JAX
train step jitted on ``build_mesh(2, 1, 2)`` of the conftest's virtual CPU
devices: ttt_mlp, sft, the tiny model at 1 layer (the JAX compile and the
four ranks stay inside a minute), the same weights (random, carried
across by the port's convert functions and ``--checkpoint.init_state_dir``),
the same global batch and sigma bounds, and the JAX step's own draws (keep
mask, sigma index, noise from ``fold_in(key, step)``), which the port's
entry reads instead of drawing (tests/torch_parallel_runs.py). Two steps:
losses rtol 1e-5 and grad norms rtol 1e-4 against JAX, as the one-device
steps in tests/test_torch_train.py; the same run also held to the port's
one-process computation with the same draws (its parameters included).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import torch_parallel_runs as runs  # noqa: E402
from tests.test_torch_train import _jax_draws, _random_params  # noqa: E402
from ttt_video_dit_torch import convert, train  # noqa: E402
from ttt_video_dit_torch.models.dit.schedule import StratifiedSigmaBuckets  # noqa: E402
from ttt_video_dit_torch.training.checkpoint import save_pretrained  # noqa: E402
from ttt_video_dit_tpu.config.job_config import JobConfig as JJob  # noqa: E402
from ttt_video_dit_tpu.config.model_config import ModelConfig as JModel  # noqa: E402
from ttt_video_dit_tpu.models.dit.diffusion import CogVideoX  # noqa: E402
from ttt_video_dit_tpu.parallel.mesh import build_mesh, use_mesh  # noqa: E402
from ttt_video_dit_tpu.parallel.sharding import shard_params  # noqa: E402
from ttt_video_dit_tpu.training import optimizer as j_opt  # noqa: E402
from ttt_video_dit_tpu.training import setup as j_setup  # noqa: E402
from ttt_video_dit_tpu.training.train_step import make_train_step  # noqa: E402

torch.set_num_threads(1)
SIZES, G, STEPS = (2, 1, 2), 2, 2


def _jax_run(flags, batch):
    """Random JAX params, and the losses and grad norms of STEPS jitted mesh
    steps, step i on the global batch ``batch[i]``, with the draws each step
    makes (keyed ``<name>_<step>``)."""
    job = JJob()
    job.parse_args(flags)
    cfg = dataclasses.replace(JModel.get_preset(job.model.size, job.model.video_length, job), use_kernel=False,
                              scan_layers=False)
    model = CogVideoX(cfg)
    b0 = batch[0]
    params = _random_params(lambda: model.init(jax.random.PRNGKey(0), jnp.asarray(b0["vid"]), jnp.asarray(b0["text"]),
                                               jax.random.PRNGKey(1), (jnp.asarray(b0["sigma_lo"]),
                                                                       jnp.asarray(b0["sigma_hi"]))), 5)
    mesh = build_mesh(*SIZES, devices=jax.devices()[:4])
    key, losses, norms, draws = jax.random.PRNGKey(7), [], [], {}
    with use_mesh(mesh):
        trainable, _ = j_opt.partition_params(params, "sft")
        tx, _, _ = j_opt.build_optimizer_from_config(trainable, job)
        state = j_setup.create_train_state(shard_params(params, mesh), tx, "sft")
        step_fn = jax.jit(make_train_step(model, tx, text_dropout_prob=job.training.text_dropout_prob))
        shardings = j_setup.batch_shardings(mesh)
        for step in range(STEPS):
            b = batch[step]
            state, metrics = step_fn(state, {k: jax.device_put(jnp.asarray(v), shardings[k]) for k, v in b.items()},
                                     key)
            losses.append(float(metrics["loss"]))
            norms.append(float(metrics["grad_norm"]))
            d = _jax_draws(jax.random.fold_in(key, step), b["vid"].shape, b["sigma_lo"], b["sigma_hi"],
                           job.training.text_dropout_prob)
            draws.update({f"{k}_{step}": np.asarray(v) for k, v in d.items()})
    return params, losses, norms, draws


def test_world_4_matches_the_jax_mesh_step(tmp_path):
    flags = runs.train_flags(runs.TTT_MLP, *SIZES, steps=STEPS, global_batch=G) + ["--model.num_layers", "1"]
    job = train.parse_args(flags)
    cfg = train.model_config(job)
    data, _ = train.build_data(job, cfg)  # the global batch one process draws, as the ranks' shards tile it
    lo, hi = StratifiedSigmaBuckets.create(cfg.sigma_interval, 2).sample_bounds(G, 2)
    stream = data.batches(G)
    batch = [{**next(stream), "sigma_lo": lo, "sigma_hi": hi} for _ in range(STEPS)]
    stream.close()
    params, losses, norms, draws = _jax_run(flags, batch)

    weights = tmp_path / "weights"
    model = convert.load_flax_params(train.build_model(cfg, torch.device("cpu"), 0), jax.tree.map(np.asarray, params))
    save_pretrained(str(weights), model)
    np.savez(tmp_path / "draws.npz", **draws)
    flags += ["--checkpoint.init_state_dir", str(weights), "--job.dump_folder", str(tmp_path / "run")]
    proc = runs.torchrun(4, ["tests/torch_parallel_runs.py", str(tmp_path / "draws.npz"), *flags])
    assert "x 4 ranks, mesh replica x fsdp x tensor = 2 x 1 x 2" in proc.stdout
    got = runs.stats(tmp_path / "run")
    np.testing.assert_allclose([r["train/loss"] for r in got], losses, rtol=1e-5)
    np.testing.assert_allclose([r["gradient_norm"] for r in got], norms, rtol=1e-4)
    runs.held_to_reference(tmp_path / "run", flags, data_ranks=2, draws_file=tmp_path / "draws.npz")
