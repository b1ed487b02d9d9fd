"""Sequence parallelism in the PyTorch port: under a tensor group of more
than one rank the [B, L, D] stream is token-sharded between the head-local
blocks (parallel/sharded.py, models/dit/dit.py), as the JAX package lays it
out with ``shard_boundary`` / ``maybe_shard`` and ``[remat]
shard_transformer_inputs``. Gloo ranks on the CPU under torchrun
(tests/torch_parallel_runs.py), the tiny model, float32:

- world 4 (replica 2 x tp 2) with ``--remat.shard_transformer_inputs``
  against the JAX step jitted on ``build_mesh(2, 1, 2)`` with the same flag
  (losses rtol 1e-5, grad norms rtol 1e-4), and the same run against one
  process with the same draws, every parameter after the two steps within
  the one-device tolerances (torch_parallel_runs.held_to_reference);
- tp 3 on a stream of 1,648 tokens, which 3 does not divide (the last rank's
  rows padded), against one process the same way;
- tp 2 sampling on the 9 s eval TOML (3 scenes, a rank's rows straddling
  text and video) against one process's latents;
- the bytes a layer-group checkpoint saves (the non-reentrant checkpoint's
  saved inputs, seen by ``saved_tensors_hooks``) at tp 2 half of tp 1's,
  on rank 0 and rank 1 of a fake process group;
- a group of one returns every input as it is.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import torch.distributed as dist  # noqa: E402
import torch.utils.checkpoint  # noqa: E402
from torch.testing._internal.distributed.fake_pg import FakeStore  # noqa: E402

import torch_parallel_runs as runs  # noqa: E402
from tests.test_torch_parallel_jax import SIZES, STEPS, _jax_run  # noqa: E402
from ttt_video_dit_torch import convert, sample, train  # noqa: E402
from ttt_video_dit_torch.models.dit.schedule import StratifiedSigmaBuckets  # noqa: E402
from ttt_video_dit_torch.parallel.mesh import build_mesh  # noqa: E402
from ttt_video_dit_torch.parallel.sharded import NO_TENSOR_PARALLEL  # noqa: E402
from ttt_video_dit_torch.parallel.sharding import apply_tensor_parallel  # noqa: E402
from ttt_video_dit_torch.training.checkpoint import save_pretrained  # noqa: E402

torch.set_num_threads(1)
SHARDED_INPUTS = ["--remat.shard_transformer_inputs"]


def test_world_4_with_sharded_transformer_inputs_matches_the_jax_mesh_step(tmp_path):
    """replica 2 x tp 2 with shard_transformer_inputs on both sides: the JAX
    boundary constraints and the port's token-sharded stream train alike."""
    flags = runs.train_flags(runs.TTT_MLP, *SIZES, steps=STEPS, global_batch=2) + ["--model.num_layers", "1",
                                                                                  *SHARDED_INPUTS]
    job = train.parse_args(flags)
    cfg = train.model_config(job)
    assert cfg.shard_transformer_inputs
    data, _ = train.build_data(job, cfg)
    lo, hi = StratifiedSigmaBuckets.create(cfg.sigma_interval, 2).sample_bounds(2, 2)
    stream = data.batches(2)
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
    assert "stream token-sharded over tensor: 824 of 1648 tokens a rank" in proc.stdout
    got = runs.stats(tmp_path / "run")
    np.testing.assert_allclose([r["train/loss"] for r in got], losses, rtol=1e-5)
    np.testing.assert_allclose([r["gradient_norm"] for r in got], norms, rtol=1e-4)
    runs.held_to_reference(tmp_path / "run", flags, data_ranks=2, draws_file=tmp_path / "draws.npz")


def test_a_length_the_tensor_group_does_not_divide(tmp_path):
    """tp 3 (6 heads of 16): L = 3 x 500 text + 37 x 4 video = 1,648 = 3 x
    549 + 1, so each rank holds 550 rows, the last rank 400 text rows, 148
    video rows and 2 pad rows; two steps train as one process does, every
    parameter included."""
    flags = runs.train_flags(runs.TTT_MLP, 1, 1, 3) + ["--model.num_layers", "1", "--model.model_dim", "96",
                                                      "--model.num_heads", "6", "--job.dump_folder", str(tmp_path)]
    job = train.parse_args(flags)
    cfg = train.model_config(job)
    L = cfg.num_chunks * train.synthetic_text_length(cfg) + cfg.compressed_num_frames * cfg.tokens_per_frame
    assert L == 1648 and L % 3
    proc = runs.torchrun(3, ["-m", "ttt_video_dit_torch.train", *flags])
    assert "stream token-sharded over tensor: 550 of 1648 tokens a rank (the last rank 2 padded)" in proc.stdout
    runs.held_to_reference(tmp_path, flags, data_ranks=1)


TINY_9S_EVAL = ["--job.config_file", "configs/eval/ttt-mlp/9s.toml", "--eval.num_denoising_steps", "2",
                "--guider.num_steps", "2", "--eval.image_height", "32", "--eval.image_width", "32",
                "--eval.txt_maxlen", "4", "--model.num_layers", "2", "--model.model_dim", "32", "--model.num_heads",
                "2", "--model.latent_height", "2", "--model.latent_width", "2", "--parallelism.fsdp_unsharded_dtype",
                "float32", "--job.platform", "cpu"]


def test_tp2_multiscene_sampling_matches_one_process(tmp_path):
    """The 9 s eval TOML's 3 scenes at L = 3 x 4 + 37 x 4 = 160: rank 0's 80
    rows are 12 text and 68 video tokens. Latents within 5e-5 of one
    process's (float32; the partial sums are reduce-scattered in another
    order), as tests/test_torch_parallel_sample.py holds the 3 s eval."""
    board = tmp_path / "board.json"
    board.write_text(json.dumps([[{"text": f"scene {i}", "neg_text": "blurry"} for i in range(3)]]))
    flags = TINY_9S_EVAL + ["--eval.input_file", str(board)]
    want = np.load(sample.main(sample.parse_args(flags + ["--eval.output_dir", str(tmp_path / "one")]))["latents"][0])
    proc = runs.torchrun(2, ["-m", "ttt_video_dit_torch.sample", *flags, "--parallelism.tp_sharding", "2",
                             "--eval.output_dir", str(tmp_path / "tp2")])
    assert "2 ranks, mesh replica x fsdp x tensor = 1 x 1 x 2" in proc.stdout
    got = np.load(tmp_path / "tp2" / "video_0_0_latents.npy")
    assert got.shape == want.shape == (37, 16, 4, 4)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def _checkpoint_bytes(model, job, monkeypatch) -> list:
    """The bytes each layer-group checkpoint of one training forward saves
    (its inputs, packed through ``saved_tensors_hooks`` around the call)."""
    sizes, checkpoint = [], torch.utils.checkpoint.checkpoint

    def counted(fn, *args, **kwargs):
        saved = []
        with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.nbytes) or t, lambda t: t):
            out = checkpoint(fn, *args, **kwargs)
        sizes.append(sum(saved))
        return out

    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", counted)
    cfg = train.model_config(job)
    data, _ = train.build_data(job, cfg)
    stream = data.batches(1)
    host = next(stream)
    stream.close()
    bounds = (torch.zeros(1, dtype=torch.long), torch.full((1,), 1000, dtype=torch.long))
    model(torch.from_numpy(host["vid"]), torch.from_numpy(host["text"]), bounds, torch.Generator().manual_seed(0))
    monkeypatch.setattr(torch.utils.checkpoint, "checkpoint", checkpoint)
    return sizes


@pytest.mark.parametrize("rank", [0, 1])
def test_layer_checkpoint_saves_halve_at_tp2(monkeypatch, rank):
    """2 layers, a checkpoint each (policy none): [1, 1648, 128] float32 =
    843,776 bytes a layer at tp 1, 421,888 at tp 2 on either rank. The fake
    process group's collectives move no data, so only the sizes are
    meaningful here; the values are held by the torchrun tests above."""
    flags = runs.train_flags(runs.TTT_MLP, 1, 1, 2) + ["--remat.policy", "none"]
    job = train.parse_args(flags)
    cfg = train.model_config(job)
    one = _checkpoint_bytes(train.build_model(cfg, torch.device("cpu"), 0), job, monkeypatch)
    assert one == [1648 * 128 * 4] * 2
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=2)
    try:
        model = apply_tensor_parallel(train.build_model(cfg, torch.device("cpu"), 0), build_mesh(1, 1, 2, "cpu"))
        assert model.dit.tp.size == 2 and model.dit.tp.rank == rank
        assert _checkpoint_bytes(model, job, monkeypatch) == [b // 2 for b in one]
    finally:
        dist.destroy_process_group()


def test_a_group_of_one_is_the_identity():
    """No tensor parallelism: every collective hands back its input itself,
    so the one-device code runs unchanged."""
    x = torch.randn(2, 5, 4)
    tp = NO_TENSOR_PARALLEL
    assert tp.rows(5) == 5
    assert all(f(x) is x for f in (tp.shard, lambda t: tp.all_gather(t, 5), tp.reduce_scatter,
                                   lambda t: tp.gather(t, 1)))
