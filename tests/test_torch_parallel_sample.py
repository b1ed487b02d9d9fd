"""The PyTorch port's sampling entry under torchrun on gloo ranks on the CPU
(the counterpart of the JAX entry's build_eval_mesh): with its heads over
two tensor ranks, 2 denoise steps of the tiny eval config give the
one-process latents (float32: the heads' partial sums are all-reduced in
another order, max abs difference 5e-5 on latents of magnitude ~4); with two
data ranks the storyboards are dealt as ``storyboards[data_rank::2]``
(each rank's latents those of one process sampling its share, T5 on every
rank); the ``[parallelism]`` warning fires only when the world holds fewer
ranks than the TOML asks for, and then every rank samples unsharded.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_runs as runs  # noqa: E402
from tests.test_torch_sample_entry import _t5_dir  # noqa: E402
from ttt_video_dit_torch import sample  # noqa: E402

torch.set_num_threads(1)
TINY_EVAL = ["--job.config_file", "configs/eval/ttt-mlp/3s.toml", "--eval.num_denoising_steps", "2",
             "--guider.num_steps", "2", "--eval.image_height", "64", "--eval.image_width", "64", "--eval.txt_maxlen",
             "16", "--model.latent_height", "4", "--model.latent_width", "4", "--model.model_dim", "128",
             "--model.num_heads", "8", "--model.num_layers", "2", "--parallelism.fsdp_unsharded_dtype", "float32",
             "--job.platform", "cpu"]
WARNING = "WARNING: [parallelism] asks for"


def _one_process(flags, out):
    sample.main(sample.parse_args(flags + ["--eval.output_dir", str(out)]))
    return out


def test_tp2_sampling_matches_one_process(tmp_path):
    flags = TINY_EVAL + ["--eval.input_file", "inputs/example.json"]
    want = np.load(_one_process(flags, tmp_path / "one") / "video_0_0_latents.npy")
    proc = runs.torchrun(2, ["-m", "ttt_video_dit_torch.sample", *flags, "--parallelism.tp_sharding", "2",
                             "--eval.output_dir", str(tmp_path / "tp2")])
    assert "2 ranks, mesh replica x fsdp x tensor = 1 x 1 x 2" in proc.stdout and WARNING not in proc.stdout
    assert sorted(p.name for p in (tmp_path / "tp2").iterdir()) == ["video_0_0_latents.npy"]  # tensor rank 0 writes
    got = np.load(tmp_path / "tp2" / "video_0_0_latents.npy")
    assert got.shape == want.shape == (13, 16, 8, 8)
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-5)


def test_storyboards_dealt_over_data_ranks(tmp_path):
    """Three storyboards of different text over two data ranks: rank 0
    samples storyboards 0 and 2, rank 1 storyboard 1, each writing
    video_<data rank>_<its index>, as one process sampling its share writes
    them (the JAX entry's seeds and names, by the index in the share)."""
    boards = [[{"text": text, "neg_text": "blurry"}] for text in ("a cat walks", "kitchen", "a kitchen cat")]
    t5 = ["--eval.t5_model_dir", str(_t5_dir(tmp_path))]
    files = {}
    for name, share in (("all", boards), ("r0", boards[0::2]), ("r1", boards[1::2])):
        files[name] = tmp_path / f"{name}.json"
        files[name].write_text(json.dumps(share))
    runs.torchrun(2, ["-m", "ttt_video_dit_torch.sample", *TINY_EVAL, *t5, "--eval.input_file", str(files["all"]),
                      "--eval.output_dir", str(tmp_path / "dealt")])
    dealt = tmp_path / "dealt"
    assert sorted(p.name for p in dealt.iterdir()) == [f"video_{r}_{i}_latents.npy" for r, i in ((0, 0), (0, 1), (1, 0))]
    for rank in (0, 1):
        alone = _one_process(TINY_EVAL + t5 + ["--eval.input_file", str(files[f"r{rank}"])], tmp_path / f"alone{rank}")
        for i in range(len(boards[rank::2])):
            np.testing.assert_array_equal(np.load(dealt / f"video_{rank}_{i}_latents.npy"),
                                          np.load(alone / f"video_0_{i}_latents.npy"))
    assert not np.array_equal(np.load(dealt / "video_0_0_latents.npy"), np.load(dealt / "video_1_0_latents.npy"))


def test_parallelism_warning_only_when_the_world_is_short(tmp_path):
    """tp_sharding 4 on a world of 2: the JAX entry's warning with the
    world's 2 ranks, then every rank a data rank of its own, unsharded."""
    proc = runs.torchrun(2, ["-m", "ttt_video_dit_torch.sample", *TINY_EVAL, "--eval.input_file",
                             "inputs/example.json", "--parallelism.tp_sharding", "4", "--eval.output_dir",
                             str(tmp_path)])
    assert ("WARNING: [parallelism] asks for replicate=1 fsdp=1 tp=4 but only 2 device(s) visible; sampling "
            "unsharded") in proc.stdout
    assert "mesh replica x fsdp x tensor = 1 x 2 x 1" in proc.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["video_0_0_latents.npy"]  # one storyboard, two data ranks
