"""Checkpoints across world sizes, gloo ranks on the CPU: a run saved at
world 2 with its heads over two tensor ranks (rank 0 writes the full
tensors the ranks gather) resumes at world 1 and at world 2 as fsdp 2 (each
rank reads the same files and keeps its shards). Restored and written back
with no step between, the parameters, moments and sampler state are the
saved bytes. The resumed step: at world 1 its loss equals the uninterrupted
world-1 run's (rtol 1e-5: the two step-1 updates differ in float32 rounding
order only, heads split or not); at fsdp 2 it is held to the one-process
computation from the same checkpoint with the global sigma bounds
stratified over its two data ranks (tests/torch_parallel_runs.py), since the
strata follow the data ranks and an uninterrupted fsdp-2 run's first step
would draw from others. The tiny model at 1 layer and 1 scene, to keep the
seven runs inside a minute.
"""

import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parallel_runs as runs  # noqa: E402
from ttt_video_dit_torch import train  # noqa: E402

torch.set_num_threads(1)
SMALL = ["--model.num_layers", "1", "--model.video_length", "3sec"]
FILES = ("model.safetensors", "optimizer.safetensors", "sampler.json")


def _flags(sizes, dump, steps, interval, resume=False):
    out = runs.train_flags(runs.TTT_MLP, *sizes, steps=steps) + SMALL + [
        "--job.dump_folder", str(dump), "--checkpoint.interval", str(interval)]
    return out + (["--checkpoint.resume", "--checkpoint.resume_step", "1"] if resume else [])


def _copy_step_1(src, dst):
    shutil.copytree(src / "checkpoint" / "1", dst / "checkpoint" / "1")
    return dst


def _same_bytes(a, b):
    for name in FILES:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def test_save_at_tp2_resume_at_world_1_and_fsdp2(tmp_path):
    saved = tmp_path / "tp2"
    runs.torchrun(2, ["-m", "ttt_video_dit_torch.train", *_flags((1, 1, 2), saved, steps=2, interval=1)])
    step_1 = saved / "checkpoint" / "1"
    assert all((step_1 / name).exists() for name in FILES + ("metadata.json",))

    # Restored at world 1 and written back with no step between: the saved bytes.
    back = _copy_step_1(saved, tmp_path / "back1")
    train.main(train.parse_args(_flags((1, 1, 1), back, steps=1, interval=2, resume=True)))
    _same_bytes(back / "checkpoint" / "1", step_1)
    # The same at fsdp 2: each rank restores its shards, the save gathers them again.
    back = _copy_step_1(saved, tmp_path / "back2")
    runs.torchrun(2, ["-m", "ttt_video_dit_torch.train", *_flags((1, 2, 1), back, steps=1, interval=2, resume=True)])
    _same_bytes(back / "checkpoint" / "1", step_1)

    # The resumed step at world 1 against the uninterrupted world-1 run.
    resumed = train.main(train.parse_args(_flags((1, 1, 1), _copy_step_1(saved, tmp_path / "r1"), steps=2,
                                                 interval=2, resume=True)))
    whole = train.main(train.parse_args(_flags((1, 1, 1), tmp_path / "w1", steps=2, interval=2)))
    assert resumed["start_step"] == 1 and len(resumed["losses"]) == 1
    np.testing.assert_allclose(resumed["losses"][0], whole["losses"][1], rtol=1e-5)
    np.testing.assert_allclose(resumed["grad_norms"][0], whole["grad_norms"][1], rtol=1e-4)

    # The resumed step at fsdp 2, with the stats history carried over from the checkpoint.
    flags = _flags((1, 2, 1), _copy_step_1(saved, tmp_path / "r2"), steps=2, interval=1, resume=True)
    runs.torchrun(2, ["-m", "ttt_video_dit_torch.train", *flags])
    assert runs.stats(tmp_path / "r2")[0] == runs.stats(saved)[0]
    runs.held_to_reference(tmp_path / "r2", flags, data_ranks=2)
