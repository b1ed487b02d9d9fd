"""Save and resume through the port's training entry (ttt_video_dit_torch.train.main)
on the CPU, at the tiny size of tests/test_torch_train_entry.py (2 layers,
d128, the 3 s TTT-MLP TOML with its save_seq policy).

Run A takes 4 steps with --checkpoint.interval 2 and is stopped as step 3
begins (after the step-2 save); run B resumes it with --checkpoint.resume
and takes steps 3 and 4; run C takes the 4 steps uninterrupted. A's two
steps and B's two equal C's four bit for bit (losses, grad norms), and B
ends with C's parameters, optimizer moments and count, data sampler state
and stats history. On synthetic data and on a fabricated JSONL dataset
(posteriors [13, 32, 4, 4] and text [12, 4096], .npy and .pt files).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from ttt_video_dit_torch import train  # noqa: E402
from ttt_video_dit_torch.training import train_step as t_train_step  # noqa: E402

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parent.parent
TINY = [
    "--job.config_file", "configs/train/ttt-mlp/3s.toml", "--model.num_layers", "2", "--model.model_dim", "128",
    "--model.num_heads", "2", "--model.latent_height", "2", "--model.latent_width", "2", "--model.mini_batch_size",
    "8", "--remat.scan_checkpoint_group_size", "4", "--training.steps", "4", "--training.global_batch_size", "1",
    "--parallelism.dp_replicate", "1", "--parallelism.dp_sharding", "1", "--checkpoint.interval", "2",
    "--training.warmup_steps", "2", "--job.platform", "cpu",
]


class Stop(Exception):
    """Stands for the job being killed."""


def _dataset(root: Path) -> list[str]:
    rng = np.random.default_rng(0)
    lines = []
    for i in range(3):
        vid = np.concatenate([rng.standard_normal((13, 16, 4, 4)), rng.standard_normal((13, 16, 4, 4)) * 0.3 - 2.0],
                             axis=1).astype(np.float32)
        text = rng.standard_normal((12, 4096)).astype(np.float32)
        names = (f"vid_{i}.npy", f"text_{i}.pt") if i % 2 == 0 else (f"vid_{i}.pt", f"text_{i}.npy")
        for name, arr in zip(names, (vid, text)):
            if name.endswith(".npy"):
                np.save(root / name, arr)
            else:
                torch.save(torch.from_numpy(arr), root / name)
        lines.append(json.dumps({"vid_emb": names[0], "text_chunk_emb": [names[1]]}))
    (root / "meta.jsonl").write_text("\n".join(lines) + "\n")
    return ["--training.dataset_path", str(root), "--training.jsonl_paths", str(root / "meta.jsonl")]


@pytest.mark.parametrize("data", ["synthetic", "jsonl"])
def test_interrupted_and_resumed_run_equals_an_uninterrupted_one(tmp_path, monkeypatch, data):
    monkeypatch.chdir(REPO)
    flags = TINY + (_dataset(tmp_path) if data == "jsonl" else [])
    step = t_train_step.train_step
    calls = {"n": 0}

    def stopped_at_step_3(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 3:
            raise Stop
        return step(*args, **kwargs)

    monkeypatch.setattr(t_train_step, "train_step", stopped_at_step_3)
    with pytest.raises(Stop):
        train.main(train.parse_args(flags + ["--job.dump_folder", str(tmp_path / "ab")]))
    monkeypatch.setattr(t_train_step, "train_step", step)
    ckpt_dir = tmp_path / "ab" / "checkpoint"
    assert sorted(os.listdir(ckpt_dir)) == ["2"]
    b = train.main(train.parse_args(flags + ["--job.dump_folder", str(tmp_path / "ab"), "--checkpoint.resume"]))
    c = train.main(train.parse_args(flags + ["--job.dump_folder", str(tmp_path / "c")]))
    assert b["start_step"] == 2 and b["restore"]["step"] == 2 and c["start_step"] == 0
    assert [s["step"] for s in b["checkpoints"]] == [4] and [s["step"] for s in c["checkpoints"]] == [2, 4]
    with open(ckpt_dir / "2" / "all_stats.jsonl") as f:
        a_stats = [json.loads(line) for line in f]
    assert [s["train/loss"] for s in a_stats] + b["losses"] == c["losses"]
    assert [s["gradient_norm"] for s in a_stats] + b["grad_norms"] == c["grad_norms"]
    assert b["sampler_state"] == c["sampler_state"]
    got, want = b["model"].state_dict(), c["model"].state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in got)
    ob, oc = b["optimizer"].state_dict(), c["optimizer"].state_dict()
    assert ob["count"] == oc["count"] == 4
    for key in ("mu", "nu"):
        assert all(torch.equal(ob[key][p], oc[key][p]) for p in oc[key])
    with open(tmp_path / "ab" / "logs" / "all_stats.jsonl") as f:
        history = [json.loads(line) for line in f]
    assert [s["global_step"] for s in history] == [1, 2, 3, 4]
    assert [s["train/loss"] for s in history] == c["losses"]
    if data == "jsonl":
        assert b["text_length"] == 12 and len(b["load_seconds"]) == 2
