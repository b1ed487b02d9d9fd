"""The PyTorch port's training entry under torchrun, ttt_linear (adapter
qkvo) with its heads over two tensor ranks, gloo on the CPU, against the
same computation in one process, with the tolerances of
tests/test_torch_parallel_train.py.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_parallel_runs as runs  # noqa: E402
from torch_parallel_runs import held_to_reference  # noqa: E402

torch.set_num_threads(1)


def test_ttt_linear_qkvo_tp2_matches_one_process(tmp_path):
    """ttt_linear, adapter qkvo (the frozen MLP, adaLN and embeddings stay
    bit for bit), heads over two tensor ranks."""
    flags = runs.train_flags(runs.TTT_LINEAR, 1, 1, 2) + ["--job.dump_folder", str(tmp_path)]
    runs.torchrun(2, ["-m", "ttt_video_dit_torch.train", *flags])
    want = held_to_reference(tmp_path, flags, data_ranks=1)
    assert len(want["optimizer"].params) < len(want["state"])  # qkvo froze some
