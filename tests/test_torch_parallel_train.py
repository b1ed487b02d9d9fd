"""The PyTorch port's training entry under torchrun on gloo ranks on the CPU
(python -m torch.distributed.run --standalone --nproc_per_node 2 -m
ttt_video_dit_torch.train --job.platform cpu), against the same computation
in one process: ttt_mlp (adapter sft) at world 2 as fsdp 2 and as tp 2
(tests/test_torch_parallel_linear.py: ttt_linear), 2 steps of the tiny model
each (tests/torch_parallel_runs.py). The reference is fed the same global
batch, the global sigma bounds stratified over the data ranks and the same
global draws. Float32: losses rtol 1e-5, grad norms rtol 1e-4 (the ranks sum
gradients and squared norms in another order), every parameter after the
steps within 2 % of its group's learning rate + 1e-4 |p| (Adam normalises
each gradient element, so one near eps = 1e-8 turns float32 noise into a
visible share of its update, as tests/test_torch_train.py holds the port to
JAX), frozen parameters exactly.
"""

import pytest

torch = pytest.importorskip("torch")

import torch_parallel_runs as runs  # noqa: E402
from torch_parallel_runs import held_to_reference  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("sizes", [(1, 2, 1), (1, 1, 2)], ids=["fsdp2", "tp2"])
def test_ttt_mlp_world_2_matches_one_process(tmp_path, sizes):
    """ttt_mlp, sft, save_seq: FSDP2 over two data ranks (each its half of
    the global batch) or the heads over two tensor ranks (each half the heads
    of the whole batch) train as one process does."""
    flags = runs.train_flags(runs.TTT_MLP, *sizes) + ["--job.dump_folder", str(tmp_path)]
    proc = runs.torchrun(2, ["-m", "ttt_video_dit_torch.train", *flags])
    assert f"x 2 ranks, mesh replica x fsdp x tensor = {' x '.join(map(str, sizes))}" in proc.stdout
    assert sum(ln.startswith("step ") for ln in proc.stdout.splitlines()) == 2  # rank 0 alone prints
    held_to_reference(tmp_path, flags, data_ranks=sizes[0] * sizes[1])

