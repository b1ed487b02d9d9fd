"""The port's multi-rank dry run (ttt_video_dit_torch/dryrun.py, the
counterpart of __graft_entry__.dryrun_multichip): the JAX dry run's mesh
factorisation, and one full training step of the tiny model on 4 gloo ranks
on the CPU (no card here), unrolled and with the layer weights cast through
K7's plain version, each with a finite loss.
"""

import pytest

torch = pytest.importorskip("torch")

from ttt_video_dit_torch import dryrun  # noqa: E402


@pytest.mark.parametrize("n,sizes", [(1, (1, 1, 1)), (2, (1, 1, 2)), (3, (1, 3, 1)), (4, (2, 1, 2)), (6, (1, 3, 2)),
                                     (8, (2, 2, 2))])
def test_factorisation_is_the_jax_dry_runs(n, sizes):
    """tensor 2 when n is even, replica 2 when it divides what is left (__graft_entry__.py:113-116)."""
    assert dryrun.factorisation(n) == sizes


def test_dryrun_multichip_4_on_gloo():
    out = dryrun.dryrun_multichip(4)
    for tag in ("unrolled", "scan_layers"):
        assert f"dryrun_multichip(n=4, {tag}): mesh replica x fsdp x tensor = 2 x 1 x 2 on cpu (plain), loss=" in out
    assert out.count(" OK") == 2  # rank 0 alone prints
