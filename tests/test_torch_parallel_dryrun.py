"""The port's multi-rank dry run (ttt_video_dit_torch/dryrun.py, the
counterpart of __graft_entry__.dryrun_multichip): the JAX dry run's mesh
factorisation; one full training step of the tiny model on 4 gloo ranks on
the CPU (asked for with ``cpu=True``), unrolled and with the layer weights
cast through K7's plain version, each with a finite loss; and, without the
cards, a refusal before anything is launched.
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
    out = dryrun.dryrun_multichip(4, cpu=True)
    for tag in ("unrolled", "scan_layers"):
        assert f"dryrun_multichip(n=4, {tag}): mesh replica x fsdp x tensor = 2 x 1 x 2 on cpu (plain), loss=" in out
    assert out.count(" OK") == 2  # rank 0 alone prints


def test_dryrun_multichip_without_the_cards_raises_before_launching(monkeypatch):
    """cpu=False with fewer cards than ranks: RuntimeError naming the count
    seen and cpu=True; no torchrun is started."""
    launched = []
    monkeypatch.setattr(dryrun.subprocess, "run", lambda *a, **k: launched.append(a))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    with pytest.raises(RuntimeError, match=r"needs 4 cards and sees 2; pass cpu=True"):
        dryrun.dryrun_multichip(4)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=r"needs 4 cards and sees 0; pass cpu=True"):
        dryrun.dryrun_multichip(4)
    assert not launched
