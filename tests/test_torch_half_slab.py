"""The TTT kernels' half slabs (a mini-batch CS of 8, 24, 40 or 56: its last
16-token slab holds 8 tokens) on the CPU, where no kernel runs:

- the plain references against the JAX package's Pallas kernels in
  interpret mode at the kernel self-test's half-slab training cases
  (ttt_video_dit_torch/utils/selftest.py), as
  tests/test_torch_selftest.py holds its other cases, with the self-test's
  tolerances;
- the self-test with substitutes that scale only the last 8 tokens of the
  last mini-batch (a half slab's real rows) by 1.5 fails every half-slab case
  and nothing else;
- chip_smoke.py's long-scan check (check_scan_by_group, which holds a
  training scan checkpoint group by checkpoint group) passes the plain
  versions and fails substitutes that scale one group of the output, one
  checkpoint, or one group of an input gradient by 1.5.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from test_torch_selftest import _jax_ttt  # noqa: E402
from ttt_video_dit_torch.utils import selftest  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
CORRUPTION = 1.5
HALF_SLAB_CASES = [c for c in selftest.TRAIN_CASES if c[6] % 16]


@pytest.mark.parametrize("case", [c for c in HALF_SLAB_CASES if c[0].endswith("ragged")],
                         ids=lambda c: c[0].replace(" ", "_"))
def test_plain_reference_matches_the_jax_kernels_at_the_half_slabs(case):
    name, variant, H, NC, nc, K, CS, factor = case
    a = selftest.take(selftest.ttt_arrays(np.random.default_rng(2), variant, 1, H, NC, CS), nc)
    eta = selftest.eta_scale(variant, CS, factor)
    loss, grads = selftest.ttt_loss_and_grads(selftest.PLAIN[f"{variant}_train"], a, variant, K, eta, CPU)
    want_loss, want = _jax_ttt(variant, a, K, eta)
    assert selftest.rel_err(loss, want_loss) <= selftest.FWD_TOL
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, i
        tol = selftest.GRAD_TOL if i < 4 else selftest.STATE_GRAD_TOL
        assert selftest.rel_err(g, w) <= tol, (name, i, selftest.rel_err(g, w))


def _corrupt_last_half_slab(fn):
    """``fn`` with the last 8 tokens of its output's last mini-batch scaled, where CS ends in a half slab."""

    def corrupted(*args):
        out = fn(*args)
        CS = out.shape[2]
        if CS % 16 == 0:
            return out
        last = torch.cat([out[:, -1:, : CS - 8], out[:, -1:, CS - 8 :] * CORRUPTION], dim=2)
        return torch.cat([out[:, :-1], last], dim=1)

    return corrupted


def test_a_corrupt_last_half_slab_fails_every_half_slab_case_and_nothing_else():
    ttt = ("ttt_mlp_train", "ttt_linear_train", "ttt_mlp_forward", "ttt_linear_forward")
    kernels = {n: _corrupt_last_half_slab(f) if n in ttt else f for n, f in selftest.PLAIN.items()}
    result = selftest.kernel_selftest(CPU, kernels=kernels)
    failed = {n for n, e in result["checks"].items() if not e <= result["tolerances"][n]}
    half = {n for n in result["checks"] if any(f"cs{cs} " in n for cs in (8, 24, 40, 56))}
    # The float32 cases at the half slabs: every CS of the list, full and ragged (their last mini-batch holds a
    # half slab too, so they fail as well).
    f32 = [c for c in selftest.F32_TRAIN_CASES if c[6] % 16]
    f32_sampling = [c for c in selftest.F32_SAMPLE_CASES if c[6] % 16]
    assert len(half) == 6 * len(HALF_SLAB_CASES) + 4 + 6 * len(f32) + len(f32_sampling)
    assert failed <= half, failed - half
    for case in [c[0] for c in HALF_SLAB_CASES + f32 + f32_sampling] + [
            f"{v} sampling cs{cs} ragged" for v in ("ttt_mlp", "ttt_linear") for cs in (8, 24)]:
        assert f"{case} fwd" in {n[: n.index(" [")] for n in failed}, case
    for case in [c[0] for c in HALF_SLAB_CASES + f32]:
        for what in ("dq", "dk", "dv"):
            assert any(n.startswith(f"{case} {what} [") for n in failed), (case, what)


def _scan(variant, CS=8, NC=9, H=2, seed=0):
    """A tiny training scan's inputs on the CPU (chip_smoke's draw), the output gradient, and the plain
    versions: 3 checkpoint groups of K = 4, the last of 1."""
    gen = torch.Generator(CPU).manual_seed(seed)
    a = chip_smoke._ttt_inputs(1, H, NC, gen, CPU, CS=CS, variant=variant)
    dout = torch.randn(*a["XQ"].shape, generator=gen).bfloat16()
    mod = chip_smoke._ttt_module(variant)
    return a, dout, getattr(mod, f"{variant}_forward_plain"), getattr(mod, f"{variant}_backward_plain")


def _scaled_group(x, g, K=4, axis=1):
    """``x`` with mini-batches g K .. g K + K - 1 along ``axis`` scaled by CORRUPTION."""
    x = x.clone()
    x.narrow(axis, g * K, K).mul_(CORRUPTION)
    return x


@pytest.mark.parametrize("variant", ["ttt_mlp", "ttt_linear"])
@pytest.mark.parametrize("corrupt", ["none", "output", "checkpoint", "dXK", "d_gate"])
def test_the_long_scan_check_holds_each_checkpoint_group(monkeypatch, variant, corrupt):
    monkeypatch.setattr(chip_smoke, "timed", lambda fn: (fn(), 0.0))  # CUDA events need a card
    a, dout, fwd_p, bwd_p = _scan(variant)
    eta = 0.1 / 64 / 8

    def fwd(**kw):
        out, *ck = fwd_p(**kw)
        if corrupt == "output":
            out = _scaled_group(out, 1)
        elif corrupt == "checkpoint":
            ck[0] = ck[0].clone()
            ck[0][:, :, 1] *= CORRUPTION
        return (out, *ck)

    def bwd(*args):
        grads = list(bwd_p(*args))
        if corrupt in ("dXK", "d_gate"):
            i = chip_smoke.ELEMENTWISE_GRADS.index(corrupt)
            grads[i] = _scaled_group(grads[i], 1, axis=2 if corrupt == "d_gate" else 1)
        return tuple(grads)

    if corrupt == "none":
        r = chip_smoke.check_scan_by_group(variant, a, 4, eta, dout, kernels=(fwd, bwd))
        assert r["err"] == 0 and r["gerr"] == 0 and set(r["group_rel_l2"].values()) == {0.0}
        return
    where = {"output": "group 1", "checkpoint": "_ck 1", "dXK": "dXK group 1", "d_gate": "d_gate group 1"}[corrupt]
    with pytest.raises(AssertionError, match=where):
        chip_smoke.check_scan_by_group(variant, a, 4, eta, dout, kernels=(fwd, bwd))
