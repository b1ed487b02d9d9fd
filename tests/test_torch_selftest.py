"""The port's kernel self-test (ttt_video_dit_torch/utils/selftest.py) on
the CPU, where no kernel runs: the harness itself, with substitutes passed
as ``kernels=``, as the JAX package's test runs its self-test in interpret
mode (tests/test_pallas_kernels.py::test_kernel_selftest_harness).

- With the plain versions as substitutes every check passes, and the checks
  name every row of PERF.md's kernel table and every check of the JAX
  self-test.
- Substitutes that corrupt only the last, short checkpoint group of a TTT
  scan (and the last mini-batch of an odd-NC sampling scan), only the last
  attention window, and one low bit of K7's output fail exactly the checks
  that should see them; the full cases pass. An attention whose gradients
  change between two launches fails K4's rerun checks (head dim 64 and 128)
  alone.
- The plain references agree with the JAX package's own path at the
  self-test's full and ragged shapes, on the same numpy inputs: the Pallas
  TTT kernels in interpret mode in their fused-preproc, token-major,
  in-kernel-gate form (ttt_vjp.ttt_mlp_fused_pre, ttt_linear_fused_pre),
  bf16 q/k/v on both sides, and ops/attention.py:_direct. Tolerances: the
  self-test's own (its FWD_TOL, GRAD_TOL, STATE_GRAD_TOL and ATTENTION_*).
- Without substitutes it refuses the CPU.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from ttt_video_dit_torch.ops import attention  # noqa: E402
from ttt_video_dit_torch.utils import selftest  # noqa: E402
from ttt_video_dit_tpu.ops import attention as j_attention  # noqa: E402
from ttt_video_dit_tpu.ops.pallas import ttt_vjp  # noqa: E402

torch.set_num_threads(1)
CPU = torch.device("cpu")
ROWS = ("K1", "K1-train", "K2", "K3", "K3-lse", "K4", "K5", "K5-train", "K6", "K7", "K3@F128", "K3-lse@F128",
        "K4@F128", "K5@F128", "K5-train@F128", "K6@F128")
# The checks of ttt_video_dit_tpu/utils/selftest.py:kernel_selftest (its splash ones run on a TPU only).
JAX_CHECKS = ([f"{v} {c} {w}" for v in ("ttt_linear", "ttt_mlp") for c in ("full", "ragged")
               for w in ("fwd", "dq", "dk", "dv")]
              + [f"ttt_mlp h12 g6 {w}" for w in ("fwd", "dq", "dk", "dv")]
              + [f"ttt_mlp eta-gate {w}" for w in ("fwd", "dq", "dgate")]
              + [f"splash folded-windows {w}" for w in ("fwd", "dq", "dk", "dv")])
CORRUPTION = 1.5  # the factor a corrupting substitute puts on the rows it corrupts


@pytest.fixture(scope="module")
def plain_result():
    return selftest.kernel_selftest(CPU, kernels=dict(selftest.PLAIN))


def _corrupt_last_group(fn, K_of):
    """``fn`` with its output's last mini-batches scaled: those of a short last checkpoint group (``K_of(args)``
    the group), none when the group divides NC."""

    def corrupted(*args):
        out = fn(*args)
        NC, K = out.shape[1], K_of(args)
        if NC % K == 0:
            return out
        start = NC // K * K
        return torch.cat([out[:, :start], out[:, start:] * CORRUPTION], dim=1)

    return corrupted


def _corrupt_last_window(fn):
    def corrupted(q, k, v):
        out = fn(q, k, v)
        return torch.cat([out[:-1], out[-1:] * CORRUPTION])

    return corrupted


def _corrupt_last_window_lse(fn):
    def corrupted(q, k, v):
        out, lse = fn(q, k, v)
        return torch.cat([out[:-1], out[-1:] * CORRUPTION]), torch.cat([lse[:-1], lse[-1:] * CORRUPTION])

    return corrupted


def _flip_low_bit(x):
    y = selftest.PLAIN["convert_f32_bf16"](x).clone()
    y.view(-1)[100:101].view(torch.int16).bitwise_xor_(1)
    return y


@pytest.fixture(scope="module")
def corrupted_result():
    """One run with every corrupting substitute: each corrupts only what its own checks read."""
    plain = selftest.PLAIN
    kernels = {
        "ttt_mlp_train": _corrupt_last_group(plain["ttt_mlp_train"], lambda a: a[-1]),
        "ttt_linear_train": _corrupt_last_group(plain["ttt_linear_train"], lambda a: a[-1]),
        # Sampling: the last mini-batch when the ring of two stages is left half full (an odd NC).
        "ttt_mlp_forward": _corrupt_last_group(plain["ttt_mlp_forward"], lambda a: 2),
        "ttt_linear_forward": _corrupt_last_group(plain["ttt_linear_forward"], lambda a: 2),
        "attention": _corrupt_last_window(plain["attention"]),
        "attention_train": _corrupt_last_window(plain["attention_train"]),
        "attention_with_lse": _corrupt_last_window_lse(plain["attention_with_lse"]),
        "convert_f32_bf16": _flip_low_bit,
    }
    return selftest.kernel_selftest(CPU, kernels=kernels)


def _failed(result) -> set:
    return {n for n, e in result["checks"].items() if not e <= result["tolerances"][n]}


def test_plain_substitutes_pass_every_check(plain_result):
    assert plain_result["ok"], _failed(plain_result)
    assert all(e == 0.0 for e in plain_result["checks"].values())  # a plain version against itself
    assert plain_result["seconds"] > 0


def test_checks_name_every_kernel_row_and_every_jax_check(plain_result):
    names = list(plain_result["checks"])
    for row in ROWS:
        assert any(n.endswith(f"[{row}]") for n in names), row
    for jax_name in JAX_CHECKS:
        assert any(n.startswith(jax_name + " [") for n in names), jax_name
    assert len(names) >= len(JAX_CHECKS) >= 19
    assert set(plain_result["tolerances"]) == set(names)


def test_a_corrupt_ragged_group_fails_ragged_checks_and_passes_full_ones(corrupted_result):
    failed = _failed(corrupted_result)
    assert not corrupted_result["ok"]
    for case in ("ttt_mlp ragged", "ttt_linear ragged", "ttt_mlp h12 g6", "ttt_mlp eta-gate", "ttt_linear eta-gate",
                 "ttt_mlp cs16 ragged", "ttt_mlp cs16 eta-gate", "ttt_mlp cs32 ragged", "ttt_mlp cs48 ragged",
                 *(f"{v} cs{cs} ragged" for v in ("ttt_mlp", "ttt_linear") for cs in (8, 24, 40, 56)),
                 *(f"{v} cs{cs} eta-gate" for v in ("ttt_mlp", "ttt_linear") for cs in (8, 56)),
                 "ttt_linear f128 ragged", "ttt_linear f128 eta-gate"):
        for what in ("fwd", "dq", "dk", "dv"):
            assert any(n.startswith(f"{case} {what} [") for n in failed), (case, what)
    for case in ("ttt_mlp sampling ragged", "ttt_linear sampling ragged", "ttt_mlp sampling cs64 ragged",
                 "ttt_linear sampling cs32 ragged", "ttt_linear sampling cs64 ragged", "ttt_mlp sampling cs32 ragged",
                 "ttt_mlp sampling cs48 ragged", "ttt_mlp sampling cs8 ragged", "ttt_mlp sampling cs24 ragged",
                 "ttt_linear sampling cs8 ragged", "ttt_linear sampling cs24 ragged",
                 "ttt_linear sampling f128 ragged", "ttt_linear sampling f128 eta-gate"):
        assert any(n.startswith(case) for n in failed), case
    # The float32 cases (their own rows, every CS): each ragged one fails, each full one passes.
    for name, *_ in selftest.F32_TRAIN_CASES:
        if name.endswith("ragged"):
            for what in ("fwd", "dq", "dk", "dv"):
                assert any(n.startswith(f"{name} {what} [") for n in failed), (name, what)
    for name, *_ in selftest.F32_SAMPLE_CASES:
        assert any(n.startswith(name) for n in failed) == name.endswith("ragged"), name
    f32_full = [c for c in selftest.F32_TRAIN_CASES if c[0].endswith(" full")]
    f32_sampling_full = [c for c in selftest.F32_SAMPLE_CASES if c[0].endswith(" full")]
    f128_full = [c for c in selftest.F128_SAMPLE_CASES if c[0].endswith(" full")]
    f128_train_full = [c for c in selftest.F128_TRAIN_CASES if c[0].endswith(" full")]
    full = [n for n in corrupted_result["checks"] if " full " in n]
    assert len(full) == 7 * 6 + 7 + 6 * len(f32_full) + len(f32_sampling_full) + len(f128_full) \
        + 6 * len(f128_train_full) \
        and not failed & set(full), \
        failed & set(full)


def test_a_corrupt_last_window_fails_the_folded_window_checks(corrupted_result):
    """Every value check of the folded windows (head dim 64 and 128, the log-sum-exp too) fails; the rerun checks
    (K4's determinism) pass, as the corruption is the same on both launches."""
    splash = {n for n in corrupted_result["checks"] if n.startswith("splash folded-windows")}
    reruns = {selftest.RERUN_CHECK, selftest.F128_RERUN_CHECK}
    assert len(splash) == 13 and splash - _failed(corrupted_result) == reruns


def _drifting(fn):
    """``fn`` with its output scaled by 1 + n / 64 on its n-th call from 0 on inputs of one shape: the first
    launch is exact, a second one on the same inputs gives other gradient bits."""
    calls = {}

    def drifting(q, k, v):
        n = calls[q.shape] = calls.get(q.shape, -1) + 1
        return fn(q, k, v) * (1 + n / 64)

    return drifting


def test_a_backward_that_changes_between_launches_fails_only_the_rerun_check():
    """K4's determinism checks: an attention whose gradients differ between two launches on the same inputs
    (within every value tolerance) fails them, at head dim 64 and 128, and nothing else."""
    kernels = {**selftest.PLAIN, "attention_train": _drifting(selftest.PLAIN["attention_train"])}
    result = selftest.kernel_selftest(CPU, kernels=kernels)
    reruns = {selftest.RERUN_CHECK, selftest.F128_RERUN_CHECK}
    assert _failed(result) == reruns and all(result["checks"][n] > 0.5 for n in reruns)


def test_a_flipped_low_bit_fails_k7(corrupted_result):
    assert "convert bit-exact [K7]" in _failed(corrupted_result)
    assert corrupted_result["checks"]["convert bit-exact [K7]"] == 1 / np.prod(selftest.CONVERT_SHAPE)


def test_refuses_the_cpu_without_substitutes():
    with pytest.raises(ValueError, match="needs a CUDA device"):
        selftest.kernel_selftest(CPU)
    with pytest.raises(ValueError, match="must substitute exactly"):
        selftest.kernel_selftest(CPU, kernels={"attention": selftest.PLAIN["attention"]})


def _jax_ttt(variant, a, K, eta):
    """loss = sum(out^2) and its gradients (q, k, v, gate, ln_w, ln_b, initial state) through the Pallas kernels
    in interpret mode, fused-preproc and token-major, bf16 q/k/v; the initial state shared by the batch of one."""
    fn = ttt_vjp.ttt_mlp_fused_pre if variant == "ttt_mlp" else ttt_vjp.ttt_linear_fused_pre
    cos, sin = jnp.asarray(a["rope_cos"]), jnp.asarray(a["rope_sin"])

    def loss(q, k, v, gate, ln_w, ln_b, *state):
        out = fn(K, True, eta, True, q, k, v, gate, cos, sin, ln_w, ln_b, *(s[None] for s in state))
        return jnp.sum(out.astype(jnp.float32) ** 2)

    args = ([jnp.asarray(a[n]).astype(jnp.bfloat16) for n in ("XQ", "XK", "XV")]
            + [jnp.asarray(a[n]) for n in ("gate", "ln_w", "ln_b") + selftest.STATE[variant]])
    value, grads = jax.jit(jax.value_and_grad(loss, argnums=tuple(range(len(args)))))(*args)
    return torch.tensor(float(value)), [torch.from_numpy(np.array(g.astype(jnp.float32))) for g in grads]


# The half slabs' cases (CS 8, 24, 40, 56) are tests/test_torch_half_slab.py's.
@pytest.mark.parametrize("case", [c for c in selftest.TRAIN_CASES
                                  if c[0].endswith(("full", "ragged")) and not c[6] % 16],
                         ids=lambda c: c[0].replace(" ", "_"))
def test_plain_reference_matches_the_jax_kernels_at_the_selftest_shapes(case):
    name, variant, H, NC, nc, K, CS, factor = case
    a = selftest.take(selftest.ttt_arrays(np.random.default_rng(0), variant, 1, H, NC, CS), nc)
    eta = selftest.eta_scale(variant, CS, factor)
    loss, grads = selftest.ttt_loss_and_grads(selftest.PLAIN[f"{variant}_train"], a, variant, K, eta, CPU)
    want_loss, want = _jax_ttt(variant, a, K, eta)
    assert selftest.rel_err(loss, want_loss) <= selftest.FWD_TOL
    for i, (g, w) in enumerate(zip(grads, want)):
        assert g.shape == w.shape, i
        tol = selftest.GRAD_TOL if i < 4 else selftest.STATE_GRAD_TOL
        assert selftest.rel_err(g, w) <= tol, (name, i, selftest.rel_err(g, w))


def test_plain_attention_matches_jax_direct_at_the_folded_windows():
    a = selftest.attention_arrays(np.random.default_rng(0))
    out, grads = selftest.attention_out_and_grads(selftest.PLAIN["attention_train"], a, CPU)
    q, k, v = (jnp.asarray(a[n]).astype(jnp.bfloat16).astype(jnp.float32) for n in ("q", "k", "v"))
    want_out = j_attention._direct(q, k, v)
    want = jax.grad(lambda q, k, v: jnp.sum(j_attention._direct(q, k, v) * a["ct"]), (0, 1, 2))(q, k, v)
    as_torch = lambda x: torch.from_numpy(np.array(x, np.float32))
    assert selftest.rel_err(out, as_torch(want_out)) <= selftest.ATTENTION_FWD_TOL
    assert selftest.rel_err(attention.attention_plain(*(t.to(torch.bfloat16) for t in map(as_torch, (q, k, v)))),
                            as_torch(want_out)) <= selftest.ATTENTION_FWD_TOL
    for g, w in zip(grads, want):
        assert selftest.rel_err(g, as_torch(w)) <= selftest.ATTENTION_GRAD_TOL


def test_kernel_smoke_script_refuses_a_machine_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the CPU-only behaviour")
    repo = Path(__file__).resolve().parent.parent
    proc = subprocess.run([sys.executable, "scripts/torch_kernel_smoke.py"], cwd=repo, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 2 and "needs a CUDA card" in proc.stderr
    assert "GPU_SMOKE_OK" not in proc.stdout and "GPU_SMOKE_FAIL" not in proc.stdout
