"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: without a card every test skips. On a machine with one (and
no JAX), run them without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerance, elementwise on the bf16 outputs: |kernel - plain| <= 2e-2 + 2e-2 * |plain|
(a few bf16 ulps: both sides round at the same points, only the float32
summation order differs, and attention rounds P, and in the backward dS, to
bf16 as operands). The training kernels' float32 outputs (state
checkpoints, gradients) are held by their relative L2 error and by their
largest error against a share of their scale, stated per test. The
weight conversion (K7) must be bit-identical to ``.to(torch.bfloat16)``.
The serving path's T5 encoder and VAE decoder (PyTorch ops) are held to
their CPU outputs with the same weights, at the tolerances stated below.
"""

import pytest

torch = pytest.importorskip("torch")

from ttt_video_dit_torch.ops import attention, convert, ttt_linear_kernel, ttt_mlp_kernel  # noqa: E402

torch.set_num_threads(1)
pytestmark = pytest.mark.gpu
ATOL = RTOL = 2e-2


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain versions are float32 references
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32


def _close(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    err = (got - want).abs()
    assert bool((err <= ATOL + RTOL * want.abs()).all()), f"max_abs_err {float(err.max())}"


def _ttt_inputs(cuda, B, H, NC, seed=0, CS=16):
    gen = torch.Generator(cuda).manual_seed(seed)
    F = 64
    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=cuda) * std
    angles = torch.rand(NC, CS, F // 2, generator=gen, device=cuda) * 6.3
    return dict(
        XQ=randn(B, NC, CS, H * F).bfloat16(), XK=randn(B, NC, CS, H * F).bfloat16(),
        XV=randn(B, NC, CS, H * F).bfloat16(), gate=randn(B, H, NC, CS),
        rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
        rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
        ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1),
        W1=randn(H, F, 4 * F, std=0.02), b1=randn(H, 1, 4 * F, std=0.02),
        W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02),
    )


# (B, H, NC): one and two mini-batches, 17 (more than the kernel's two-stage
# ring wraps in a step), and 3 x 48 scans, more blocks than the H100's 132 SMs;
# at CS = 32, 48 and 64 (K1 through the training kernel with no checkpoints)
# an even and an odd NC and the CFG batch of 48 heads, at the eta of the TOMLs'
# base lr; at the half slabs of CS 8, 24, 40 and 56 an odd NC, the last
# mini-batch at the end of the tensors.
@pytest.mark.parametrize("B,H,NC,CS", [(1, 3, 9, 16), (2, 2, 1, 16), (1, 2, 1, 16), (2, 3, 2, 16), (2, 2, 17, 16),
                                       (3, 48, 3, 16), (2, 2, 8, 64), (2, 3, 9, 64), (2, 48, 3, 64), (2, 2, 8, 32),
                                       (2, 48, 3, 32), (2, 3, 9, 48), (2, 48, 3, 48), (2, 3, 9, 8), (2, 48, 3, 8),
                                       (2, 3, 9, 24), (2, 3, 9, 40), (2, 3, 9, 56)])
def test_ttt_kernel_matches_plain(cuda, B, H, NC, CS):
    args = _ttt_inputs(cuda, B, H, NC, CS=CS)
    eta = 1e-4 if CS == 16 else 0.1 / 64 / CS
    before = ttt_mlp_kernel.launches
    got = ttt_mlp_kernel.ttt_mlp_forward(**args, eta_scale=eta)
    torch.cuda.synchronize()
    assert ttt_mlp_kernel.launches == before + 1
    _close(got, ttt_mlp_kernel.ttt_mlp_forward_plain(**args, eta_scale=eta))


def _in_tolerances(a, b):
    """max |a - b| / (ATOL + RTOL |b|), elementwise: how many tolerances apart."""
    a, b = a.float(), b.float()
    return float(((a - b).abs() / (ATOL + RTOL * b.abs())).max())


@pytest.mark.parametrize("eta_scale", [0.1, 1.0])
def test_ttt_kernel_sees_the_state_update(cuda, eta_scale):
    """K1 at an eta 1,000x and 10,000x the slice's, where the state the scan
    carries moves the output far: the plain output is at least 10
    tolerances away from the eta_scale = 0 output and, in the last
    mini-batch, from the output of a scan whose state never changes (each
    mini-batch run from the initial state). The kernel stays within one."""
    B, H, NC = 1, 2, 17
    a = _ttt_inputs(cuda, B, H, NC, seed=8)
    got = ttt_mlp_kernel.ttt_mlp_forward(**a, eta_scale=eta_scale)
    want = ttt_mlp_kernel.ttt_mlp_forward_plain(**a, eta_scale=eta_scale)
    _close(got, want)
    assert _in_tolerances(want, ttt_mlp_kernel.ttt_mlp_forward_plain(**a, eta_scale=0.0)) >= 10
    last = {k: v for k, v in a.items()}
    for k in ("XQ", "XK", "XV"):
        last[k] = a[k][:, NC - 1:].contiguous()
    last["gate"] = a["gate"][:, :, NC - 1:].contiguous()
    last["rope_cos"], last["rope_sin"] = a["rope_cos"][NC - 1:], a["rope_sin"][NC - 1:]
    frozen = ttt_mlp_kernel.ttt_mlp_forward_plain(**last, eta_scale=eta_scale)
    assert _in_tolerances(want[:, NC - 1:], frozen) >= 10


# Window lengths around the kernels' tiles (K3: 192 q rows a block and 128 kv
# rows a step; K4: 128 kv rows a block and 64 q rows a step), with several
# windows and heads, besides the shapes of the first kernels.
TILE_EDGES = [(2, 1, 2, 64), (3, 63, 2, 64), (2, 127, 3, 64), (2, 128, 2, 64), (3, 129, 2, 64), (2, 192, 2, 64),
              (2, 193, 3, 64), (2, 255, 3, 64)]
ATTENTION_SHAPES = [(3, 417, 2, 64), (1, 64, 1, 64), (2, 1000, 3, 64), (1, 5, 2, 64)] + TILE_EDGES


@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_attention_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda).mul(2).bfloat16() for _ in range(3))
    before = attention.launches
    got = attention.attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    _close(got, attention.attention_plain(q, k, v))


def test_attention_kernel_at_the_63s_windows(cuda):
    """K3 at the 63 s eval's [42 windows, S = 18,008, 48, 64] (2,323,464,192
    elements a tensor; S is no multiple of the 128-row kv step): windows 0
    and 41 (which starts past element 2^31) against the plain version."""
    gen = torch.Generator(cuda).manual_seed(2)
    shape = (42, 18008, 48, 64)
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda, dtype=torch.bfloat16).mul_(2) for _ in range(3))
    got = attention.attention(q, k, v)
    assert 41 * 18008 * 48 * 64 > 2**31
    for w in (0, 41):
        _close(got[w : w + 1], attention.attention_plain(q[w : w + 1], k[w : w + 1], v[w : w + 1]))


def test_ttt_kernel_past_2_31_elements(cuda):
    """K1 on the 63 s eval's [2, 351,168 tokens, 48 x 64] q/k/v (2,157,576,192
    elements). The gate is -1e4 (eta 0: the state stays the initial one) but
    on the last 256 mini-batches, so batch row 1's last two heads there,
    whose last 3,286 rows lie past element 2^31, equal the plain scan run on
    their slice from the initial state."""
    NC, H, tail = 21948, 48, 256
    args = _ttt_inputs(cuda, 1, H, 1)
    gen = torch.Generator(cuda).manual_seed(3)
    for n in ("XQ", "XK", "XV"):
        args[n] = torch.randn(2, NC, 16, H * 64, generator=gen, device=cuda, dtype=torch.bfloat16)
    args["gate"] = torch.randn(2, H, NC, 16, generator=gen, device=cuda)
    args["gate"][:, :, : NC - tail] = -1e4
    angles = torch.rand(NC, 16, 32, generator=gen, device=cuda) * 6.3
    args["rope_cos"], args["rope_sin"] = (t.repeat_interleave(2, -1).contiguous() for t in (angles.cos(), angles.sin()))
    got = ttt_mlp_kernel.ttt_mlp_forward(**args, eta_scale=0.1 / 64 / 16)
    heads, mbs = slice(H - 2, H), slice(NC - tail, NC)
    part = {n: args[n][1:, mbs, :, (H - 2) * 64:].contiguous() for n in ("XQ", "XK", "XV")}
    part["gate"] = args["gate"][1:, heads, mbs].contiguous()
    part.update({n: args[n][mbs].contiguous() for n in ("rope_cos", "rope_sin")})
    part.update({n: v[heads].contiguous() for n, v in args.items() if n not in part})
    first = ((2 * NC - tail) * 16 * H + H - 2) * 64  # batch row 1's tail, head H - 2: its first element
    assert first < 2**31 < first + (tail * 16 - 1) * H * 64  # its last 3,286 rows lie past element 2^31
    _close(got[1:, mbs, :, (H - 2) * 64:], ttt_mlp_kernel.ttt_mlp_forward_plain(**part, eta_scale=0.1 / 64 / 16))


def _scaled(got, want, tol, rel_l2=1e-2):
    """A float32 training-kernel output: relative L2 error within ``rel_l2``
    and the largest error within ``tol`` of the output's scale."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    rel = float((got - want).norm() / want.norm())
    assert rel <= rel_l2, f"relative L2 error {rel} > {rel_l2}"
    err, scale = float((got - want).abs().max()), float(want.abs().max())
    assert err <= tol * scale, f"max_abs_err {err} > {tol} x {scale}"


def _train_inputs(cuda, B, H, NC, seed, CS=64):
    gen = torch.Generator(cuda).manual_seed(seed)
    F = 64
    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=cuda) * std
    angles = torch.rand(NC, CS, F // 2, generator=gen, device=cuda) * 6.3
    return dict(
        XQ=randn(B, NC, CS, H * F).bfloat16(), XK=randn(B, NC, CS, H * F).bfloat16(),
        XV=randn(B, NC, CS, H * F).bfloat16(), gate=randn(B, H, NC, CS),
        rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
        rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
        ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1),
        W1=randn(H, F, 4 * F, std=0.02), b1=randn(H, 1, 4 * F, std=0.02),
        W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02),
    ), randn


# The TOMLs' eta_scale (ttt_base_lr 0.1 / 64 / CS; None below), and 0.1 and 1.0 (at CS 64 4,096x and 40,960x
# it), where the state update moves the output far (the plain output then lies at least 10 tolerances from the
# eta = 0 output); at every mini-batch the kernels take.
@pytest.mark.parametrize("CS", [8, 16, 24, 32, 40, 48, 56, 64])
@pytest.mark.parametrize("B,H,NC,K,scale", [(1, 2, 5, 2, None), (2, 3, 3, 16, None), (1, 2, 5, 2, 0.1),
                                            (1, 2, 5, 2, 1.0)])
def test_ttt_train_and_backward_kernels_match_plain(cuda, B, H, NC, K, scale, CS):
    """K1-train (output elementwise; fp32 checkpoints within 1e-2 relative L2
    and 1e-3 of their scale) and K2 (every gradient within 1e-2 relative L2
    and 1e-2 of its scale; dXQ/dXK/dXV/d_gate also elementwise) against their
    plain versions, with a ragged last checkpoint group."""
    scale = scale or 0.1 / 64 / CS
    a, randn = _train_inputs(cuda, B, H, NC, seed=3, CS=CS)
    before = (ttt_mlp_kernel.train_launches, ttt_mlp_kernel.bwd_launches)
    got = ttt_mlp_kernel.ttt_mlp_forward_train(**a, eta_scale=scale, checkpoint_group=K)
    want = ttt_mlp_kernel.ttt_mlp_forward_plain(**a, eta_scale=scale, checkpoint_group=K)
    if scale >= 0.1:
        assert _in_tolerances(want[0], ttt_mlp_kernel.ttt_mlp_forward_plain(**a, eta_scale=0.0)) >= 10
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _scaled(g, w, 1e-3)
    dout = randn(*a["XQ"].shape).bfloat16()
    ins = [a[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    grads = ttt_mlp_kernel.ttt_mlp_backward(*ins, *want[1:], dout, scale, K)
    torch.cuda.synchronize()
    assert (ttt_mlp_kernel.train_launches, ttt_mlp_kernel.bwd_launches) == (before[0] + 1, before[1] + 1)
    plain = ttt_mlp_kernel.ttt_mlp_backward_plain(*ins, *want[1:], dout, scale, K)
    for i, (g, w) in enumerate(zip(grads, plain)):
        _scaled(g, w, 1e-2)
        if i < 4:  # dXQ, dXK, dXV, d_gate
            _close(g, w)


@pytest.mark.parametrize("shape", ATTENTION_SHAPES)
def test_attention_lse_and_backward_kernels_match_plain(cuda, shape):
    """K3 with the log-sum-exp (lse within 1e-4) and K4 (dq/dk/dv elementwise),
    unit-variance inputs (the model's q and k come out of a LayerNorm)."""
    gen = torch.Generator(cuda).manual_seed(2)
    q, k, v, dout = (torch.randn(*shape, generator=gen, device=cuda).bfloat16() for _ in range(4))
    out, lse = attention.attention_with_lse(q, k, v)
    want_out, want_lse = attention.attention_plain(q, k, v, return_lse=True)
    _close(out, want_out)
    assert float((lse - want_lse).abs().max()) <= 1e-4
    before = attention.bwd_launches
    got = attention.attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert attention.bwd_launches == before + 1
    for g, w in zip(got, attention.attention_backward_plain(q, k, v, out, lse, dout)):
        _close(g, w)


# Two small ragged shapes and the 3 s training shape (141 kv tiles of 48 heads: more blocks than the 132 SMs).
@pytest.mark.parametrize("shape", [(2, 1000, 3, 64), (3, 129, 2, 64), (1, 18048, 48, 64)])
def test_attention_backward_kernel_reruns_agree(cuda, shape):
    """K4 six times on the same inputs: every output element is one sum in a
    fixed order, so dq, dk and dv must be bit-identical on every rerun; each
    run is also held to the plain version."""
    gen = torch.Generator(cuda).manual_seed(7)
    q, k, v, dout = (torch.randn(*shape, generator=gen, device=cuda).bfloat16() for _ in range(4))
    out, lse = attention.attention_with_lse(q, k, v)
    want = attention.attention_backward_plain(q, k, v, out, lse, dout)
    first = attention.attention_backward(q, k, v, out, lse, dout)
    for _ in range(5):
        again = attention.attention_backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        for a, b, w in zip(again, first, want):
            assert torch.equal(a, b)
            _close(a, w)


def _linear_inputs(cuda, B, H, NC, seed, CS=16, F=64):
    gen = torch.Generator(cuda).manual_seed(seed)
    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=cuda) * std
    angles = torch.rand(NC, CS, F // 2, generator=gen, device=cuda) * 6.3
    return dict(
        XQ=randn(B, NC, CS, H * F).bfloat16(), XK=randn(B, NC, CS, H * F).bfloat16(),
        XV=randn(B, NC, CS, H * F).bfloat16(), gate=randn(B, H, NC, CS),
        rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
        rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
        ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1),
        W1=randn(H, F, F, std=0.02), b1=randn(H, 1, F, std=0.02),
    ), randn


# The slice's eta_scale (ttt_base_lr 1.0 / 64 / 16), and 100x and 1,000x it, where the state update moves the
# output far (the plain output then lies at least 10 tolerances from the eta = 0 output). Besides the first
# shapes: 3 x 48 scans (more blocks than the H100's 132 SMs), NC = 1, and NC = 17 (the two-stage ring wraps
# eight times; K = 5 leaves a last group of two). At CS 32, 48 and 64 (eta 1 / 64 / CS, and 100x it at 64):
# full and ragged groups, K past NC, and at 64 the one-stage raw ring and K6's single pass-B buffer over 17
# mini-batches and over 3 x 48 scans. At the half slabs of CS 8, 24, 40 and 56: ragged groups with the last
# mini-batch at the end of the tensors, 100x the eta at 8, and 17 mini-batches at 56.
@pytest.mark.parametrize("B,H,NC,K,scale,CS", [
    (2, 3, 9, 4, 1 / 1024, 16), (1, 2, 5, 2, 1 / 1024, 16), (1, 2, 3, 16, 1 / 1024, 16), (3, 48, 3, 2, 1 / 1024, 16),
    (1, 2, 1, 1, 1 / 1024, 16), (2, 2, 17, 5, 1 / 1024, 16), (1, 2, 7, 3, 0.1, 16), (1, 2, 7, 3, 1.0, 16),
    (2, 3, 8, 4, 1 / 2048, 32), (1, 2, 9, 4, 1 / 2048, 32), (1, 2, 7, 3, 1 / 3072, 48), (2, 2, 3, 16, 1 / 3072, 48),
    (2, 3, 8, 4, 1 / 4096, 64), (1, 2, 9, 4, 1 / 4096, 64), (2, 2, 17, 5, 1 / 4096, 64), (3, 48, 3, 2, 1 / 4096, 64),
    (1, 2, 7, 3, 100 / 4096, 64), (2, 3, 9, 4, 1 / 512, 8), (1, 2, 7, 3, 100 / 512, 8), (2, 3, 9, 4, 1 / 1536, 24),
    (2, 3, 9, 4, 1 / 2560, 40), (2, 3, 9, 4, 1 / 3584, 56), (2, 2, 17, 5, 1 / 3584, 56)])
def test_ttt_linear_kernels_match_plain(cuda, B, H, NC, K, scale, CS):
    """K5 for sampling (output elementwise), K5 for training (output
    elementwise; fp32 checkpoints within 1e-2 relative L2 and 1e-3 of their
    scale) and K6 (every gradient within 1e-2 relative L2 and 1e-2 of its
    scale; dXQ/dXK/dXV/d_gate also elementwise) against their plain versions,
    with a ragged last checkpoint group where K does not divide NC."""
    a, randn = _linear_inputs(cuda, B, H, NC, seed=4, CS=CS)
    if scale >= 0.02:
        want = ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=scale)
        assert _in_tolerances(want, ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=0.0)) >= 10
    before = (ttt_linear_kernel.launches, ttt_linear_kernel.train_launches, ttt_linear_kernel.bwd_launches)
    _close(ttt_linear_kernel.ttt_linear_forward(**a, eta_scale=scale),
           ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=scale))
    got = ttt_linear_kernel.ttt_linear_forward_train(**a, eta_scale=scale, checkpoint_group=K)
    want = ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=scale, checkpoint_group=K)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _scaled(g, w, 1e-3)
    dout = randn(*a["XQ"].shape).bfloat16()
    ins = [a[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    grads = ttt_linear_kernel.ttt_linear_backward(*ins, *want[1:], dout, scale, K)
    torch.cuda.synchronize()
    after = (ttt_linear_kernel.launches, ttt_linear_kernel.train_launches, ttt_linear_kernel.bwd_launches)
    assert after == tuple(x + 1 for x in before)
    plain = ttt_linear_kernel.ttt_linear_backward_plain(*ins, *want[1:], dout, scale, K)
    for i, (g, w) in enumerate(zip(grads, plain)):
        _scaled(g, w, 1e-2)
        if i < 4:  # dXQ, dXK, dXV, d_gate
            _close(g, w)


SPECIAL = [0.0, -0.0, float("inf"), float("-inf"), float("nan"), 3.4e38, -3.39e38, 1e-40, -1e-45, 1.00390625,
           1.01171875, -1.00390625, 3.0e-39]


@pytest.mark.parametrize("shape", [(3072, 512), (5, 7), (1, 13), (3, 4099)])
def test_convert_kernel_is_bit_identical(cuda, shape):
    """K7 against .to(torch.bfloat16), bit for bit (int16 views): random
    values and, at the front, ties, subnormals, signed zeros, +-inf, NaN and
    values past the bf16 maximum; sizes with and without a ragged tail (and
    one with whole 4,096-element tiles and a tail)."""
    gen = torch.Generator(cuda).manual_seed(5)
    x = torch.randn(*shape, generator=gen, device=cuda) * 100
    n = min(len(SPECIAL), x.numel())
    x.view(-1)[:n] = torch.tensor(SPECIAL[:n], device=cuda)
    before = convert.launches
    got = convert.convert_f32_bf16(x)
    torch.cuda.synchronize()
    assert convert.launches == before + 1 and got.dtype == torch.bfloat16 and got.shape == x.shape
    assert torch.equal(got.view(torch.int16), convert.convert_f32_bf16_plain(x).view(torch.int16))


def test_wrappers_raise_on_cuda_tensors_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 64, 3, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):
        attention.attention(q.float(), q.float(), q.float())
    lse = torch.zeros(2, 3, 64, device=cuda)
    with pytest.raises(ValueError):
        attention.attention_backward(q, q, q, q, lse[:, :2], q)
    # CS = 72, a multiple of 8 the JAX kernels take (past the port's 64): every TTT-MLP wrapper raises, naming the
    # mini-batches it takes.
    every = r"\(8, 16, 24, 32, 40, 48, 56, 64\)"
    x = torch.zeros(1, 2, 72, 128, device=cuda, dtype=torch.bfloat16)
    z = lambda *s: torch.zeros(*s, device=cuda)
    mlp = (x, x, x, z(1, 2, 2, 72), z(2, 72, 64), z(2, 72, 64), z(2, 64), z(2, 64))
    state = (z(2, 64, 256), z(2, 1, 256), z(2, 256, 64), z(2, 1, 64))
    with pytest.raises(ValueError, match=every):
        ttt_mlp_kernel.ttt_mlp_forward_train(*mlp, *state, 1e-3, 2)
    with pytest.raises(ValueError, match=every):
        ttt_mlp_kernel.ttt_mlp_forward(*mlp, *state, eta_scale=1e-3)
    with pytest.raises(ValueError, match=every):
        ttt_mlp_kernel.ttt_mlp_backward(*mlp, z(1, 2, 1, 64, 256), z(1, 2, 1, 1, 256), z(1, 2, 1, 256, 64),
                                        z(1, 2, 1, 1, 64), x, 1e-3, 2)
    k1 = _ttt_inputs(cuda, 1, 2, 2)
    k1["XQ"] = torch.zeros(2 * 16 * 128 + 1, device=cuda, dtype=torch.bfloat16)[1:].view(1, 2, 16, 128)
    with pytest.raises(ValueError):  # not 16-byte aligned
        ttt_mlp_kernel.ttt_mlp_forward(**k1, eta_scale=1e-3)
    # Each training and TTT-linear wrapper refuses a contiguous tensor one bf16 element off a 16-byte boundary.
    off = lambda t: torch.zeros(t.numel() + 1, device=cuda, dtype=t.dtype)[1:].view(t.shape)
    ta, _ = _train_inputs(cuda, 1, 2, 3, seed=6)
    with pytest.raises(ValueError, match="16-byte"):
        ttt_mlp_kernel.ttt_mlp_forward_train(**dict(ta, XK=off(ta["XK"])), eta_scale=1e-3, checkpoint_group=2)
    ck = ttt_mlp_kernel.ttt_mlp_forward_plain(**ta, eta_scale=1e-3, checkpoint_group=2)[1:]
    tins = [ta[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    with pytest.raises(ValueError, match="16-byte"):
        ttt_mlp_kernel.ttt_mlp_backward(*tins, *ck, off(ta["XQ"]), 1e-3, 2)
    la, _ = _linear_inputs(cuda, 1, 2, 3, seed=6)
    with pytest.raises(ValueError, match="16-byte"):
        ttt_linear_kernel.ttt_linear_forward(**dict(la, XV=off(la["XV"])), eta_scale=1e-3)
    with pytest.raises(ValueError, match="16-byte"):
        ttt_linear_kernel.ttt_linear_forward_train(**dict(la, XQ=off(la["XQ"])), eta_scale=1e-3, checkpoint_group=2)
    lck = ttt_linear_kernel.ttt_linear_forward_plain(**la, eta_scale=1e-3, checkpoint_group=2)[1:]
    lins = [la[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    with pytest.raises(ValueError, match="16-byte"):
        ttt_linear_kernel.ttt_linear_backward(*lins, *lck, off(la["XQ"]), 1e-3, 2)
    a, _ = _linear_inputs(cuda, 1, 2, 3, seed=6)
    a["W1"] = torch.zeros(2, 64, 256, device=cuda)  # a TTT-MLP state
    with pytest.raises(ValueError):
        ttt_linear_kernel.ttt_linear_forward(**a, eta_scale=1e-3)
    # A mini-batch no kernel is built for raises, naming the ones that are.
    a, _ = _linear_inputs(cuda, 1, 2, 3, seed=6, CS=72)
    with pytest.raises(ValueError, match=every):
        ttt_linear_kernel.ttt_linear_forward(**a, eta_scale=1e-3)
    with pytest.raises(ValueError, match=every):
        ttt_linear_kernel.ttt_linear_train(**a, eta_scale=1e-3, checkpoint_group=2)
    w = torch.zeros(64, 32, device=cuda)
    with pytest.raises(ValueError):
        convert.convert_f32_bf16(w.t())  # not contiguous
    with pytest.raises(ValueError):
        convert.convert_f32_bf16(w.double())


# The serving path's PyTorch modules on the card (no kernel of this
# repository: cuBLAS and cuDNN), held to the CPU with the same weights.
# T5 in bf16 on the card against float32 on the CPU, at T5's own
# initialisation: the bf16 activations' rounding, ~6e-3 relative L2 at 2
# layers on the CPU. The VAE in float32 on both, cuDNN's TF32 turned off by
# the VAE itself (this test leaves the global flag at its default): summation
# order and cuDNN's algorithm choice only.
T5_REL_L2 = 2e-2
VAE_REL_L2, VAE_MAX = 1e-4, 1e-3


def test_t5_bf16_on_the_card_matches_float32_on_the_cpu(cuda, tmp_path):
    import json
    from dataclasses import asdict

    from ttt_video_dit_torch.models.t5 import T5Config, T5Encoder, load_text_encoder
    from ttt_video_dit_torch.utils import safetensors

    cfg = T5Config(vocab_size=512, d_model=256, d_kv=64, d_ff=640, num_layers=2, num_heads=4,
                   feed_forward_proj="gated-gelu")
    enc = T5Encoder(cfg).to(torch.bfloat16).init_weights_(torch.Generator().manual_seed(0))
    (tmp_path / "config.json").write_text(json.dumps(asdict(cfg)))
    safetensors.save_file(enc.state_dict(), str(tmp_path / "model.safetensors"))
    ids = torch.randint(0, 512, (2, 200), generator=torch.Generator().manual_seed(1))
    got = load_text_encoder(str(tmp_path), "bfloat16", cuda).encode_ids(ids)
    assert got.device.type == "cuda" and got.dtype == torch.float32 and torch.isfinite(got).all()
    want = load_text_encoder(str(tmp_path), "float32", "cpu").encode_ids(ids)
    rel = float((got.cpu() - want).norm() / want.norm())
    assert rel <= T5_REL_L2, rel


def test_vae_decode_on_the_card_matches_the_cpu(cuda, tmp_path):
    from ttt_video_dit_torch.config.model_config import VaeModelConfig
    from ttt_video_dit_torch.models.vae.autoencoder import VideoAutoencoder
    from ttt_video_dit_torch.models.vae.enc_dec import Decoder3D

    torch.manual_seed(0)
    dec = Decoder3D(VaeModelConfig(ch=32, ch_mult=(1, 1, 2, 2), num_res_blocks=1, z_channels=16))
    torch.save({"state_dict": {f"decoder.{k}": v for k, v in dec.state_dict().items()}}, tmp_path / "vae.pt")
    z = torch.randn(1, 16, 5, 8, 8, generator=torch.Generator().manual_seed(1))
    tf32 = torch.backends.cudnn.allow_tf32
    got = VideoAutoencoder.load_decoder(str(tmp_path / "vae.pt"), device=cuda).decode_first_stage(z)
    assert torch.backends.cudnn.allow_tf32 == tf32  # restored after the decode
    want = VideoAutoencoder.load_decoder(str(tmp_path / "vae.pt")).decode_first_stage(z)
    assert got.shape == want.shape == (1, 3, 17, 64, 64) and torch.isfinite(got).all()
    got = got.cpu()
    assert float((got - want).norm() / want.norm()) <= VAE_REL_L2
    assert float((got - want).abs().max()) <= VAE_MAX * float(want.abs().max())


# The float32 kernels (float32 q/k/v), each against its plain version at a tenth of the bf16 tolerances
# (utils/selftest.py's F32_*): the outputs within 2e-5 of their largest value, the gradients within 2e-3 (the input
# gradients) and 1e-3 (the initial state's and the LN affine's). Nothing is rounded to bf16 on either side.
F32_FWD, F32_GRAD, F32_STATE = 2e-5, 2e-3, 1e-3


def _rel(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    return float((got - want).abs().max() / want.abs().max())


@pytest.mark.parametrize("variant", ["ttt_mlp", "ttt_linear"])
@pytest.mark.parametrize("CS", [8, 16, 40, 64])
def test_float32_kernels_match_plain(cuda, variant, CS):
    """K1/K1-train/K2 or K5/K5-train/K6 on float32 q/k/v: the sampling output, the training output and
    checkpoints (a ragged last group: NC 5, K 2) and every gradient of the backward against their plain versions,
    launched once each and counted as float32 launches, the bf16 counters unmoved."""
    mod = ttt_mlp_kernel if variant == "ttt_mlp" else ttt_linear_kernel
    a, randn = (_train_inputs(cuda, 2, 3, 5, seed=7, CS=CS) if variant == "ttt_mlp"
                else _linear_inputs(cuda, 2, 3, 5, seed=7, CS=CS))
    for k in ("XQ", "XK", "XV"):
        a[k] = a[k].float()
    scale, K = (0.1 if variant == "ttt_mlp" else 1.0) / 64 / CS, 2
    bf16 = (mod.launches, mod.train_launches, mod.bwd_launches)
    f32 = lambda: tuple(mod.f32_launches_by_cs[n, CS] for n in ("launches", "train_launches", "bwd_launches"))
    before = f32()
    fwd, fwd_train, bwd = (getattr(mod, f"{variant}_{n}") for n in ("forward", "forward_train", "backward"))
    fwd_plain, bwd_plain = getattr(mod, f"{variant}_forward_plain"), getattr(mod, f"{variant}_backward_plain")
    got = fwd(**a, eta_scale=scale)
    assert got.dtype == torch.float32 and _rel(got, fwd_plain(**a, eta_scale=scale)) <= F32_FWD
    got = fwd_train(**a, eta_scale=scale, checkpoint_group=K)
    want = fwd_plain(**a, eta_scale=scale, checkpoint_group=K)
    assert _rel(got[0], want[0]) <= F32_FWD
    for g, w in zip(got[1:], want[1:]):
        assert _rel(g, w) <= F32_FWD
    dout = randn(*a["XQ"].shape)
    ins = [a[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    grads = bwd(*ins, *want[1:], dout, scale, K)
    torch.cuda.synchronize()
    assert f32() == tuple(n + 1 for n in before) and (mod.launches, mod.train_launches, mod.bwd_launches) == bf16
    for i, (g, w) in enumerate(zip(grads, bwd_plain(*ins, *want[1:], dout, scale, K))):
        assert g.dtype == w.dtype and _rel(g, w) <= (F32_GRAD if i < 4 else F32_STATE), i


def test_float32_routes_and_refusals_on_the_card(cuda):
    """Float32 attention goes to the plain versions by the model's route (counted), bf16 to the kernels; a TTT
    scan at CS 12 goes plain, at CS 16 to the kernels; the TTT wrappers refuse float16 and mixed q/k/v, and a CS of
    72 in float32 too, naming the mini-batches the kernels take."""
    routes = attention.plain_routes
    assert attention.use_plain(True, torch.float32, cuda) and not attention.use_plain(True, torch.bfloat16, cuda)
    assert attention.plain_routes == routes + 1
    routes = ttt_mlp_kernel.plain_routes
    assert ttt_mlp_kernel.use_plain(True, 12, 64, cuda) and not ttt_mlp_kernel.use_plain(True, 16, 64, cuda)
    assert ttt_mlp_kernel.plain_routes == routes + 1
    a, _ = _linear_inputs(cuda, 1, 2, 3, seed=6)
    for dtypes in ((torch.float16,) * 3, (torch.float32, torch.bfloat16, torch.float32)):
        b = dict(a, **{k: a[k].to(dt) for k, dt in zip(("XQ", "XK", "XV"), dtypes)})
        with pytest.raises(ValueError, match="all bfloat16 or all float32"):
            ttt_linear_kernel.ttt_linear_forward(**b, eta_scale=1e-3)
    a, _ = _linear_inputs(cuda, 1, 2, 3, seed=6, CS=72)
    for k in ("XQ", "XK", "XV"):
        a[k] = a[k].float()
    with pytest.raises(ValueError, match=r"\(8, 16, 24, 32, 40, 48, 56, 64\)"):
        ttt_linear_kernel.ttt_linear_forward(**a, eta_scale=1e-3)


# Head dim 128 (d3072 at 24 heads): the sampling kernels alone. K3 at windows around its tiles (128 q rows a
# block, 128 kv rows a step) and at the 3 s slice's [2, 18,048, 24, 128]; K5 at CS 16 at one and two
# mini-batches, 17 (the ring wraps), 3 x 48 scans and at 1,000x the 3 s slice's eta (1 / 128 / 16), where the
# plain output lies at least 10 tolerances from the eta = 0 output. The elementwise tolerance of the top.
F128_ATTENTION_SHAPES = [(3, 417, 4, 128), (1, 100, 1, 128), (2, 127, 2, 128), (2, 128, 2, 128), (3, 129, 2, 128),
                         (2, 1000, 3, 128), (2, 18048, 24, 128)]


@pytest.mark.parametrize("shape", F128_ATTENTION_SHAPES)
def test_attention_kernel_at_head_dim_128_matches_plain(cuda, shape):
    gen = torch.Generator(cuda).manual_seed(3)
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda).mul(2).bfloat16() for _ in range(3))
    before, before_64 = attention.f128_launches, attention.launches
    got = attention.attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.f128_launches == before + 1 and attention.launches == before_64
    _close(got, attention.attention_plain(q, k, v))


@pytest.mark.parametrize("B,H,NC,factor", [(1, 1, 1, 1), (1, 2, 2, 1), (2, 3, 17, 1), (3, 48, 4, 1),
                                           (1, 2, 17, 1000)])
def test_ttt_linear_kernel_at_head_dim_128_matches_plain(cuda, B, H, NC, factor):
    a, _ = _linear_inputs(cuda, B, H, NC, seed=7, F=128)
    eta_scale = factor / 128 / 16
    before, before_64 = dict(ttt_linear_kernel.f128_launches_by_cs), ttt_linear_kernel.launches
    got = ttt_linear_kernel.ttt_linear_forward(**a, eta_scale=eta_scale)
    torch.cuda.synchronize()
    assert ttt_linear_kernel.f128_launches_by_cs["launches", 16] == before.get(("launches", 16), 0) + 1
    assert ttt_linear_kernel.launches == before_64
    want = ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=eta_scale)
    _close(got, want)
    if factor > 1:
        assert _in_tolerances(want, ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=0.0)) >= 10


# Head dim 128, training: K3-lse and K4 at the attention shapes above (K4's dk/dv tiles of 128 kv rows, its q
# ring of 64-row tiles, its dq tiles of 128 q rows), unit-variance inputs; K4 rerun bit-equal at a ragged shape and
# at the 3 s training slice [1, 18,048, 24, 128]. K5-train and K6 at CS 16: ragged groups, K past NC, one
# mini-batch, 17 (the ring wraps), 3 x 48 scans and 200x the 3 s slice's eta (1 / 128 / 16), where the plain output
# lies at least 10 tolerances from the eta = 0 output.
@pytest.mark.parametrize("shape", F128_ATTENTION_SHAPES[:-1] + [(1, 18048, 24, 128)])
def test_attention_lse_and_backward_kernels_at_head_dim_128_match_plain(cuda, shape):
    """K3-lse@F128 (lse within 1e-4) and K4@F128 (dq/dk/dv elementwise), counted in their own counters."""
    gen = torch.Generator(cuda).manual_seed(2)
    q, k, v, dout = (torch.randn(*shape, generator=gen, device=cuda).bfloat16() for _ in range(4))
    before = (attention.f128_lse_launches, attention.f128_bwd_launches, attention.lse_launches, attention.bwd_launches)
    out, lse = attention.attention_with_lse(q, k, v)
    got = attention.attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    after = (attention.f128_lse_launches, attention.f128_bwd_launches, attention.lse_launches, attention.bwd_launches)
    assert after == (before[0] + 1, before[1] + 1, before[2], before[3])
    want_out, want_lse = attention.attention_plain(q, k, v, return_lse=True)
    _close(out, want_out)
    assert float((lse - want_lse).abs().max()) <= 1e-4
    for g, w in zip(got, attention.attention_backward_plain(q, k, v, out, lse, dout)):
        _close(g, w)


@pytest.mark.parametrize("shape", [(3, 129, 2, 128), (1, 18048, 24, 128)])
def test_attention_backward_kernel_at_head_dim_128_reruns_agree(cuda, shape):
    """K4@F128 six times on the same inputs: dq, dk and dv bit-identical on every rerun."""
    gen = torch.Generator(cuda).manual_seed(7)
    q, k, v, dout = (torch.randn(*shape, generator=gen, device=cuda).bfloat16() for _ in range(4))
    out, lse = attention.attention_with_lse(q, k, v)
    first = attention.attention_backward(q, k, v, out, lse, dout)
    for _ in range(5):
        again = attention.attention_backward(q, k, v, out, lse, dout)
        torch.cuda.synchronize()
        for a, b in zip(again, first):
            assert torch.equal(a, b)


@pytest.mark.parametrize("B,H,NC,K,factor", [(2, 3, 9, 4, 1), (1, 2, 5, 2, 1), (1, 2, 3, 16, 1), (1, 2, 1, 1, 1),
                                             (2, 2, 17, 5, 1), (3, 48, 3, 2, 1), (1, 2, 7, 3, 200)])
def test_ttt_linear_training_kernels_at_head_dim_128_match_plain(cuda, B, H, NC, K, factor):
    """K5-train@F128 (output elementwise; fp32 checkpoints within 1e-2 relative L2 and 1e-3 of their scale) and
    K6@F128 (every gradient within 1e-2 relative L2 and 1e-2 of its scale; dXQ/dXK/dXV/d_gate also elementwise),
    counted in f128_launches_by_cs, the head-dim-64 counters unmoved."""
    a, randn = _linear_inputs(cuda, B, H, NC, seed=4, F=128)
    scale = factor / 128 / 16
    if factor > 1:
        want = ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=scale)
        assert _in_tolerances(want, ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=0.0)) >= 10
    by_cs = lambda: tuple(ttt_linear_kernel.f128_launches_by_cs[n, 16] for n in ("train_launches", "bwd_launches"))
    before, before_64 = by_cs(), (ttt_linear_kernel.train_launches, ttt_linear_kernel.bwd_launches)
    got = ttt_linear_kernel.ttt_linear_forward_train(**a, eta_scale=scale, checkpoint_group=K)
    want = ttt_linear_kernel.ttt_linear_forward_plain(**a, eta_scale=scale, checkpoint_group=K)
    _close(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        _scaled(g, w, 1e-3)
    dout = randn(*a["XQ"].shape).bfloat16()
    ins = [a[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    grads = ttt_linear_kernel.ttt_linear_backward(*ins, *want[1:], dout, scale, K)
    torch.cuda.synchronize()
    assert by_cs() == (before[0] + 1, before[1] + 1)
    assert (ttt_linear_kernel.train_launches, ttt_linear_kernel.bwd_launches) == before_64
    plain = ttt_linear_kernel.ttt_linear_backward_plain(*ins, *want[1:], dout, scale, K)
    for i, (g, w) in enumerate(zip(grads, plain)):
        _scaled(g, w, 1e-2)
        if i < 4:  # dXQ, dXK, dXV, d_gate
            _close(g, w)


def test_head_dim_128_training_and_ttt_mlp_raise_on_the_card(cuda):
    """At head dim 128 the TTT-linear kernels take CS 16 in bf16 and TTT-MLP has no kernel: K5, K5-train and K6
    at another CS or on float32 q/k/v, and every TTT-MLP kernel, raise ValueError naming what they take."""
    a, _ = _linear_inputs(cuda, 1, 2, 3, seed=6, F=128)
    takes = r"\{64: \(8, 16, 24, 32, 40, 48, 56, 64\), 128: \(16,\)\}"
    ins = [a[k] for k in ("XQ", "XK", "XV", "gate", "rope_cos", "rope_sin", "ln_w", "ln_b")]
    f32 = dict(a, **{k: a[k].float() for k in ("XQ", "XK", "XV")})
    with pytest.raises(ValueError, match="takes bfloat16"):
        ttt_linear_kernel.ttt_linear_forward(**f32, eta_scale=1e-3)
    with pytest.raises(ValueError, match="takes bfloat16"):
        ttt_linear_kernel.ttt_linear_forward_train(**f32, eta_scale=1e-3, checkpoint_group=2)
    ck = (torch.zeros(1, 2, 2, 128, 128, device=cuda), torch.zeros(1, 2, 2, 1, 128, device=cuda))
    with pytest.raises(ValueError, match="takes bfloat16"):
        ttt_linear_kernel.ttt_linear_backward(*[f32[k] for k in ("XQ", "XK", "XV")], *ins[3:], *ck,
                                              f32["XQ"], 1e-3, 2)
    b, _ = _linear_inputs(cuda, 1, 2, 3, seed=6, CS=32, F=128)
    with pytest.raises(ValueError, match=takes + r"; got F=128, CS=32"):
        ttt_linear_kernel.ttt_linear_forward(**b, eta_scale=1e-3)
    with pytest.raises(ValueError, match=takes + r"; got F=128, CS=32"):
        ttt_linear_kernel.ttt_linear_forward_train(**b, eta_scale=1e-3, checkpoint_group=2)
    H, F = 2, 128
    z = lambda *s: torch.zeros(*s, device=cuda)
    mlp = ins + [z(H, F, 4 * F), z(H, 1, 4 * F), z(H, 4 * F, F), z(H, 1, F)]
    with pytest.raises(ValueError, match=r"F=64 and CS in \(8, 16, 24, 32, 40, 48, 56, 64\); got F=128"):
        ttt_mlp_kernel.ttt_mlp_forward(*mlp, eta_scale=1e-3)


def test_kernel_selftest_holds_every_kernel_on_the_card(cuda):
    """utils/selftest.py:kernel_selftest, the benchmark's check before it times anything: every check within
    its tolerance, every kernel launched."""
    from ttt_video_dit_torch.utils.selftest import kernel_selftest

    result = kernel_selftest(cuda)
    assert result["ok"], {n: e for n, e in result["checks"].items() if not e <= result["tolerances"][n]}


def prefix_windows_step(device, runs: int = 2):
    """``runs`` forward + backward passes of a 2-layer bf16 DiT at prefix 2
    (38 frames = 2 + 3 windows x 12, 3 scenes of 32 text tokens, 8 x 8
    latents: L = 704 = 11 mini-batches of 64; 2 heads of 64, remat save_seq)
    on the same weights and inputs: [(loss, output, {name: gradient})]."""
    from ttt_video_dit_torch.config.model_config import ModelConfig
    from ttt_video_dit_torch.models.dit.dit import DiffusionTransformer, init_params_

    cfg = ModelConfig(model_dim=128, num_heads=2, num_layers=2, ssm_layer="ttt_mlp", mini_batch_size=64,
                      latent_height=8, latent_width=8, compressed_num_frames=38, attn_length=12,
                      prefix_temporal_length=2, text_dim=64, time_embed_dim=64, scan_checkpoint_group_size=4,
                      use_kernel=True, dtype="bfloat16", remat_policy="save_seq")
    model = init_params_(DiffusionTransformer(cfg), torch.Generator().manual_seed(0)).to(device)
    gen = torch.Generator().manual_seed(1)
    video = torch.randn(1, 38, 16, 8, 8, generator=gen).to(device, torch.bfloat16)
    text = torch.randn(1, 3, 32, 64, generator=gen).to(device)
    timesteps, cot = torch.tensor([600.0], device=device), torch.randn(video.shape, generator=gen).to(device)
    out = []
    for _ in range(runs):
        model.zero_grad(set_to_none=True)
        y = model(video, text, timesteps)
        loss = (y.float() * cot).mean()
        loss.backward()
        out.append((loss.detach(), y.detach(), {n: p.grad.clone() for n, p in model.named_parameters()}))
    return out


def test_prefix_windows_training_step_reruns_agree(cuda):
    """Two kernel-path runs at prefix_temporal_length 2 (the window gather and
    stitch sum in a fixed order; K1-train, K2, K3-lse and K4 launched):
    the loss, the output and every gradient bit-equal."""
    before = (ttt_mlp_kernel.train_launches, ttt_mlp_kernel.bwd_launches, attention.lse_launches,
              attention.bwd_launches)
    (loss_a, out_a, grads_a), (loss_b, out_b, grads_b) = prefix_windows_step(cuda)
    after = (ttt_mlp_kernel.train_launches, ttt_mlp_kernel.bwd_launches, attention.lse_launches,
             attention.bwd_launches)
    assert all(b > a for a, b in zip(before, after))
    assert torch.isfinite(out_a).all() and out_a.shape == (1, 38, 16, 8, 8)
    assert torch.equal(loss_a, loss_b) and torch.equal(out_a, out_b)
    for name, g in grads_a.items():
        assert torch.equal(g, grads_b[name]), name
