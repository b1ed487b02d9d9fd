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


def _ttt_inputs(cuda, B, H, NC, seed=0):
    gen = torch.Generator(cuda).manual_seed(seed)
    CS, F = 16, 64
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
# ring wraps in a step), and 3 x 48 scans, more blocks than the H100's 132 SMs.
@pytest.mark.parametrize("B,H,NC", [(1, 3, 9), (2, 2, 1), (1, 2, 1), (2, 3, 2), (2, 2, 17), (3, 48, 3)])
def test_ttt_kernel_matches_plain(cuda, B, H, NC):
    args = _ttt_inputs(cuda, B, H, NC)
    before = ttt_mlp_kernel.launches
    got = ttt_mlp_kernel.ttt_mlp_forward(**args, eta_scale=1e-4)
    torch.cuda.synchronize()
    assert ttt_mlp_kernel.launches == before + 1
    _close(got, ttt_mlp_kernel.ttt_mlp_forward_plain(**args, eta_scale=1e-4))


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


def _train_inputs(cuda, B, H, NC, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    CS, F = 64, 64
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


# The training slice's eta_scale (ttt_base_lr 0.1 / 64 / 64), and 4,096x and 40,960x it, where the state update
# moves the output far (the plain output then lies at least 10 tolerances from the eta = 0 output).
@pytest.mark.parametrize("B,H,NC,K,scale", [(1, 2, 5, 2, 0.1 / 64 / 64), (2, 3, 3, 16, 0.1 / 64 / 64),
                                            (1, 2, 5, 2, 0.1), (1, 2, 5, 2, 1.0)])
def test_ttt_train_and_backward_kernels_match_plain(cuda, B, H, NC, K, scale):
    """K1-train (output elementwise; fp32 checkpoints within 1e-2 relative L2
    and 1e-3 of their scale) and K2 (every gradient within 1e-2 relative L2
    and 1e-2 of its scale; dXQ/dXK/dXV/d_gate also elementwise) against their
    plain versions, at CS = 64 with a ragged last checkpoint group."""
    a, randn = _train_inputs(cuda, B, H, NC, seed=3)
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


@pytest.mark.parametrize("shape", [(2, 1000, 3, 64), (3, 129, 2, 64)])
def test_attention_backward_kernel_reruns_agree(cuda, shape):
    """K4 twice on the same inputs: dk and dv are sums in a fixed order and
    must be bit-identical; dq is added across blocks in float32 in an order
    that changes from run to run, so the two dq agree within the elementwise
    tolerance (and each is held to the plain version)."""
    gen = torch.Generator(cuda).manual_seed(7)
    q, k, v, dout = (torch.randn(*shape, generator=gen, device=cuda).bfloat16() for _ in range(4))
    out, lse = attention.attention_with_lse(q, k, v)
    first = attention.attention_backward(q, k, v, out, lse, dout)
    second = attention.attention_backward(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    assert torch.equal(first[1], second[1]) and torch.equal(first[2], second[2])
    _close(second[0], first[0])
    _close(second[0], attention.attention_backward_plain(q, k, v, out, lse, dout)[0])


def _linear_inputs(cuda, B, H, NC, seed):
    gen = torch.Generator(cuda).manual_seed(seed)
    CS, F = 16, 64
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
# eight times; K = 5 leaves a last group of two).
@pytest.mark.parametrize("B,H,NC,K,scale", [(2, 3, 9, 4, 1 / 1024), (1, 2, 5, 2, 1 / 1024), (1, 2, 3, 16, 1 / 1024),
                                            (3, 48, 3, 2, 1 / 1024), (1, 2, 1, 1, 1 / 1024), (2, 2, 17, 5, 1 / 1024),
                                            (1, 2, 7, 3, 0.1), (1, 2, 7, 3, 1.0)])
def test_ttt_linear_kernels_match_plain(cuda, B, H, NC, K, scale):
    """K5 for sampling (output elementwise), K5 for training (output
    elementwise; fp32 checkpoints within 1e-2 relative L2 and 1e-3 of their
    scale) and K6 (every gradient within 1e-2 relative L2 and 1e-2 of its
    scale; dXQ/dXK/dXV/d_gate also elementwise) against their plain versions,
    with a ragged last checkpoint group where K does not divide NC."""
    a, randn = _linear_inputs(cuda, B, H, NC, seed=4)
    if scale >= 0.1:
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
    x = torch.zeros(1, 2, 16, 128, device=cuda, dtype=torch.bfloat16)  # CS = 16: the sampling kernel's, not training's
    z = lambda *s: torch.zeros(*s, device=cuda)
    with pytest.raises(ValueError):
        ttt_mlp_kernel.ttt_mlp_forward_train(x, x, x, z(1, 2, 2, 16), z(2, 16, 64), z(2, 16, 64), z(2, 64), z(2, 64),
                                             z(2, 64, 256), z(2, 1, 256), z(2, 256, 64), z(2, 1, 64), 1e-3, 2)
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


def test_kernel_selftest_holds_every_kernel_on_the_card(cuda):
    """utils/selftest.py:kernel_selftest, the benchmark's check before it times anything: every check within
    its tolerance, every kernel launched."""
    from ttt_video_dit_torch.utils.selftest import kernel_selftest

    result = kernel_selftest(cuda)
    assert result["ok"], {n: e for n, e in result["checks"].items() if not e <= result["tolerances"][n]}
