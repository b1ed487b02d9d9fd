"""The port's CUDA kernels against their plain versions, on a CUDA card.

Marked ``gpu``: without a card every test skips. On a machine with one (and
no JAX), run them without the JAX-side conftest:

    python -m pytest --noconftest -m gpu tests/test_torch_cuda.py -q

Tolerance, elementwise on the bf16 outputs: |kernel - plain| <= 2e-2 + 2e-2 * |plain|
(a few bf16 ulps: both sides round at the same points, only the float32
summation order differs, and attention rounds P to bf16 before P V).
"""

import pytest

torch = pytest.importorskip("torch")

from ttt_video_dit_torch.ops import attention, ttt_mlp_kernel  # noqa: E402

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


@pytest.mark.parametrize("B,H,NC", [(1, 3, 9), (2, 2, 1)])
def test_ttt_kernel_matches_plain(cuda, B, H, NC):
    gen = torch.Generator(cuda).manual_seed(0)
    CS, F = 16, 64
    randn = lambda *s, std=1.0: torch.randn(*s, generator=gen, device=cuda) * std
    angles = torch.rand(NC, CS, F // 2, generator=gen, device=cuda) * 6.3
    args = dict(
        XQ=randn(B, NC, CS, H * F).bfloat16(), XK=randn(B, NC, CS, H * F).bfloat16(),
        XV=randn(B, NC, CS, H * F).bfloat16(), gate=randn(B, H, NC, CS),
        rope_cos=torch.cos(angles).repeat_interleave(2, -1).contiguous(),
        rope_sin=torch.sin(angles).repeat_interleave(2, -1).contiguous(),
        ln_w=1 + randn(H, F, std=0.1), ln_b=randn(H, F, std=0.1),
        W1=randn(H, F, 4 * F, std=0.02), b1=randn(H, 1, 4 * F, std=0.02),
        W2=randn(H, 4 * F, F, std=0.02), b2=randn(H, 1, F, std=0.02),
    )
    before = ttt_mlp_kernel.launches
    got = ttt_mlp_kernel.ttt_mlp_forward(**args, eta_scale=1e-4)
    torch.cuda.synchronize()
    assert ttt_mlp_kernel.launches == before + 1
    _close(got, ttt_mlp_kernel.ttt_mlp_forward_plain(**args, eta_scale=1e-4))


@pytest.mark.parametrize("shape", [(3, 417, 2, 64), (1, 64, 1, 64), (2, 1000, 3, 64), (1, 5, 2, 64)])
def test_attention_kernel_matches_plain(cuda, shape):
    gen = torch.Generator(cuda).manual_seed(1)
    q, k, v = (torch.randn(*shape, generator=gen, device=cuda).mul(2).bfloat16() for _ in range(3))
    before = attention.launches
    got = attention.attention(q, k, v)
    torch.cuda.synchronize()
    assert attention.launches == before + 1
    _close(got, attention.attention_plain(q, k, v))


def test_wrappers_raise_on_cuda_tensors_the_kernels_do_not_take(cuda):
    q = torch.zeros(2, 64, 3, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        attention.attention(q.transpose(1, 2), q.transpose(1, 2), q.transpose(1, 2))
    with pytest.raises(ValueError):
        attention.attention(q.float(), q.float(), q.float())
