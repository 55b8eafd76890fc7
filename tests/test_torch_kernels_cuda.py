"""Kernels K1 and K2 on the card: the hand-written CUDA kernels against their
plain PyTorch versions, computed in float32 from the same inputs.

Tolerances, with their reason:

- float32 inputs (the CUDA-core kernel, full float32): K1 atol 2e-5; K2
  acc/l atol 2e-5 and rtol 1e-5, m atol 2e-5 and rtol 1e-6, l atol 2e-5 and
  rtol 5e-5 (sums of up to 2048 exponentials in another order).
- bfloat16 and float16 inputs (the tensor-core kernel): the kernel rounds P
  to the input dtype before P.V, as the reference's f32 dot_general does on
  the TPU (one bf16 pass of the MXU), so |d(acc/l)| <= max|v| * 2^-8 (bf16's
  unit roundoff; 2^-11 for float16). K1's
  output and K2's acc/l are held at atol = rtol = 1.6e-2. Scores, m and l
  stay float32, so m and l keep the float32 tolerances above.

Marked ``cuda``: it skips where there is no CUDA device (the kernels have no
CPU or interpret mode). This file imports neither JAX nor the JAX package,
so it also runs on a machine that has only torch and nvcc:

    TPUSERVE_TEST_TPU=1 python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest
import torch

from tpuserve_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda

LOW_TOL = 1.6e-2   # K1's output and K2's acc/l for 16-bit inputs


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 and K2 run only on the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def inputs(cuda, b, sq, sk, h, d, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    bias = torch.zeros(b, sk, device=cuda)
    bias[0, sk // 2:] = -1e9
    return q, k, v, bias


def assert_out_close(out, ref, dtype):
    tol = (2e-5, 0.0) if dtype == torch.float32 else (LOW_TOL, LOW_TOL)
    torch.testing.assert_close(out.float(), ref, atol=tol[0], rtol=tol[1])


# Shapes at the tensor-core tiling's edges: Sq not a multiple of the row
# tile (77, 200), Sk not a multiple of the key tile (100, 333), head dims
# padded inside a 64-wide box (40) or over two boxes (80, 128).
SHAPES = [
    (2, 64, 64, 12, 64), (2, 128, 128, 12, 64), (1, 77, 77, 3, 64),
    (2, 64, 100, 4, 40), (2, 192, 192, 2, 128), (2, 200, 333, 3, 64),
    (1, 77, 100, 2, 80), (2, 200, 64, 2, 128), (1, 48, 333, 2, 16),
]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b, sq, sk, h, d", SHAPES)
def test_kernel_matches_plain_version(cuda, dtype, b, sq, sk, h, d):
    q, k, v, bias = inputs(cuda, b, sq, sk, h, d, dtype, seed=0)
    before, shape_before = fa.launches, fa.shape_launches.get((b, sq, h, d), 0)
    out = fa.flash_attention(q, k, v, bias)
    assert fa.launches == before + 1
    assert fa.shape_launches[(b, sq, h, d)] == shape_before + 1
    assert out.dtype == dtype and out.shape == q.shape
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), bias)
    assert_out_close(out, ref, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_strided_views(cuda, dtype):
    """q/k/v sliced from one fused (B, S, 3, H, D) projection: K1 reads the
    views through their strides, no copy."""
    qkv = torch.randn(2, 77, 3, 4, 64, device=cuda).to(dtype)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float())
    assert_out_close(out, ref, dtype)


def assert_stats_close(got, want, dtype=torch.float32):
    acc, m, l = got
    racc, rm, rl = want
    tol = (2e-5, 1e-5) if dtype == torch.float32 else (LOW_TOL, LOW_TOL)
    torch.testing.assert_close(acc / l[..., None], racc / rl[..., None], atol=tol[0], rtol=tol[1])
    torch.testing.assert_close(m, rm, atol=2e-5, rtol=1e-6)
    torch.testing.assert_close(l, rl, atol=2e-5, rtol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("b, sq, sk, h, d", [
    (2, 128, 128, 12, 64), (1, 77, 77, 3, 64), (2, 64, 100, 4, 40),
    (2, 100, 64, 4, 64), (2, 512, 512, 12, 64), (2, 192, 192, 2, 128),
    (2, 200, 333, 3, 64), (1, 77, 100, 2, 80),
])
def test_stats_kernel_matches_plain_version(cuda, dtype, b, sq, sk, h, d):
    q, k, v, bias = inputs(cuda, b, sq, sk, h, d, dtype, seed=1)
    bias[-1, :] = -1e9                    # a fully masked row (padded lane)
    before = (fa.launches, fa.stats_launches)
    got = fa.flash_attention(q, k, v, bias, return_stats=True)
    assert (fa.launches, fa.stats_launches) == (before[0], before[1] + 1)
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert [tuple(t.shape) for t in got] == [(b, sq, h, d), (b, sq, h), (b, sq, h)]
    want = fa.flash_attention_stats_reference(q.float(), k.float(), v.float(), bias)
    assert_stats_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stats_kernel_reads_strided_views_and_inf_bias(cuda, dtype):
    """Strided q/k/v views of one fused projection, and a row whose keys all
    carry -inf: m = -1e30, l = 0, acc = 0, as the reference kernel gives."""
    qkv = torch.randn(2, 77, 3, 4, 64, device=cuda).to(dtype)
    q, k, v = qkv.unbind(dim=2)
    bias = torch.zeros(2, 77, device=cuda)
    bias[1, :] = -torch.inf
    acc, m, l = fa.flash_attention(q, k, v, bias, return_stats=True)
    racc, rm, rl = fa.flash_attention_stats_reference(q.float(), k.float(), v.float(), bias)
    tol = (2e-5, 1e-5) if dtype == torch.float32 else (LOW_TOL, LOW_TOL)
    torch.testing.assert_close(acc[0] / l[0][..., None], racc[0] / rl[0][..., None],
                               atol=tol[0], rtol=tol[1])
    assert bool((m[1] == fa.NEG_INF).all() and (l[1] == 0).all() and (acc[1] == 0).all())


@pytest.mark.parametrize("return_stats", [False, True])
def test_tensor_core_kernels_refuse_unaligned_strides(cuda, return_stats):
    """A 16-bit view whose head stride is 136 bytes cannot be read by TMA:
    the wrapper raises, it never falls back."""
    x = torch.randn(2, 64, 4, 68, device=cuda).to(torch.bfloat16)[..., :64]
    before = (fa.launches, fa.stats_launches)
    with pytest.raises(ValueError, match="multiple of 16"):
        fa.flash_attention(x, x, x, return_stats=return_stats)
    assert (fa.launches, fa.stats_launches) == before
