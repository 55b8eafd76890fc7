"""Kernels K1 and K2 on the card: the hand-written CUDA kernels against their
plain PyTorch versions. K1: float32 atol 2e-5; bfloat16 atol = rtol = 1.6e-2
against the plain version in float32 on the same bf16 inputs. K2 returns
float32 whatever its inputs, so it is held at float32 level against the plain
version computed in float32 from the same inputs: acc/l atol 2e-5 and rtol
1e-5, m atol 2e-5 and rtol 1e-6, l atol 2e-5 and rtol 5e-5 (sums of up to
2048 exponentials in another order).

Marked ``cuda``: it skips where there is no CUDA device (the kernel has no
CPU or interpret mode). This file imports neither JAX nor the JAX package,
so it also runs on a machine that has only torch and nvcc:

    TPUSERVE_TEST_TPU=1 python -m pytest tests/test_torch_kernels_cuda.py -m cuda
"""

import pytest
import torch

from tpuserve_torch.ops import flash_attention as fa

pytestmark = pytest.mark.cuda


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, sq, sk, h, d", [
    (2, 64, 64, 12, 64), (2, 128, 128, 12, 64), (1, 77, 77, 3, 64),
    (2, 64, 100, 4, 40), (2, 192, 192, 2, 128),
])
def test_kernel_matches_plain_version(cuda, dtype, b, sq, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    bias = torch.zeros(b, sk, device=cuda)
    bias[0, sk // 2:] = -1e9
    before = fa.launches
    out = fa.flash_attention(q, k, v, bias)
    assert fa.launches == before + 1
    ref = fa.flash_attention_reference(q.float(), k.float(), v.float(), bias)
    tol = (2e-5, 0.0) if dtype == torch.float32 else (1.6e-2, 1.6e-2)
    torch.testing.assert_close(out.float(), ref, atol=tol[0], rtol=tol[1])


def test_kernel_reads_strided_views(cuda):
    """q/k/v sliced from one fused (B, S, 3, H, D) projection: K1 reads the
    views through their strides, no copy."""
    qkv = torch.randn(2, 77, 3, 4, 64, device=cuda)
    q, k, v = qkv.unbind(dim=2)
    assert not q.is_contiguous()
    out = fa.flash_attention(q, k, v)
    ref = fa.flash_attention_reference(q, k, v)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=0)


def assert_stats_close(got, want):
    acc, m, l = got
    racc, rm, rl = want
    torch.testing.assert_close(acc / l[..., None], racc / rl[..., None], atol=2e-5, rtol=1e-5)
    torch.testing.assert_close(m, rm, atol=2e-5, rtol=1e-6)
    torch.testing.assert_close(l, rl, atol=2e-5, rtol=5e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, sq, sk, h, d", [
    (2, 128, 128, 12, 64), (1, 77, 77, 3, 64), (2, 64, 100, 4, 40),
    (2, 100, 64, 4, 64), (2, 512, 512, 12, 64), (2, 192, 192, 2, 128),
])
def test_stats_kernel_matches_plain_version(cuda, dtype, b, sq, sk, h, d):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(b, s, h, d, generator=g, device=cuda).to(dtype)
               for s in (sq, sk, sk))
    bias = torch.zeros(b, sk, device=cuda)
    bias[0, sk // 2:] = -1e9
    bias[-1, :] = -1e9                    # a fully masked row (padded lane)
    before = (fa.launches, fa.stats_launches)
    got = fa.flash_attention(q, k, v, bias, return_stats=True)
    assert (fa.launches, fa.stats_launches) == (before[0], before[1] + 1)
    assert [t.dtype for t in got] == [torch.float32] * 3
    assert [tuple(t.shape) for t in got] == [(b, sq, h, d), (b, sq, h), (b, sq, h)]
    want = fa.flash_attention_stats_reference(q.float(), k.float(), v.float(), bias)
    assert_stats_close(got, want)


def test_stats_kernel_reads_strided_views_and_inf_bias(cuda):
    """Strided q/k/v views of one fused projection, and a row whose keys all
    carry -inf: m = -1e30, l = 0, acc = 0, as the reference kernel gives."""
    qkv = torch.randn(2, 77, 3, 4, 64, device=cuda)
    q, k, v = qkv.unbind(dim=2)
    bias = torch.zeros(2, 77, device=cuda)
    bias[1, :] = -torch.inf
    acc, m, l = fa.flash_attention(q, k, v, bias, return_stats=True)
    racc, rm, rl = fa.flash_attention_stats_reference(q, k, v, bias)
    torch.testing.assert_close(acc[0] / l[0][..., None], racc[0] / rl[0][..., None],
                               atol=2e-5, rtol=1e-5)
    assert bool((m[1] == fa.NEG_INF).all() and (l[1] == 0).all() and (acc[1] == 0).all())
