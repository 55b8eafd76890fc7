"""Kernel K1 on the card: the hand-written CUDA kernel against its plain
PyTorch version (float32 atol 2e-5; bfloat16 atol = rtol = 1.6e-2 against
the plain version in float32 on the same bf16 inputs).

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
        pytest.skip("needs a CUDA device: K1 runs only on the card")
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
