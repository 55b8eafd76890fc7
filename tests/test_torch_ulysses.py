"""Port parity for Ulysses attention (``tpuserve_torch.ops.ulysses``) against
the JAX package's ``ulysses_attention`` on ``make_mesh(MeshPlan(sp=n))``
over n of the 8 fake CPU devices from ``tests/conftest.py`` (its flash local
step runs the Pallas kernel in interpret mode). The port's n ranks share the
CPU; its flash local step takes K1's plain version. Same numpy inputs on
both sides.

Tolerances: float32 atol 1e-5 (the same attention, sums in two orders);
bfloat16 inputs atol 1.6e-2 (outputs rounded to bf16 on both sides
independently).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.ops import dense_attention as jax_dense
from tpuserve.ops import ulysses_attention as jax_ulysses
from tpuserve.parallel import make_mesh as jax_make_mesh
from tpuserve.parallel.mesh import MeshPlan as JaxMeshPlan
from tpuserve_torch.ops import ulysses_attention
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.parallel import MeshPlan, make_mesh


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def meshes(n):
    return (make_mesh(MeshPlan(sp=n), devices=["cpu"] * n),
            jax_make_mesh(JaxMeshPlan(sp=n), devices=jax.devices()[:n]))


def qkv(seed, b=2, s=64, h=4, d=64):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3)]


def padding(b, s, lane=None):
    """-1e9 per-key bias: the tail of lane 0 padded; optionally a whole lane."""
    bias = np.zeros((b, s), np.float32)
    bias[0, s - s // 8:] = -1e9
    if lane is not None:
        bias[lane, :] = -1e9
    return bias


def both(q, k, v, bias, n, local_impl, dtype=torch.float32):
    mesh, jmesh = meshes(n)
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    got = ulysses_attention(t(q), t(k), t(v), mesh, key_padding=torch.from_numpy(bias),
                            local_impl=local_impl)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_ulysses(*(jnp.asarray(x, jdt) for x in (q, k, v)), jmesh,
                       key_padding=jnp.asarray(bias), local_impl=local_impl)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("local_impl", ["flash", "dense"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_matches_jax_ulysses(n, local_impl):
    q, k, v = qkv(n)
    got, want = both(q, k, v, padding(2, 64), n, local_impl)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 4, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("local_impl", ["flash", "dense"])
def test_padded_lane_matches_jax_and_dense(local_impl):
    q, k, v = qkv(5)
    bias = padding(2, 64, lane=1)
    got, want = both(q, k, v, bias, 4, local_impl)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ref = jax_dense(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias)[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


@pytest.mark.parametrize("local_impl", ["flash", "dense"])
def test_bf16_inputs_match_jax_ulysses(local_impl):
    q, k, v = qkv(7)
    got, want = both(q, k, v, padding(2, 64), 2, local_impl, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1.6e-2)


def test_heads_must_divide_by_the_seq_axis():
    """6 heads over 4 ranks: both packages refuse with the same message."""
    q, k, v = qkv(8, h=6)
    mesh, jmesh = meshes(4)
    with pytest.raises(ValueError, match=r"local heads \(6\) divisible by the 'seq' axis size \(4\)"):
        ulysses_attention(*(torch.from_numpy(x) for x in (q, k, v)), mesh)
    with pytest.raises(ValueError, match=r"local heads \(6\) divisible by the 'seq' axis size \(4\)"):
        jax_ulysses(*(jnp.asarray(x) for x in (q, k, v)), jmesh)


def test_flash_local_runs_k1s_plain_version(monkeypatch):
    calls = []
    plain = fa.flash_attention_reference
    monkeypatch.setattr(fa, "flash_attention_reference",
                        lambda *a: calls.append(a[0].shape) or plain(*a))
    q, k, v = (torch.from_numpy(x) for x in qkv(9))
    mesh, _ = meshes(4)
    ulysses_attention(q, k, v, mesh, local_impl="flash")
    # One K1 call per rank, each over the full sequence and its head slice.
    assert calls == [(2, 64, 1, 64)] * 4


def test_spec_and_local_impl_are_checked():
    q = torch.zeros(2, 8, 4, 64)
    mesh, _ = meshes(2)
    with pytest.raises(ValueError, match="seq dim"):
        ulysses_attention(q, q, q, mesh, spec=(None, None, "seq", None))
    with pytest.raises(ValueError, match="unknown local_impl"):
        ulysses_attention(q, q, q, mesh, local_impl="sparse")
