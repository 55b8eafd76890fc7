"""Port parity for ring attention (``tpuserve_torch.ops.ring_attention``) and
the mesh it runs over (``tpuserve_torch.parallel.mesh``), against the JAX
package's ``ring_attention`` on ``make_mesh(MeshPlan(sp=n))`` over n of the
8 fake CPU devices from ``tests/conftest.py`` (its flash local step runs the
Pallas kernel in interpret mode). The port's n ranks share the CPU; its flash
local step takes K2's plain version. Same numpy inputs on both sides.

Tolerances: float32 atol 1e-5 (the same online-softmax merge, sums in two
orders); bfloat16 inputs atol 1.6e-2 (outputs rounded to bf16 on both sides
independently; the dense local step also rounds its scores to bf16).
"""

import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuserve.ops import dense_attention as jax_dense
from tpuserve.ops import ring_attention as jax_ring
from tpuserve.parallel import make_mesh as jax_make_mesh
from tpuserve.parallel.mesh import MeshPlan as JaxMeshPlan
from tpuserve_torch.ops import dense_attention, ring_attention
from tpuserve_torch.ops import flash_attention as fa
from tpuserve_torch.parallel import Mesh, MeshPlan, make_mesh

ra = importlib.import_module("tpuserve_torch.ops.ring_attention")
jra = importlib.import_module("tpuserve.ops.ring_attention")


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


def padding(b, s, masked_block=None, n=1, lane=None, value=-1e9):
    """Additive per-key bias: the tail of lane 0 padded, optionally one
    rank's whole key block and one whole lane masked."""
    bias = np.zeros((b, s), np.float32)
    bias[0, s - s // 8:] = value
    if masked_block is not None:
        blk = s // n
        bias[:, masked_block * blk:(masked_block + 1) * blk] = value
    if lane is not None:
        bias[lane, :] = value
    return bias


def both(q, k, v, bias, n, local_impl, dtype=torch.float32):
    mesh, jmesh = meshes(n)
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    got = ring_attention(t(q), t(k), t(v), mesh, key_padding=torch.from_numpy(bias),
                         local_impl=local_impl)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = jax_ring(*(jnp.asarray(x, jdt) for x in (q, k, v)), jmesh,
                    key_padding=jnp.asarray(bias), local_impl=local_impl)
    return got, np.asarray(want, np.float32)


@pytest.mark.parametrize("local_impl", ["flash", "dense"])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_matches_jax_ring(n, local_impl):
    q, k, v = qkv(n)
    got, want = both(q, k, v, padding(2, 64), n, local_impl)
    assert got.dtype == torch.float32 and got.shape == (2, 64, 4, 64)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("local_impl", ["flash", "dense"])
def test_masked_rank_block_and_padded_lane_match_jax_and_dense(local_impl):
    """-1e9 padding: rank 2's whole key block masked and lane 1 all padding
    (a padded batch lane); the ring equals the JAX ring and plain dense
    attention, and stays finite."""
    q, k, v = qkv(5)
    bias = padding(2, 64, masked_block=2, n=4, lane=1)
    got, want = both(q, k, v, bias, 4, local_impl)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    ref = dense_attention(*(torch.from_numpy(x) for x in (q, k, v)),
                          torch.from_numpy(bias)[:, None, None, :])
    np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=1e-5)


@pytest.mark.parametrize("local_impl", ["flash", "dense"])
def test_fully_masked_rank_block_under_inf_bias(local_impl):
    """A rank whose keys all carry a -inf bias contributes nothing to the
    other ranks' queries (the reference's
    test_ring_flash_fully_masked_block_stays_finite); the whole output
    equals the JAX ring's, NaN where the reference's is NaN (dense local,
    the masked rank's own queries)."""
    q, k, v = qkv(6)
    bias = np.zeros((2, 64), np.float32)
    bias[:, 48:] = -np.inf
    got, want = both(q, k, v, bias, 4, local_impl)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)  # NaNs equal
    assert np.isfinite(got.numpy()[:, :48]).all()
    ref = jax_dense(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias)[:, None, None, :])
    np.testing.assert_allclose(got.numpy()[:, :48], np.asarray(ref)[:, :48], atol=2e-5)


@pytest.mark.parametrize("local_impl", ["flash", "dense"])
def test_bf16_inputs_match_jax_ring(local_impl):
    q, k, v = qkv(7)
    got, want = both(q, k, v, padding(2, 64), 2, local_impl, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, atol=1.6e-2)


def test_dense_attention_matches_jax():
    q, k, v = qkv(8)
    bias = padding(2, 64)[:, None, None, :]
    got = dense_attention(*(torch.from_numpy(x) for x in (q, k, v)), torch.from_numpy(bias))
    want = jax_dense(*(jnp.asarray(x) for x in (q, k, v)), jnp.asarray(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


# -- auto_local_impl: the reference's decision table ---------------------------

@pytest.mark.parametrize("shape, impl", [
    ((32, 12, 128, 64), "dense"),      # BERT serving shapes
    ((4, 12, 2048, 64), "dense"),
    ((1, 12, 2048, 64), "dense"),      # the long-context (1, 2048) bucket
    ((8, 12, 2048, 64), "flash"),      # the (8, 2048) bucket: 3.22 GB > 2 GiB
    ((1, 12, 32768, 64), "flash"),     # only the O(S) kernel can run it
    ((64, 32, 32768, 40), "dense"),    # head_dim not a multiple of 64
    ((64, 32, 32771, 64), "dense"),    # rows not a multiple of 8
])
def test_auto_local_impl_decision_table(shape, impl):
    assert ra.DENSE_SCORE_BYTES_MAX == jra.DENSE_SCORE_BYTES_MAX == 2 << 30
    assert ra.auto_local_impl(*shape) == jra.auto_local_impl(*shape) == impl


def test_auto_local_impl_flips_at_the_threshold():
    s = 16384
    b_over = ra.DENSE_SCORE_BYTES_MAX // (2 * 4 * 1 * s * s) + 1
    for mod in (ra, jra):
        assert mod.auto_local_impl(b_over, 1, s, 64) == "flash"
        assert mod.auto_local_impl(max(b_over - 1, 1), 1, s, 64) == "dense"


@pytest.mark.parametrize("threshold, impl", [(2 << 30, "dense"), (0, "flash")])
def test_auto_picks_what_the_threshold_says(monkeypatch, threshold, impl):
    """local_impl="auto" decides on the per-rank shape; with the threshold
    at 0 the ring runs K2's plain version, as explicit "flash" does."""
    monkeypatch.setattr(ra, "DENSE_SCORE_BYTES_MAX", threshold)
    calls = []
    stats = fa.flash_attention_stats_reference
    monkeypatch.setattr(fa, "flash_attention_stats_reference",
                        lambda *a: calls.append(1) or stats(*a))
    q, k, v = (torch.from_numpy(x) for x in qkv(9))
    mesh, _ = meshes(2)
    out = ring_attention(q, k, v, mesh)
    assert bool(calls) == (impl == "flash")
    torch.testing.assert_close(out, ring_attention(q, k, v, mesh, local_impl=impl),
                               atol=0, rtol=0)


# -- arguments and the mesh ------------------------------------------------------

def test_spec_must_put_seq_on_dim_1():
    q = torch.zeros(2, 8, 2, 64)
    mesh, _ = meshes(2)
    with pytest.raises(ValueError, match="seq dim"):
        ring_attention(q, q, q, mesh, spec=("seq", None, None, None))
    with pytest.raises(ValueError, match="unknown local_impl"):
        ring_attention(q, q, q, mesh, local_impl="sparse")
    out = ring_attention(q, q, q, mesh, spec=("data", "seq", "model", None))
    assert out.shape == q.shape


def test_mesh_axes_and_shared_devices():
    mesh = make_mesh(MeshPlan(sp=4), devices=["cpu"] * 4)
    assert isinstance(mesh, Mesh)
    assert mesh.shape == {"data": 1, "model": 1, "seq": 4}
    assert mesh.axis_devices("seq") == [torch.device("cpu")] * 4
    assert mesh.axis_devices("data") == [torch.device("cpu")]
    assert make_mesh(devices=["cpu"]).shape == {"data": 1, "model": 1, "seq": 1}


@pytest.mark.parametrize("plan, n", [(MeshPlan(), 2), (MeshPlan(sp=2), 4),
                                     (MeshPlan(tp=2), 2)])
def test_mesh_data_or_model_axis_not_ported(plan, n):
    with pytest.raises(NotImplementedError, match="mesh modes"):
        make_mesh(plan, devices=["cpu"] * n)


def test_mesh_plan_resolves_as_reference():
    for args, n in (((), 1), ((1, 1, 4), 4), ((-1, 2, 2), 8)):
        assert MeshPlan(*args).resolve(n) == JaxMeshPlan(*args).resolve(n)
    with pytest.raises(ValueError, match="not divisible"):
        MeshPlan(sp=3).resolve(4)


def test_mesh_without_devices_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_mesh(MeshPlan())
