"""``tpuserve_torch.ops.threefry`` against ``jax.random`` with
``jax_threefry_partitionable`` on (as ``tpuserve.runtime`` sets it at
import), on the CPU.

The port's text generation samples with Gumbel noise from
``fold_in(fold_in(key(0), seed), position)``; the same tokens at a
temperature above 0 need the same noise. Tolerances:

- key data after each fold-in and the uint32 bits of a vocabulary-wide draw
  (``jax.random.bits``): equal bit for bit, over seeds including negative
  and extreme int32 values and every position 0-511;
- ``gumbel``: within rtol 1e-6, atol 1e-6 of ``jax.random.gumbel`` (the
  bits are exact; the two frameworks' ``log`` may differ in the last ulps);
- ``normal`` (SD 1.5's latents, ``jax.random.normal(fold_in(key(0), seed),
  (64, 64, 4))``): within 3 ulps, every value finite, and the uniform draw
  it starts from bit for bit (``erf_inv``'s ``log1p`` is the framework's);
  ``erf_inv`` alone within 2 ulps of ``lax.erf_inv`` over (-1, 1) and
  infinite at +-1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpuserve.runtime  # noqa: F401 — sets jax_threefry_partitionable, as serving does
from tpuserve_torch.ops import threefry

SEEDS = (0, 1, 7, -1, -3, 123456, 2**31 - 1, -(2**31))
POSITIONS = np.arange(512, dtype=np.int32)


def jax_keys(seed: int) -> tuple[np.ndarray, jax.Array]:
    """The reference's per-position keys for one seed: (512, 2) key data."""
    base = jax.random.fold_in(jax.random.key(0), jnp.int32(seed))
    keys = jax.vmap(lambda p: jax.random.fold_in(base, p))(jnp.asarray(POSITIONS))
    return np.asarray(jax.random.key_data(keys)), keys


def port_keys(seed: int) -> tuple[torch.Tensor, torch.Tensor]:
    seeds = torch.full((len(POSITIONS),), seed, dtype=torch.int32)
    k0, k1 = threefry.key(torch.zeros_like(seeds))
    k0, k1 = threefry.fold_in(k0, k1, seeds)
    return threefry.fold_in(k0, k1, torch.from_numpy(POSITIONS))


def test_partitionable_threefry_is_on():
    assert jax.config.jax_threefry_partitionable


@pytest.mark.parametrize("seed", SEEDS)
def test_key_data_bit_exact_over_positions(seed):
    want, _ = jax_keys(seed)
    k0, k1 = port_keys(seed)
    got = torch.stack([k0, k1], dim=1).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


def test_key_of_seed_matches_jax_random_key():
    for seed in SEEDS:
        want = np.asarray(jax.random.key_data(jax.random.key(np.int32(seed))))
        k0, k1 = threefry.key(torch.tensor(seed, dtype=torch.int32))
        assert [int(k0), int(k1)] == [int(x) for x in want], seed


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_bit_exact(seed):
    """A 1,000-wide draw at every 37th position (14 keys), bit for bit."""
    _, keys = jax_keys(seed)
    sel = np.arange(0, 512, 37)
    want = np.asarray(jax.vmap(lambda k: jax.random.bits(k, (1000,), jnp.uint32))(keys[sel]))
    k0, k1 = port_keys(seed)
    got = threefry.bits32(k0[sel], k1[sel], 1000).numpy().astype(np.uint32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", (7, -3, 2**31 - 1))
def test_gumbel_within_tolerance(seed):
    _, keys = jax_keys(seed)
    sel = np.array([0, 33, 255, 511])
    want = np.asarray(jax.vmap(
        lambda k: jax.random.gumbel(k, (4096,), jnp.float32))(keys[sel]))
    k0, k1 = port_keys(seed)
    got = threefry.gumbel(threefry.bits32(k0[sel], k1[sel], 4096)).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_uniform_edges():
    """All-zero mantissa bits give tiny (never 0, so log stays finite); all
    ones give the largest float32 below 1."""
    bits = torch.tensor([0, 0x1FF, 0xFFFFFFFF], dtype=torch.int64)
    u = threefry.uniform(bits).numpy()
    tiny = np.finfo(np.float32).tiny
    assert u[0] == tiny and u[1] == tiny
    assert u[2] == np.float32(1.0) - np.float32(2.0 ** -23)


@pytest.mark.parametrize("seed", (0, 1, 2**31 - 1, -1, -(2**31)))
def test_normal_within_ulps(seed):
    key = jax.random.fold_in(jax.random.key(0), jnp.int32(seed))
    want = np.asarray(jax.random.normal(key, (64, 64, 4), jnp.float32))
    want_u = np.asarray(jax.random.uniform(
        key, (64 * 64 * 4,), jnp.float32, np.nextafter(np.float32(-1), np.float32(0)), 1.0))
    s = torch.tensor([seed], dtype=torch.int32)
    k0, k1 = threefry.fold_in(*threefry.key(torch.zeros_like(s)), s)
    bits = threefry.bits32(k0, k1, 64 * 64 * 4)[0]
    u = threefry.uniform_signed(bits).numpy()
    np.testing.assert_array_equal(u, want_u)
    got = threefry.normal(bits).reshape(64, 64, 4).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 3, ulps.max()


def test_erf_inv_within_ulps():
    from jax import lax

    x = np.random.default_rng(0).uniform(-1, 1, 200_000).astype(np.float32)
    x = np.concatenate([x, np.float32(1) - np.float32(2.0 ** -24) * np.arange(1, 64,
                                                                               dtype=np.float32)])
    want = np.asarray(lax.erf_inv(jnp.asarray(x)))
    got = threefry.erf_inv(torch.from_numpy(x)).numpy()
    ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
    assert ulps.max() <= 2, ulps.max()
    edge = threefry.erf_inv(torch.tensor([1.0, -1.0])).numpy()
    assert np.isposinf(edge[0]) and np.isneginf(edge[1])
