"""Threefry-2x32 counter-based random bits, as ``jax.random`` draws them with
``jax_threefry_partitionable`` on (the reference sets it at import,
``tpuserve/runtime.py``), so a seeded draw in the port gives the reference's
bits.

The reference's text generation samples with Gumbel noise from
``fold_in(fold_in(key(0), seed), position)`` over the vocabulary; the same
tokens at a temperature above 0 need the same noise, bit for bit. The
functions here take and return int64 tensors holding unsigned 32-bit values
(every sum masked to 32 bits), on any device, so one code path serves the CPU
and the card, inside a captured CUDA graph too:

- ``threefry2x32`` — the 20-round block function of a key pair and a counter
  pair (Salmon et al. 2011, as ``jax._src.prng`` writes it);
- ``key(seed)`` — ``jax.random.key(seed)`` for an int32 seed: the pair
  (seed >> 32, seed & 0xFFFFFFFF), whose high word is 0;
- ``fold_in(k0, k1, data)`` — the pair ``threefry2x32(key, (0, data))``;
- ``bits32(k0, k1, n)`` — ``jax.random.bits(key, (n,), uint32)``: counter i
  is the flat index split into its high and low words, and the output is
  the XOR of the two result words;
- ``uniform(bits)`` and ``gumbel(bits)`` — ``jax.random.uniform`` on
  [tiny, 1) and ``jax.random.gumbel`` from those bits: the top 23 bits
  become a float32 mantissa in [1, 2), minus 1, then ``-log(-log(u))``.

The bits are exact. ``gumbel``'s logs are the framework's, which may differ
from XLA's in the last ulps.
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# np.finfo(np.float32).tiny, the smallest normal float32.
_TINY = 1.1754943508222875e-38


def _rotl(v: torch.Tensor, r: int) -> torch.Tensor:
    return ((v << r) | (v >> (32 - r))) & MASK


def threefry2x32(k0: torch.Tensor, k1: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Threefry-2x32 (20 rounds) of counters (x0, x1) under key (k0, k1);
    int64 tensors of 32-bit values, broadcast together."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def key(seed: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key(seed)``'s data for int32 seeds (negative ones as
    their two's complement)."""
    seed = seed.to(torch.int64)
    return torch.zeros_like(seed), seed & MASK


def fold_in(k0: torch.Tensor, k1: torch.Tensor,
            data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in(key, data)`` for int32 ``data``."""
    data = data.to(torch.int64) & MASK
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def bits32(k0: torch.Tensor, k1: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` for each key of (k0, k1)
    (shape (...)), as (..., n) int64 values."""
    lo = torch.arange(n, dtype=torch.int64, device=k0.device)
    y0, y1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(lo), lo)
    return y0 ^ y1


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(..., minval=tiny, maxval=1.0)`` (float32) from
    32-bit values."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    # jax scales by (maxval - minval), which is 1.0 in float32, and adds tiny.
    return torch.clamp_min(f + _TINY, _TINY)


def gumbel(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.gumbel`` (float32, the default "low" mode) from 32-bit
    values."""
    return -torch.log(-torch.log(uniform(bits)))
