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
  become a float32 mantissa in [1, 2), minus 1, then ``-log(-log(u))``;
- ``uniform_signed(bits)`` and ``normal(bits)`` — ``jax.random.normal``
  (float32): the same mantissa draw scaled onto [nextafter(-1, 0), 1), then
  ``sqrt(2) * erf_inv(u)`` with ``erf_inv`` as XLA writes it for float32
  (Giles' two polynomial branches).

The bits and the uniform draws are exact. ``gumbel``'s logs are the
framework's, which may differ from XLA's in the last ulps; so does the
``log1p`` inside ``erf_inv``, which puts ``normal`` within 3 ulps of
``jax.random.normal`` (``tests/test_torch_threefry.py``).
"""

from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
# np.finfo(np.float32).tiny, the smallest normal float32.
_TINY = 1.1754943508222875e-38
# np.nextafter(np.float32(-1), np.float32(0)): jax.random.normal's minval.
_NORMAL_LO = -0.99999994039535522
# np.float32(np.sqrt(2)).
_SQRT2 = 1.4142135381698608
# XLA's float32 ErfInv (xla/hlo/builder/lib/math.cc): Giles' polynomial
# coefficients, highest degree first, for w < 5 and for w >= 5.
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
               0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
               0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)


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


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` on a float32 tensor: ``w = -log1p(-x*x)``,
    then Giles' polynomial in ``w - 2.5`` (w < 5) or ``sqrt(w) - 3``, times
    x; +-1 map to +-inf. Each Horner step ``c + p * w`` is rounded once,
    as XLA's fused multiply-add rounds it (the product of two float32
    values is exact in float64)."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0).double()
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0]).double()
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        # Python constants: no host-to-device copy, so a graph can capture it.
        p = (torch.where(lt, lo, hi).double() + p * w).float().double()
    out = p.float() * x
    return torch.where(x.abs() == 1.0, x * float("inf"), out)


def uniform_signed(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(..., minval=nextafter(-1, 0), maxval=1.0)``
    (float32) from 32-bit values: the mantissa in [1, 2) minus 1, times
    ``maxval - minval`` (2.0 in float32), plus minval, floored at minval."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * 2.0 + _NORMAL_LO, _NORMAL_LO)


def normal(bits: torch.Tensor) -> torch.Tensor:
    """``jax.random.normal`` (float32) from 32-bit values:
    ``sqrt(2) * erf_inv(uniform_signed(bits))``."""
    return erf_inv(uniform_signed(bits)) * _SQRT2
