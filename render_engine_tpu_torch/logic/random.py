"""Threefry-2x32 random draws on the host, bit for bit those of ``jax.random``.

The JAX step derives its randomness from ``jax.random.key(seed)``, splits
one subkey per random callback and draws with ``jax.random.uniform``. This
module computes the same numbers in numpy ``uint32`` arithmetic, following
jax's defaults (``jax_default_prng_impl=threefry2x32``,
``jax_threefry_partitionable=True``, 32-bit mode):

* ``key(seed)`` is the pair ``(0, seed mod 2**32)``;
* ``split(key, num)`` hashes the counters ``(0, i)`` for ``i < num``;
* ``random_bits(key, shape)`` hashes ``(0, i)`` for every flat index ``i``
  and xors the two output words;
* ``uniform`` turns the bits into floats in [1, 2) (``>> 9 | 0x3F800000``),
  subtracts 1, scales with one fused multiply-add as XLA's CPU code does,
  and clamps below at ``minval``.

Seeds are host integers and no draw depends on device state, so the step
computes its draws here and moves only the finished floats to the device.
"""

from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v, r):
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash (20 rounds) of the counter words ``x0``,
    ``x1`` (uint32 arrays of one shape) under the key ``(k0, k1)``."""
    ks = (np.uint32(k0), np.uint32(k1), np.uint32(k0) ^ np.uint32(k1)
          ^ _PARITY)
    x0 = np.asarray(x0, np.uint32) + ks[0]
    x1 = np.asarray(x1, np.uint32) + ks[1]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = x0 + x1
            x1 = _rotl(x1, r) ^ x0
        x0 = x0 + ks[(i + 1) % 3]
        x1 = x1 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x0, x1


def key(seed: int) -> np.ndarray:
    """``jax.random.key(seed)`` as its two uint32 words."""
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _counters(n: int):
    return np.zeros(n, np.uint32), np.arange(n, dtype=np.uint32)


def split(k: np.ndarray, num: int = 2) -> np.ndarray:
    """``jax.random.split``: (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(k[0], k[1], *_counters(num))
    return np.stack([b0, b1], axis=1)


def random_bits(k: np.ndarray, shape) -> np.ndarray:
    """32 random bits per element of ``shape``."""
    shape = tuple(shape)
    b0, b1 = threefry2x32(k[0], k[1], *_counters(int(np.prod(shape))))
    return (b0 ^ b1).reshape(shape)


def _fma_f32(a, b, c):
    """float32 ``a * b + c`` with one rounding. The product of two floats
    is exact in float64; the sum is rounded to float64 and then to float32,
    and the one case where that double rounding differs from a single
    rounding (the float64 sum lies exactly halfway between two floats) is
    corrected with the sum's exact error term."""
    a, b, c = (np.asarray(v, np.float32) for v in (a, b, c))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)  # TwoSum: s + err == p + c exactly
    r = s.astype(np.float32)
    rd = r.astype(np.float64)
    other = np.nextafter(r, np.where(s > rd, np.float32(np.inf),
                                     np.float32(-np.inf)).astype(np.float32))
    od = other.astype(np.float64)
    halfway = (s - rd) == (od - s)
    toward = halfway & (err != 0) & ((err > 0) == (od > rd))
    return np.where(toward, other, r).astype(np.float32)


def uniform(k: np.ndarray, shape=(), minval=0.0, maxval=1.0) -> np.ndarray:
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32."""
    lo, hi = np.float32(minval), np.float32(maxval)
    bits = random_bits(k, shape)
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma_f32(floats, hi - lo, lo)).reshape(shape)
