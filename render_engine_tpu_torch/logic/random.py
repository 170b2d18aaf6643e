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

Each function takes either form of key. A numpy key (and an int seed)
runs on the host in ``uint32``; a tensor key (and a tensor seed) runs on
the key's device in int64 tensors masked to 32 bits, with no host read and
no upload, so the step's draws can live inside a captured frame program.
The two forms give the same bits. The host form stays for the history log
and the tests.
"""

from __future__ import annotations

import numpy as np
import torch

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


_M32 = 0xFFFFFFFF


def _threefry2x32_t(k0, k1, x0, x1):
    """``threefry2x32`` over int64 tensors holding 32-bit words: every sum
    and shift is masked back to 32 bits."""
    ks = (k0, k1, k0 ^ k1 ^ int(_PARITY))
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) & _M32) | (x1 >> (32 - r))) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed):
    """``jax.random.key(seed)`` as its two 32-bit words: a uint32 array for
    an int seed, an int64 (2,) tensor on the seed's device for a tensor."""
    if isinstance(seed, torch.Tensor):
        return torch.stack([torch.zeros_like(seed, dtype=torch.int64),
                            seed.to(torch.int64) & _M32])
    return np.array([0, int(seed) & 0xFFFFFFFF], np.uint32)


def _hash(k, n: int):
    """The two output words of the counters ``(0, i)``, ``i < n``."""
    if isinstance(k, torch.Tensor):
        x1 = torch.arange(n, dtype=torch.int64, device=k.device)
        return _threefry2x32_t(k[0], k[1], torch.zeros_like(x1), x1)
    return threefry2x32(k[0], k[1], np.zeros(n, np.uint32),
                        np.arange(n, dtype=np.uint32))


def split(k, num: int = 2):
    """``jax.random.split``: (num, 2) keys of ``k``'s form."""
    b0, b1 = _hash(k, num)
    if isinstance(k, torch.Tensor):
        return torch.stack([b0, b1], dim=1)
    return np.stack([b0, b1], axis=1)


def random_bits(k, shape):
    """32 random bits per element of ``shape`` (uint32 on the host, int64
    holding 32 bits on a device)."""
    shape = tuple(shape)
    b0, b1 = _hash(k, int(np.prod(shape)))
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


def _fma_f32_t(a, b, c):
    """``_fma_f32`` over float32 tensors (``b`` and ``c`` host floats)."""
    p = a.to(torch.float64) * float(b)
    c64 = float(c)
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    r = s.to(torch.float32)
    rd = r.to(torch.float64)
    other = torch.nextafter(r, torch.where(s > rd, float("inf"),
                                           float("-inf")).to(torch.float32))
    od = other.to(torch.float64)
    halfway = (s - rd) == (od - s)
    toward = halfway & (err != 0) & ((err > 0) == (od > rd))
    return torch.where(toward, other, r)


def bits_to_uniform(bits, minval=0.0, maxval=1.0):
    """``uniform``'s float32 draws from ``random_bits``' output, so that
    draws over several ranges from one key hash its bits once."""
    lo, hi = np.float32(minval), np.float32(maxval)
    if isinstance(bits, torch.Tensor):
        floats = ((bits >> 9) | 0x3F800000).to(torch.int32).view(
            torch.float32) - 1.0
        return torch.clamp(_fma_f32_t(floats, hi - lo, lo), min=float(lo))
    floats = ((bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(
        np.float32) - np.float32(1.0)
    return np.maximum(lo, _fma_f32(floats, hi - lo, lo)).reshape(bits.shape)


def uniform(k, shape=(), minval=0.0, maxval=1.0):
    """``jax.random.uniform(key, shape, minval=, maxval=)`` in float32: a
    numpy array for a numpy key, a tensor on the key's device for a tensor
    key."""
    return bits_to_uniform(random_bits(k, shape), minval, maxval)
