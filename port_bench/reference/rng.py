"""The counter-based random numbers the engine's step draws from: the
Threefry-2x32 block cipher (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011; 20 rounds), keyed and split and turned into
uniform floats the way JAX's ``jax.random`` does with its partitionable
Threefry (``key``, ``split``, ``uniform``). Plain integer arithmetic on
int64 tensors holding 32-bit words."""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """The cipher of the counter words ``(x0, x1)`` (int64 tensors of
    32-bit values) under the key ``(k0, k1)``."""
    ks = (k0 & _M32, k1 & _M32, (k0 ^ k1 ^ 0x1BD11BDA) & _M32)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _M32
    return x0, x1


def key(seed: int) -> tuple[int, int]:
    """The key of a 32-bit seed."""
    return (0, int(seed) & _M32)


def _blocks(k, n: int):
    cnt = torch.arange(n, dtype=torch.int64)
    return threefry2x32(k[0], k[1], torch.zeros_like(cnt), cnt)


def split(k, n: int = 2) -> list[tuple[int, int]]:
    a, b = _blocks(k, n)
    return [(int(a[i]), int(b[i])) for i in range(n)]


def uniform(k, n: int, lo: float, hi: float) -> torch.Tensor:
    """``n`` float32 draws in ``[lo, hi)``: 23 random mantissa bits under
    the exponent of 1.0, less 1, scaled and shifted, at least ``lo``."""
    a, b = _blocks(k, n)
    bits = ((a ^ b) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32) - 1.0
    lo_t = torch.tensor(lo, dtype=torch.float32)
    hi_t = torch.tensor(hi, dtype=torch.float32)
    return torch.maximum(lo_t, f * (hi_t - lo_t) + lo_t)
