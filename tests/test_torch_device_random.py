"""The port's threefry on tensors (render_engine_tpu_torch/logic/random.py,
a key held as an int64 tensor) against ``jax.random`` and against the
module's host functions, on the CPU.

The step draws from a tensor key inside its program, so nothing is read
back from the device and a captured frame does not freeze frame 0's draws.
Tolerance: none. Keys, splits and bits are compared as uint32 values and
uniform draws as the bits of their float32 values.
"""

import jax
import numpy as np
import pytest
import torch

from render_engine_tpu_torch.logic import random as RND

SEEDS = [0, 1, 2 ** 31, 2 ** 32 - 1]
SHAPES = [(), (3,), (7, 5)]
# the demo's two draws and a range that is not a power of two (there the
# scaling must round once, as XLA's fused multiply-add does)
RANGES = [(-8.0, 8.0), (-2.0, 2.0), (-3.7, 5.1)]


def _jkey(seed):
    return jax.random.key(seed)


def _tkey(seed):
    return RND.key(torch.tensor(seed, dtype=torch.int64))


def _u32(t):
    return t.numpy().astype(np.uint32)


def _f32_bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_device_key_and_split(seed):
    kt = _tkey(seed)
    assert kt.dtype == torch.int64 and tuple(kt.shape) == (2,)
    want = np.asarray(jax.random.key_data(_jkey(seed)))
    np.testing.assert_array_equal(_u32(kt), want)
    np.testing.assert_array_equal(_u32(kt), RND.key(seed))
    for num in (2, 3):
        got = RND.split(kt, num)
        np.testing.assert_array_equal(
            _u32(got),
            np.asarray(jax.random.key_data(jax.random.split(_jkey(seed),
                                                             num))))
        np.testing.assert_array_equal(_u32(got), RND.split(RND.key(seed),
                                                           num))
    # the step's chain: a second split off the carried key
    rt, _ = RND.split(kt)
    rj, _ = jax.random.split(_jkey(seed))
    np.testing.assert_array_equal(
        _u32(RND.split(rt)),
        np.asarray(jax.random.key_data(jax.random.split(rj))))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_device_random_bits(seed, shape):
    _, sub_t = RND.split(_tkey(seed))
    _, sub_j = jax.random.split(_jkey(seed))
    got = RND.random_bits(sub_t, shape)
    assert tuple(got.shape) == shape
    assert bool((got >= 0).all()) and bool((got < 2 ** 32).all())
    np.testing.assert_array_equal(
        _u32(got), np.asarray(jax.random.bits(sub_j, shape, np.uint32)))
    np.testing.assert_array_equal(
        _u32(got), RND.random_bits(RND.split(RND.key(seed))[1], shape))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_device_uniform(seed, shape):
    _, sub_t = RND.split(_tkey(seed))
    _, sub_j = jax.random.split(_jkey(seed))
    sub_h = RND.split(RND.key(seed))[1]
    for lo, hi in RANGES:
        got = RND.uniform(sub_t, shape, minval=lo, maxval=hi)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        want = jax.random.uniform(sub_j, shape, minval=lo, maxval=hi)
        np.testing.assert_array_equal(_f32_bits(got.numpy()),
                                      _f32_bits(want))
        np.testing.assert_array_equal(
            _f32_bits(got.numpy()),
            _f32_bits(RND.uniform(sub_h, shape, minval=lo, maxval=hi)))
        assert bool((got >= lo).all()) and bool((got < hi).all())


@pytest.mark.parametrize("seed", SEEDS)
def test_bits_to_uniform_shares_one_hash(seed):
    """The demo's mine spawner hashes one key's bits once and scales them
    over two ranges: each draw equals ``uniform`` over its range and
    ``jax.random.uniform`` from the same key, on both forms."""
    for key in (_tkey(seed), RND.key(seed)):
        bits = RND.random_bits(key, (3,))
        for lo, hi in RANGES:
            got = RND.bits_to_uniform(bits, minval=lo, maxval=hi)
            want = jax.random.uniform(_jkey(seed), (3,), minval=lo,
                                      maxval=hi)
            got = got.numpy() if isinstance(got, torch.Tensor) else got
            np.testing.assert_array_equal(_f32_bits(got), _f32_bits(want))
            np.testing.assert_array_equal(
                _f32_bits(got),
                _f32_bits(np.asarray(RND.uniform(key, (3,), minval=lo,
                                                 maxval=hi))))


def _fma_exact_f32(a, b, c):
    """a * b + c rounded once to float32 (ties to even), from the exact
    rational value."""
    from fractions import Fraction

    x = Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c))
    f = np.float32(float(x))
    cands = [f, np.nextafter(f, np.float32(np.inf)),
             np.nextafter(f, np.float32(-np.inf))]
    return min(cands, key=lambda v: (abs(Fraction(float(v)) - x),
                                     int(np.float32(v).view(np.uint32)) & 1))


A, B = 1 + 2.0 ** -18, 2.0 ** -24 * (1 - 2.0 ** -18)


@pytest.mark.parametrize("a, b, c", [
    # the float64 sum lands exactly halfway between two floats while the
    # exact sum lies below: rounding the float64 sum rounds up, wrongly
    (A, B, 1 + 2.0 ** -23), (-A, B, -(1 + 2.0 ** -23)),
    # no tie: one rounding of the float64 sum is already right
    (A, B, 1.0)], ids=["tie_up", "tie_down", "no_tie"])
def test_device_fma_rounds_once(a, b, c):
    """``uniform``'s scaling, ``u * (maxval - minval) + minval``, rounds
    like one fused multiply-add on both forms, in the one case where the
    product and sum in float64 round twice."""
    want = _fma_exact_f32(a, b, c)
    got = RND._fma_f32_t(torch.tensor([a], dtype=torch.float32), b, c)
    host = RND._fma_f32(np.float32(a), np.float32(b), np.float32(c))
    assert _f32_bits(got.numpy())[0] == _f32_bits(want)
    assert _f32_bits(host) == _f32_bits(want)
