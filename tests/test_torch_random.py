"""The port's threefry (render_engine_tpu_torch/logic/random.py) against
``jax.random`` (CPU, jax's default threefry2x32 in partitionable mode).

Tolerances: keys, splits and uniform draws are compared bit for bit (as
uint32 views). The step-only parity run goes past the demo's first mine
spawn (4 s, frame 240 at 60 Hz): alive, type_id and model_id exactly, every
entity's position and velocity (the spawned mine's included) within
rtol 1e-5 / atol 1e-4, the tolerance of the slice's parity tests
(transcendentals round differently in XLA and in PyTorch).
"""

import dataclasses

import jax
import numpy as np
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.logic.types import KEY_W
from render_engine_tpu.math.camera import CameraBuilder as JCameraBuilder
from render_engine_tpu.runtime.engine import Engine as JEngine

from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.logic import random as RND
from render_engine_tpu_torch.logic.types import InputState as TInput

SEEDS = [0, 1, 42, 2 ** 31, 2 ** 32 - 1]
# (minval, maxval, shape): the demo's two draws, the default interval, and
# ranges that are not powers of two (there the scaling must round once, as
# XLA's fused multiply-add does)
DRAWS = [(-8.0, 8.0, (3,)), (-2.0, 2.0, (3,)), (0.0, 1.0, (5, 2)),
         (-3.7, 5.1, (7,)), (0.1, 0.3, (64,))]


def _bits(a):
    return np.asarray(a, np.float32).view(np.uint32)


def _check_seed(seed):
    kj = jax.random.key(seed)
    kt = RND.key(seed)
    np.testing.assert_array_equal(kt, np.asarray(jax.random.key_data(kj)))
    for num in (2, 3):
        np.testing.assert_array_equal(
            RND.split(kt, num),
            np.asarray(jax.random.key_data(jax.random.split(kj, num))))
    rj, sj = jax.random.split(kj)
    rt, st_ = RND.split(kt)
    for lo, hi, shape in DRAWS:
        want = jax.random.uniform(sj, shape, minval=lo, maxval=hi)
        got = RND.uniform(st_, shape, minval=lo, maxval=hi)
        assert got.shape == shape and got.dtype == np.float32
        np.testing.assert_array_equal(_bits(got), _bits(want))
    # a second split off the carried key, as the step does per callback
    np.testing.assert_array_equal(
        RND.split(rt), np.asarray(jax.random.key_data(jax.random.split(rj))))


@pytest.mark.parametrize("seed", SEEDS)
def test_key_split_uniform_bit_exact(seed):
    _check_seed(seed)


@settings(max_examples=40, deadline=None)
@given(st.integers(min_value=0, max_value=2 ** 32 - 1))
def test_key_split_uniform_bit_exact_any_seed(seed):
    _check_seed(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_demo_draws_shapes_and_bounds(seed):
    """The mine producer's two draws from one key: shapes, bounds, and the
    shared bits (offset / 8 == velocity / 2)."""
    _, sub = RND.split(RND.key(seed))
    offset = RND.uniform(sub, (3,), minval=-8.0, maxval=8.0)
    vel = RND.uniform(sub, (3,), minval=-2.0, maxval=2.0)
    assert offset.shape == vel.shape == (3,)
    assert (offset >= -8.0).all() and (offset < 8.0).all()
    assert (vel >= -2.0).all() and (vel < 2.0).all()
    np.testing.assert_array_equal(offset / 8.0, vel / 2.0)
    _, sj = jax.random.split(jax.random.key(seed))
    np.testing.assert_array_equal(
        _bits(offset), _bits(jax.random.uniform(sj, (3,), minval=-8.0,
                                                maxval=8.0)))


KW = dict(width=128, height=32, capacity=128, num_asteroids=10,
          max_tris=2048)
FRAMES = 250  # the first mine spawns on frame 240 (4 s at 60 Hz)
DT = 1.0 / 60.0


def _inputs(cls, i):
    base = cls.idle(i)
    if i % 50 == 1:
        return base.with_keys(KEY_W)
    if i % 50 == 2:
        return dataclasses.replace(
            base, mouse_delta=np.array([0.01, -0.005], np.float32))
    return base


@pytest.fixture(scope="module")
def stepped():
    """The JAX and port engines stepped (no render) past the first mine
    spawn; the frame index of the first new entity and both final worlds."""
    cfg = JS.space_config(**KW)
    cfg.record_history = False
    cam = (JCameraBuilder().with_position(1000.0, 1000.0, 1150.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(KW["width"] / KW["height"])
           .with_near_far(0.5, 1500.0).with_draw_distance(1500.0).build())
    jeng = JEngine(cfg, camera=cam)
    teng = TS.build_space_engine(device="cpu", **KW)
    alive0 = int(np.asarray(jeng.world.alive).sum())
    spawned_at = None
    for i in range(FRAMES):
        jeng.frame(_inputs(JInput, i), DT, render=False)
        teng.frame(_inputs(TInput, i), DT, render=False)
        ja = np.asarray(jeng.world.alive)
        np.testing.assert_array_equal(teng.world.alive.numpy(), ja,
                                      err_msg=f"frame {i}")
        if spawned_at is None and ja.sum() > alive0:
            spawned_at = i
    return dict(spawned_at=spawned_at, alive0=alive0,
                jw={k: np.asarray(v) for k, v in jeng.world.comps.items()},
                tw={k: v.numpy() for k, v in teng.world.comps.items()},
                jalive=np.asarray(jeng.world.alive),
                talive=teng.world.alive.numpy())


def test_step_parity_past_first_mine_spawn(stepped):
    assert stepped["spawned_at"] is not None
    assert 230 <= stepped["spawned_at"] < FRAMES
    jw, tw = stepped["jw"], stepped["tw"]
    np.testing.assert_array_equal(stepped["talive"], stepped["jalive"])
    for name in ("type_id", "model_id"):
        np.testing.assert_array_equal(tw[name], jw[name], err_msg=name)
    for name in ("position", "velocity"):
        np.testing.assert_allclose(tw[name], jw[name], rtol=1e-5, atol=1e-4,
                                   err_msg=name)


def test_spawned_mine_matches(stepped):
    jw, tw = stepped["jw"], stepped["tw"]
    mines = np.flatnonzero(stepped["jalive"]
                           & (jw["type_id"] == JS.TYPE_MINE))
    assert mines.size == 1
    np.testing.assert_array_equal(
        np.flatnonzero(stepped["talive"] & (tw["type_id"] == TS.TYPE_MINE)),
        mines)
    m = mines[0]
    for name in ("position", "velocity"):
        np.testing.assert_allclose(tw[name][m], jw[name][m], rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    # the mine drifts with a draw in [-2, 2) per axis
    assert (np.abs(jw["velocity"][m]) <= 2.0).all()
    assert np.abs(jw["velocity"][m]).max() > 0.0
