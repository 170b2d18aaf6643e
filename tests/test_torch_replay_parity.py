"""Record and replay across the two packages, on the CPU at the demo test
size (128x32, 10 asteroids): the port's world hash equals the JAX
package's on the same world, a log written by either package loads in the
other, and the port's Player replays a JAX-recorded log along the JAX
package's live states.

One JAX engine for the file, in a cache slot of its own (its camera's
draw distance changes mid-run), driven with ``render=False`` so that only
its step program compiles. Tolerances for the replayed states are those of
tests/test_torch_engine.py: integer columns exact, float columns rtol 1e-5
/ atol 1e-4 (transcendentals and 4x4 products round differently in XLA and
in PyTorch).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from render_engine_tpu.ecs import world as JW
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.logic.types import KEY_D, KEY_SPACE, KEY_W
from render_engine_tpu.runtime.history import HistoryLog as JHistoryLog
from render_engine_tpu.runtime.replay import _flight_accel as j_flight_accel
from render_engine_tpu.utils.hashing import world_hash as j_world_hash

from render_engine_tpu_torch import convert
from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.logic.types import InputState as TInput
from render_engine_tpu_torch.runtime.history import HistoryLog
from render_engine_tpu_torch.runtime.replay import Player, _flight_accel
from render_engine_tpu_torch.utils.hashing import world_hash

KW = dict(width=128, height=32, capacity=128, num_asteroids=10,
          max_tris=2048)
DT = 1.0 / 30.0
FRAMES = 6
DRAW_AT, DRAW_DISTANCE = 3, 900.0
BIG_SEED_AT = 2
FLOAT_COLS = ("position", "velocity", "orientation", "aabb_min", "aabb_max",
              "orbit_angle", "spawn_timer", "transform")
INT_COLS = ("type_id", "model_id", "flags", "sortable", "parent")


def _inputs(cls, i):
    inp = cls.idle(i).with_keys(KEY_W)
    seed = 2**32 - 1 if i == BIG_SEED_AT else i
    return dataclasses.replace(
        inp, rng_seed=np.uint32(seed) if cls is JInput else seed,
        mouse_delta=np.array([0.02 * (i % 3), -0.01 * (i % 2)], np.float32))


def _host_world(world):
    return dict(alive=np.asarray(world.alive),
                comp_mask=np.asarray(world.comp_mask),
                comps={k: np.asarray(v) for k, v in world.comps.items()})


@pytest.fixture(scope="module")
def jax_run(engine_factory, tmp_path_factory):
    """The JAX engine records FRAMES step frames (a draw-distance change
    before frame DRAW_AT, a 2^32-1 seed) and flushes; its baseline and the
    world after each frame, on the host."""
    d = str(tmp_path_factory.mktemp("jax_hist"))
    eng = engine_factory(slot="torch_replay_parity", **KW)
    eng.config.record_history = True
    eng.config.history_dir = d
    eng.reset()
    baseline = _host_world(eng.world)
    worlds = []
    for i in range(FRAMES):
        if i == DRAW_AT:
            eng.set_draw_distances(draw_distance=DRAW_DISTANCE)
        eng.frame(_inputs(JInput, i), DT, render=False)
        worlds.append(_host_world(eng.world))
    eng.flush_history()
    return dict(dir=d, engine=eng, baseline=baseline, worlds=worlds,
                log=eng.history)


@pytest.fixture(scope="module")
def port_engine():
    eng = TS.build_space_engine(device="cpu", **KW)
    eng.config.record_history = False
    return eng


def _port_world(config, host):
    return convert.world_from_numpy(config, host["alive"], host["comp_mask"],
                                    host["comps"])


@pytest.mark.parametrize("which", ["baseline", "after_3_steps"])
def test_world_hash_equals_jax(jax_run, port_engine, which):
    host = (jax_run["baseline"] if which == "baseline"
            else jax_run["worlds"][2])
    jworld = JW.restore(jax_run["engine"].world_config, host)
    tworld = _port_world(port_engine.world_config, host)
    assert world_hash(tworld) == j_world_hash(jworld)


def test_jax_log_loads_in_the_port(jax_run, port_engine):
    jlog = jax_run["log"]
    log = HistoryLog.load(jax_run["dir"])
    assert log.num_frames == FRAMES
    assert world_hash(log.restore_world(port_engine.world_config)) == \
        j_world_hash(JW.restore(jax_run["engine"].world_config,
                                jax_run["baseline"]))
    np.testing.assert_array_equal(log.baseline_camera, jlog.baseline_camera)
    np.testing.assert_array_equal(np.stack(log.frames_inputs),
                                  np.stack(jlog.frames_inputs))
    np.testing.assert_array_equal(np.asarray(log.frames_dt, np.float32),
                                  np.asarray(jlog.frames_dt, np.float32))
    assert log.frames_fused == [False] * FRAMES == jlog.frames_fused
    assert log.events == {DRAW_AT: {"draw_distance": DRAW_DISTANCE}}
    inp, _ = log.frame(BIG_SEED_AT)
    assert inp.rng_seed == 2**32 - 1


def test_port_replays_the_jax_log(jax_run, port_engine):
    eng = port_engine
    eng.reset()
    player = Player(eng, HistoryLog.load(jax_run["dir"]))
    for i, want in enumerate(jax_run["worlds"]):
        player.step(render=False)
        got = W.snapshot(eng.world)
        np.testing.assert_array_equal(got["alive"], want["alive"])
        np.testing.assert_array_equal(got["comp_mask"], want["comp_mask"])
        for name in INT_COLS:
            np.testing.assert_array_equal(got["comps"][name],
                                          want["comps"][name], err_msg=name)
        for name in FLOAT_COLS:
            np.testing.assert_allclose(got["comps"][name],
                                       want["comps"][name], rtol=1e-5,
                                       atol=1e-4, err_msg=f"{name}, {i}")
    assert eng.camera.draw_distance == DRAW_DISTANCE
    np.testing.assert_allclose(
        eng.camera.serialize().numpy(),
        np.asarray(jax_run["engine"].camera.serialize()), rtol=1e-5,
        atol=1e-5)


def test_port_log_loads_in_jax(jax_run, port_engine, tmp_path):
    eng = port_engine
    eng.config.record_history = True
    try:
        eng.reset()
        for i in range(3):
            eng.frame(_inputs(TInput, i), DT, render=False,
                      advance="fused" if i == 1 else None)
        eng.config.history_dir = str(tmp_path)
        eng.flush_history()
    finally:
        eng.config.record_history = False
    jlog = JHistoryLog.load(str(tmp_path))
    assert jlog.num_frames == 3
    assert [jlog.advance_fused(i) for i in range(3)] == [False, True, False]
    jworld = jlog.restore_world(jax_run["engine"].world_config)
    assert j_world_hash(jworld) == world_hash(
        eng.history.restore_world(eng.world_config))
    np.testing.assert_array_equal(
        np.stack(jlog.frames_inputs),
        np.stack([_inputs(TInput, i).serialize() for i in range(3)]))


def test_v1_log_without_fused_loads_as_steps(port_engine, tmp_path):
    """A v1 log (no ``fused`` array) written by hand: every frame reads as
    a step, and it replays."""
    log = HistoryLog()
    log.set_baseline(port_engine.world, port_engine.camera)
    for i in range(2):
        log.record_frame(_inputs(TInput, i), DT, fused=True)
    log.write_to_disk(str(tmp_path))
    path = os.path.join(str(tmp_path), "gameplay_history.npz")
    with np.load(path) as data:
        arrays = {k: data[k] for k in data.files if k != "fused"}
    arrays["version"] = np.int32(1)
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    loaded = HistoryLog.load(str(tmp_path))
    assert loaded.frames_fused == [False, False]
    assert [loaded.advance_fused(i) for i in range(3)] == [False] * 3
    port_engine.reset()
    assert len(Player(port_engine, loaded).replay_all()) == 2


def test_detached_flight_matches_jax(jax_run, port_engine):
    """Five frames of free flight (mouse look, W + D + Space) from the
    same camera in both packages."""
    jcam = jax_run["engine"].camera
    tcam = convert.camera_from_serialized(np.asarray(jcam.serialize()),
                                          port_engine.camera)
    assert tcam.movement_factor == jcam.movement_factor == 0.9
    for i in range(5):
        controls = dataclasses.replace(
            JInput.idle(i).with_keys(KEY_W, KEY_D, KEY_SPACE),
            mouse_delta=np.array([0.03, -0.02 * i], np.float32))
        jcam = jcam.rotated(controls.mouse_delta[0], controls.mouse_delta[1])
        jcam = jcam.float_position(j_flight_accel(jcam, controls.keys), DT)
        tcam = tcam.rotated(float(controls.mouse_delta[0]),
                            float(controls.mouse_delta[1]))
        tcam = tcam.float_position(_flight_accel(tcam, controls.keys), DT)
        np.testing.assert_allclose(tcam.serialize().numpy(),
                                   np.asarray(jcam.serialize()), rtol=1e-5,
                                   atol=1e-5, err_msg=f"frame {i}")
    assert float(torch.linalg.vector_norm(tcam.velocity)) > 0.0
