"""The port's record and replay on the CPU at the demo test size (128x32,
10 asteroids, capacity 128): disk round trip, bit-exact replay (world
hashes, images and shadow state), the five playback modes, the
detached camera, continuing past the end, the supervisor, recorded config
changes and a churn at capacity. The cases mirror tests/test_replay.py;
every test runs under ``torch.use_deterministic_algorithms(True)``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.logic.step import unpack_drop_stats
from render_engine_tpu_torch.logic.types import (KEY_ESC, KEY_INSERT,
                                                 KEY_RIGHT, KEY_UP, KEY_W,
                                                 InputState)
from render_engine_tpu_torch.runtime.history import HistoryLog
from render_engine_tpu_torch.runtime.replay import PlaybackMode, Player
from render_engine_tpu_torch.runtime.supervisor import Supervisor
from render_engine_tpu_torch.utils.hashing import world_hash

KW = dict(width=128, height=32, capacity=128, num_asteroids=10,
          max_tris=2048)
DT = 1.0 / 30.0
# render flag and advance choice per frame of the mixed recording: fused
# and step frames, and a fused frame that returns no image
MIXED = [(True, None), (True, None), (False, None), (True, None),
         (False, "fused"), (True, None)]


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(prev)


@pytest.fixture(scope="module")
def engines():
    """Port engines on the CPU, cached by (slot, kwargs) and reset to frame
    zero, recording on, on reuse."""
    cache = {}

    def get(slot=0, **kw):
        kw = {**KW, **kw}
        key = (slot, tuple(sorted(kw.items())))
        eng = cache.get(key)
        if eng is None:
            eng = cache[key] = TS.build_space_engine(device="cpu", **kw)
        eng.config.record_history = True
        eng.reset()
        return eng

    return get


@pytest.fixture(scope="module")
def recorded(engines, tmp_path_factory):
    """One live run of 5 step frames, flushed to disk."""
    d = str(tmp_path_factory.mktemp("hist"))
    eng = engines()
    eng.config.history_dir = d
    hashes = []
    for i in range(5):
        eng.frame(InputState.idle(i).with_keys(KEY_W), DT, render=False)
        hashes.append(world_hash(eng.world))
    eng.flush_history()
    return d, hashes


def _replayer(engines, d, slot=1):
    eng = engines(slot=slot)
    eng.config.record_history = False
    return eng, Player(eng, HistoryLog.load(d))


def test_roundtrip(recorded):
    d, _ = recorded
    log = HistoryLog.load(d)
    assert log.num_frames == 5
    inputs, dt = log.frame(0)
    assert bool(inputs.keys[KEY_W])
    assert abs(dt - DT) < 1e-6
    assert log.baseline_world["alive"].sum() > 0
    assert log.baseline_world["comp_mask"].dtype == np.uint32
    assert log.baseline_world["comps"]["flags"].dtype == np.uint32
    assert [log.advance_fused(i) for i in range(5)] == [False] * 5


def test_snapshot_restore_and_despawn(engines):
    eng = engines()
    world = eng.world
    back = W.restore(world.config, W.snapshot(world))
    assert world_hash(back) == world_hash(world)
    assert back.comps.keys() == world.comps.keys()
    for name in ("alive", "comp_mask", *world.comps):
        a, b = getattr(world, name, None), getattr(back, name, None)
        if a is None:
            a, b = world[name], back[name]
        assert a.dtype == b.dtype and torch.equal(a, b), name
    kill = torch.zeros_like(world.alive)
    kill[int(torch.nonzero(world.alive)[0])] = True
    gone = W.despawn(world, kill)
    assert int(gone.alive.sum()) == int(world.alive.sum()) - 1
    assert int(gone.comp_mask[kill]) == 0
    assert torch.equal(W.despawn(gone, kill).alive, gone.alive)
    assert world_hash(gone) != world_hash(world)


@pytest.mark.parametrize("case", ["steps", "mixed"])
def test_replay_is_bitwise(case, recorded, engines, tmp_path):
    """Live against replay, frame for frame: world hashes equal; with the
    mixed fused/step flags also every image rendered live and, at the end,
    the shadow state (maps, light matrices and schedule)."""
    if case == "steps":
        d, live_hashes = recorded
        _, player = _replayer(engines, d)
        assert player.replay_all(render=False) == live_hashes
        return
    d = str(tmp_path)
    live = engines(slot=2)
    live.config.history_dir = d
    hashes, images = [], []
    for i, (render, advance) in enumerate(MIXED):
        images.append(live.frame(InputState.idle(i).with_keys(KEY_W), DT,
                                 render=render, advance=advance))
        hashes.append(world_hash(live.world))
    live.flush_history()
    eng, player = _replayer(engines, d, slot=3)
    log = player.history
    assert [log.advance_fused(i) for i in range(len(MIXED))] == [
        r or a == "fused" for r, a in MIXED]
    for i, (render, _) in enumerate(MIXED):
        img, _ = player.step(render=render)
        assert world_hash(eng.world) == hashes[i], f"frame {i}"
        assert (img is None) == (images[i] is None)
        if img is not None:
            assert torch.equal(img, images[i]), f"frame {i}"
    a, b = live.shadow_state, eng.shadow_state
    for name in ("maps", "light_mats", "slot_entity", "slot_face"):
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.cursor, a.tick) == (b.cursor, b.tick)


def test_replay_reaches_end_state(recorded, engines):
    d, _ = recorded
    _, player = _replayer(engines, d)
    player.replay_all(render=False)
    assert player.mode == PlaybackMode.DEBUG
    _, at_end = player.step(render=False)
    assert at_end
    assert player.mode == PlaybackMode.ONE_PAST_LAST_FRAME


def test_detach_and_reattach_camera(recorded, engines):
    d, _ = recorded
    _, player = _replayer(engines, d)
    player.step(InputState.idle(0).with_keys(KEY_ESC), render=False)
    assert player.mode == PlaybackMode.DEBUG_CUSTOM_MOVEMENT
    assert player.detached_camera is not None
    player.step(InputState.idle(0).with_keys(KEY_INSERT), render=False)
    assert player.mode == PlaybackMode.DEBUG
    assert player.detached_camera is None


def test_detached_camera_free_flight(recorded, engines):
    """W flies the detached camera forward with inertia while the
    replayed world stays the recorded one, frame for frame; a rendered
    frame shows the detached view, not the recorded camera's."""
    d, live_hashes = recorded
    eng, player = _replayer(engines, d)
    player.step(InputState.idle(0).with_keys(KEY_ESC), render=False)
    hashes = [world_hash(eng.world)]
    p0 = player.detached_camera.position.numpy().copy()
    fwd0 = player.detached_camera.direction().numpy().copy()
    img = None
    while player.cursor < player.history.num_frames:
        # the last frame also turns the detached camera, and renders
        last = player.cursor == player.history.num_frames - 1
        controls = dataclasses.replace(
            InputState.idle(0).with_keys(KEY_W),
            mouse_delta=np.array([0.05 * last, 0.0], np.float32))
        img, _ = player.step(controls, render=last)
        hashes.append(world_hash(eng.world))
    moved = player.detached_camera.position.numpy() - p0
    assert np.linalg.norm(moved) > 0.01
    assert np.dot(moved / np.linalg.norm(moved), fwd0) > 0.99
    assert float(torch.linalg.vector_norm(
        player.detached_camera.velocity)) > 0.0
    assert hashes == live_hashes
    assert img.shape == (KW["height"], KW["width"], 3)
    assert bool(torch.isfinite(img).all())
    assert not torch.equal(img, eng.render())


def test_continue_past_end(recorded, engines):
    """Up steps one live frame past the recording; Right resumes RUN."""
    d, _ = recorded
    eng, player = _replayer(engines, d)
    player.replay_all(render=False)
    player.step(render=False)  # the end marker
    assert player.mode == PlaybackMode.ONE_PAST_LAST_FRAME
    h_before = world_hash(eng.world)
    player.step(InputState.idle(9).with_keys(KEY_UP), render=False)
    assert player.mode == PlaybackMode.ONE_PAST_LAST_PAUSE
    assert world_hash(eng.world) != h_before
    player.step(InputState.idle(10).with_keys(KEY_RIGHT), render=False)
    assert player.mode == PlaybackMode.RUN


def test_supervisor_flushes_on_crash(tmp_path, engines):
    eng = engines()
    eng.config.history_dir = str(tmp_path)
    with pytest.raises(RuntimeError):
        with Supervisor(eng) as sup:
            sup.tick(InputState.idle(0), render=False)
            sup.tick(InputState.idle(1), render=False)
            raise RuntimeError("simulated crash")
    log = HistoryLog.load(str(tmp_path))
    assert log.num_frames == 2
    assert sup.failed and "simulated crash" in sup.failure_info


@pytest.mark.parametrize("row", ["alive", "dead"])
def test_supervisor_nan_detection(engines, row):
    """A NaN in a live row is caught; one in a dead row is not."""
    eng = engines()
    eng.config.record_history = False
    sup = Supervisor(eng, nan_check_every=1)
    sup.tick(InputState.idle(0), render=False)
    alive = eng.world.alive
    idx = int(torch.nonzero(alive if row == "alive" else ~alive)[0])
    vel = eng.world["velocity"].clone()
    vel[idx, 0] = float("nan")
    eng.world = eng.world.replace(velocity=vel)
    if row == "alive":
        with pytest.raises(FloatingPointError, match="velocity"):
            sup.check_state_health()
        assert sup.failed
    else:
        sup.check_state_health()
        assert not sup.failed


def test_supervisor_heartbeat(engines):
    eng = engines()
    eng.config.record_history = False
    sup = Supervisor(eng)
    sup.tick(InputState.idle(0), render=False)
    assert sup.heartbeat == 1
    assert sup.seconds_since_heartbeat() < 60.0


def test_mid_recording_draw_distance_and_seed(tmp_path, engines):
    """A draw-distance change mid-recording and a 2^32-1 seed replay bit
    for bit; reset() restores the draw distance."""
    d = str(tmp_path)
    eng = engines()
    eng.config.history_dir = d
    hashes = []
    for i in range(6):
        if i == 3:
            eng.set_draw_distances(draw_distance=200.0)
        seed = 2**32 - 1 if i == 2 else i
        inp = dataclasses.replace(InputState.idle(i).with_keys(KEY_W),
                                  rng_seed=seed)
        eng.frame(inp, DT, render=False)
        hashes.append(world_hash(eng.world))
    assert eng.camera.draw_distance == 200.0
    eng.flush_history()
    eng2, player = _replayer(engines, d)
    assert player.replay_all(render=False) == hashes
    assert eng2.camera.draw_distance == 200.0
    eng.reset()
    assert eng.camera.draw_distance == 1500.0


def test_mid_recording_window_change(tmp_path, engines):
    """A window change mid-recording: the replayed engine renders at the
    recorded size and its world is the live one; reset() restores the
    size."""
    d = str(tmp_path)
    eng = engines(slot=2)
    eng.config.history_dir = d
    eng.frame(InputState.idle(0), DT, render=False)
    eng.set_window(96, 16)
    img = eng.frame(InputState.idle(1), DT, render=True)
    assert img.shape == (16, 96, 3)
    assert eng.camera.aspect == 6.0
    h_live = world_hash(eng.world)
    eng.flush_history()
    eng2, player = _replayer(engines, d, slot=3)
    player.step(render=False)
    img2, _ = player.step(render=True)
    assert img2.shape == (16, 96, 3)
    assert eng2.camera.aspect == 6.0
    assert world_hash(eng2.world) == h_live
    assert torch.equal(img2, img)
    for e in (eng, eng2):
        e.reset()
        assert (e.config.render.width, e.config.render.height) == (128, 32)
        assert e.camera.aspect == 4.0


@pytest.mark.parametrize("case", ["steps", "render_last", "rendered"])
def test_run_frames_match_the_frame_loop(engines, case):
    """run_frames / run_frames_rendered give the frame loop's world, image
    and shadow state, with drop counters the max over the burst;
    run_frames records step frames, run_frames_rendered refuses to run
    while recording."""
    inputs = [InputState.idle(i).with_keys(KEY_W) for i in range(3)]
    dts = [DT] * 3
    renders = {"steps": [False] * 3, "render_last": [False, False, True],
               "rendered": [True] * 3}[case]
    loop = engines(slot=2)
    loop.config.record_history = False
    drops, img_loop = [], None
    for inp, render in zip(inputs, renders):
        img_loop = loop.frame(inp, DT, render=render, advance="step")
        drops.append(unpack_drop_stats(loop._last_drops))
    burst = engines(slot=3)
    if case == "rendered":
        with pytest.raises(RuntimeError, match="unrecorded"):
            burst.run_frames_rendered(inputs, dts)
        burst.config.record_history = False
        img = burst.run_frames_rendered(inputs, dts)
    else:
        img = burst.run_frames(inputs, dts,
                               render_last=case == "render_last")
        assert burst.history.frames_fused == [False] * 3
    assert (img is None) == (img_loop is None)
    if img is not None:
        assert torch.equal(img, img_loop)
    assert torch.equal(burst.shadow_state.maps, loop.shadow_state.maps)
    assert world_hash(burst.world) == world_hash(loop.world)
    assert burst.frame_index == loop.frame_index == 3
    assert unpack_drop_stats(burst._last_drops) == {
        k: max(d[k] for d in drops) for k in drops[0]}


def test_capacity_churn_replays_bitwise(engines):
    """A world at capacity where the in-step spawns hit the ceiling: the
    backpressure shows in the drop counters and the whole churn replays
    bit for bit. 28 slots hold the 26 fixed entities and two free; the
    mine producer fires every 4 s, and dt is 1 s."""
    kw = dict(width=64, height=16, capacity=28, num_asteroids=20,
              max_tris=2048, spawn_budget=2)
    eng = engines(**kw)
    hashes = []
    spawn_drops = 0
    for i in range(40):
        key = KEY_W if i % 3 else KEY_UP
        eng.frame(InputState.idle(i).with_keys(key), 1.0, render=False)
        hashes.append(world_hash(eng.world))
        spawn_drops += unpack_drop_stats(eng._last_drops)["spawn_dropped"]
    assert int(eng.world.alive.sum()) >= eng.world.capacity - 2
    assert spawn_drops > 0
    eng2 = engines(slot=1, **kw)
    eng2.config.record_history = False
    player = Player(eng2, eng.history)
    for i in range(eng.history.num_frames):
        player.step(render=False)
        assert world_hash(eng2.world) == hashes[i], f"frame {i} diverged"


def _gate_default_system_on_w(eng):
    """Give the demo's lit system a draw callback that draws its models
    only while W is held (always, for a view without inputs)."""
    lit, *rest = eng.compiled_systems.src

    def draw(dp):
        inp = dp.get_input_history()
        dp.draw_models(*lit.model_ids,
                       when=True if inp is None else inp.keys[KEY_W])

    eng.set_render_systems((dataclasses.replace(lit, draw=draw), *rest))
    eng.finalize_scene()


def test_input_gated_draw_callback_replays_image_for_image(engines,
                                                           tmp_path):
    """A draw callback that reads the frame's inputs gets the recorded
    inputs in a replay: every image equals the live one."""
    eng = engines(slot="draw-live")
    _gate_default_system_on_w(eng)
    assert eng.compiled_systems.has_draw_callbacks()
    eng.config.history_dir = str(tmp_path)
    held = (True, False, True, True, False)
    live = []
    for i, w_held in enumerate(held):
        inp = InputState.idle(i)
        live.append(eng.frame(inp.with_keys(KEY_W) if w_held else inp, DT))
    eng.flush_history()
    # the last frame was drawn with W released: the lit system is missing
    # from it, and a view without inputs draws it
    everything = eng.render_only()
    gated = (everything - live[-1]).abs().amax(dim=-1) > 0.02
    assert int(gated.sum()) >= 3  # the few pixels of the small asteroids

    eng2 = engines(slot="draw-replay")
    _gate_default_system_on_w(eng2)
    eng2.config.record_history = False
    player = Player(eng2, HistoryLog.load(str(tmp_path)))
    for i, want in enumerate(live):
        img, _ = player.step(render=True)
        assert torch.equal(img, want), f"frame {i}"
    assert world_hash(eng2.world) == world_hash(eng.world)
    assert torch.equal(eng2.render_only(eng2.camera), everything)
