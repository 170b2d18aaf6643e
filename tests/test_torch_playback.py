"""The playback configuration on the CPU at a small size: a recording
replayed with a detached camera (``port_bench/programs/playback.py``)
against the benchmark's plain reference of it
(``port_bench/reference/programs/playback.py``), and the port's replay
against the live run it replays.

The size: 128x32, 10 asteroids, capacity 128, 128^2 shadow maps, the
configuration's other settings (two slots, a map every third frame), with
``RECORDED`` frames recorded in place of the file's 10,000.

* the program's first frames, three frames from its state and the frames
  past the recording's end against the reference, within the file's
  limits; the detached camera's flight against the reference's;
* a replay on a fresh engine equal to the live recording at every frame
  (world hash) and in its shadow state at the end, with deterministic
  algorithms on and off, and so a recording of rendered and headless
  frames;
* the detached replay, which renders once a frame, equal to the two
  renders a frame it replaces (world, shadow state and image, every
  frame);
* after warm-up a replayed detached frame captures nothing and reads or
  uploads nothing on the host;
* the Player's spans and counters, one program that renders in each
  traced detached frame, and the two metric readers on a span phase: a
  value for the playback, None for another program's.
"""

import ast
import contextlib
import copy
import dataclasses
import os

import numpy as np
import pytest
import torch

from port_bench import check, manifest
from port_bench.programs import playback as program
from port_bench.programs import space as space_program
from port_bench.reference.programs import playback as reference
from port_bench.traffic import Traffic
from render_engine_tpu_torch.logic.types import (KEY_ESC, KEY_W,
                                                 InputState)
from render_engine_tpu_torch.math.camera import CameraBuilder
from render_engine_tpu_torch.runtime.replay import (COUNTERS, PlaybackMode,
                                                    Player, _flight_accel)
from render_engine_tpu_torch.utils.hashing import world_hash

from host_traffic import no_host_traffic
from torch_threads import one_torch_thread  # noqa: F401

SIZE = dict(width=128, height=32, capacity=128, num_asteroids=10,
            shadow_resolution=128, shadow_max_tris=1024)
SEED = 2 ** 31 + 4099
CONFIG = "space-1080p-10k-playback"
CELL = "space-1080p-10k-playback.coast"
RECORDED = 12
START = 3  # frames from the start, checked against the reference's own
WINDOW = (5, 6, 7)  # frames checked from the program's state before them
HOST_AT = 10  # a replayed frame after warm-up, under no_host_traffic
PAST = 3  # frames past the recording's end
READERS = ("replay.detached_span_ms", "replay.player_host_ms")


def _config(frames=RECORDED):
    cfg = copy.deepcopy(manifest.config(manifest.load(), CONFIG))
    cfg["recording"]["frames"] = frames
    return cfg


def _inputs(fr):
    return InputState(keys=fr.keys, mouse_delta=fr.mouse_delta,
                      rng_seed=fr.rng_seed)


@pytest.fixture(scope="module")
def run():
    """The program's frames from the start to ``PAST`` frames past the
    recording's end, each against the reference following its own state,
    and the ``WINDOW`` frames also against a reference loaded with the
    program's state before them; frame ``HOST_AT`` runs under
    ``no_host_traffic``."""
    cfg = _config()
    prog = program.build(cfg, SEED, "cpu", SIZE)
    traffic = Traffic(manifest.traffic("coast"), SEED)
    ref = reference.Reference(cfg, SEED, "cpu", SIZE)
    loaded = reference.Reference(cfg, SEED, "cpu", SIZE)
    out = {"cfg": cfg, "prog": prog, "follow": check.Readings(),
           "window": check.Readings(), "past": check.Readings(),
           "modes": [], "scene": check.compare(
               reference.state_of(prog)["world"], ref.state()["world"])}
    for i in range(RECORDED + PAST):
        fr = traffic.frame(i)
        pre = reference.state_of(prog)
        if i == HOST_AT:
            before = prog.captured_programs
            with no_host_traffic():
                img = prog.frame(_inputs(fr), fr.dt)
            out["host"] = (before, prog.captured_programs)
        else:
            img = prog.frame(_inputs(fr), fr.dt)
        out["modes"].append(prog.player.mode)
        post = reference.state_of(prog)
        ref_img = ref.frame(fr)
        if i < START:
            out["follow"].frame(i, post, img, ref.state(), ref_img, True)
        if i >= RECORDED:
            out["past"].frame(i, post, img, ref.state(), ref_img, True)
        if i in WINDOW:
            loaded.load(pre)
            loaded_img = loaded.frame(fr)
            out["window"].frame(i, post, img, loaded.state(), loaded_img,
                                True)
    return out


@pytest.mark.parametrize("part", ["follow", "window"])
def test_the_frames_are_the_references(run, part):
    assert run["scene"] == 0.0
    ok, rows = check.judge(run[part].values, run["cfg"]["limits"])
    assert ok, rows
    assert {name for name, _, _ in rows} == set(check.NUMBERS)


def test_past_the_end_frames_run_live_as_the_reference(run):
    """Up for one live frame, then Right: RUN, each frame within the
    limits of the reference's live frames."""
    ok, rows = check.judge(run["past"].values, run["cfg"]["limits"])
    assert ok, rows
    modes = run["modes"]
    assert set(modes[:RECORDED]) == {PlaybackMode.DEBUG_CUSTOM_MOVEMENT}
    assert modes[RECORDED:] == [PlaybackMode.ONE_PAST_LAST_PAUSE] + [
        PlaybackMode.RUN] * (PAST - 1)
    assert run["prog"].frame_index == RECORDED + PAST


def test_a_replayed_frame_after_warm_up_captures_nothing(run):
    before, after = run["host"]
    assert before == after
    # the recorded frame's step and shadow update, the detached render,
    # and the live frames' programs; no render from the recorded camera
    assert {k[0] for k in after} == {"frame", "step", "shadows", "render"}


SHADOW = ("maps", "light_mats", "slot_entity", "slot_face")
FUSED = (0, 4, 5, 9)  # the mixed recording's frames rendered live
CONTROLS = dataclasses.replace(InputState.idle().with_keys(KEY_W),
                               mouse_delta=np.array([0.02, -0.01],
                                                    np.float32))


@contextlib.contextmanager
def _deterministic_algorithms(on):
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(on)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def _live(fused=()):
    """The recording's frames live, W and a turn on some of them: those in
    ``fused`` rendered (the frame program), the others headless, each
    followed by the engine's shadow update. The live engine and its world
    hash after every frame."""
    traffic = Traffic(manifest.traffic("step"), SEED)
    live = space_program.build(dict(_config(), record_history=True), SEED,
                               "cpu", SIZE)
    hashes = []
    for i in range(RECORDED):
        fr = traffic.frame(i)
        inp = _inputs(fr).with_keys(KEY_W) if i % 3 == 1 else _inputs(fr)
        if i in fused:
            live.frame(inp, fr.dt, render=True)
        else:
            live.frame(inp, fr.dt, render=False)
            live.update_shadows()
        hashes.append(world_hash(live.world))
    return live, hashes


def _detached_step(player, i):
    """Replayed frame ``i`` rendered through the detached camera: Esc on
    the first frame, W and a mouse turn on every frame."""
    controls = CONTROLS.with_keys(KEY_ESC) if i == 0 else CONTROLS
    img, _ = player.step(controls, render=True)
    return img


def _assert_same_shadows(a, b):
    for name in SHADOW:
        assert torch.equal(getattr(a, name), getattr(b, name)), name
    assert (a.cursor, a.tick) == (b.cursor, b.tick)


@pytest.mark.parametrize("deterministic", [True, False])
def test_replay_is_the_live_run_to_the_bit(deterministic):
    """The recording's frames live (headless, each followed by the
    engine's shadow update), then replayed on a fresh engine through the
    Player with the camera detached and every frame rendered: the world
    hash after every frame, and the shadow state at the end, equal."""
    with _deterministic_algorithms(deterministic):
        live, hashes = _live()
        eng = space_program.build(_config(), SEED, "cpu", SIZE)
        player = Player(eng, live.history)
        got = []
        for i in range(RECORDED):
            _detached_step(player, i)
            got.append(world_hash(eng.world))
    assert got == hashes
    a, b = live.shadow_state, eng.shadow_state
    _assert_same_shadows(a, b)
    assert (b.cursor, b.tick) == (len(range(0, RECORDED, 3)), RECORDED)
    assert not torch.equal(player.detached_camera.position,
                           eng.camera.position)


@pytest.mark.parametrize("deterministic", [True, False])
def test_one_render_is_the_two_render_sequence_to_the_bit(deterministic):
    """The detached replay, which renders once a frame, against the
    sequence it replaces, driven on a second engine from the same
    baseline: each recorded frame through ``Engine.frame`` with ``render``
    (the step, then the shadow update and the render from the recorded
    camera), then ``render_only`` through the detached camera. After every
    frame the world hash, the shadow tables, cursor and tick, and the
    detached image equal."""
    with _deterministic_algorithms(deterministic):
        live, _ = _live()
        assert not any(live.history.frames_fused)
        assert not live.history.events
        eng = space_program.build(_config(), SEED, "cpu", SIZE)
        two = space_program.build(_config(), SEED, "cpu", SIZE)
        player = Player(eng, live.history)
        Player(two, live.history)  # the same baseline, restored
        for i in range(RECORDED):
            img = _detached_step(player, i)
            inputs, dt = live.history.frame(i)
            recorded = two.frame(inputs, dt, render=True, advance="step")
            shown = two.render_only(player.detached_camera)
            assert world_hash(eng.world) == world_hash(two.world), i
            _assert_same_shadows(eng.shadow_state, two.shadow_state)
            assert torch.equal(img, shown), i
    assert not torch.equal(img, recorded)


def test_a_mixed_recording_replays_detached_to_the_bit():
    """A recording of rendered (fused) and headless (step) frames, replayed
    with the camera detached and every frame rendered: the world hash
    after every frame and the shadow state at the end are the live run's;
    only the step frames count as rendered once."""
    live, hashes = _live(fused=FUSED)
    assert [i for i in range(RECORDED)
            if live.history.advance_fused(i)] == list(FUSED)
    eng = space_program.build(_config(), SEED, "cpu", SIZE)
    eng.set_tracing(True)
    player = Player(eng, live.history)
    got = []
    for i in range(RECORDED):
        _detached_step(player, i)
        got.append(world_hash(eng.world))
    assert got == hashes
    _assert_same_shadows(live.shadow_state, eng.shadow_state)
    c = eng.trace_report()["counters"]
    assert (c["replayed_frames"], c["detached_renders"],
            c["single_render_frames"]) == (RECORDED, RECORDED,
                                           RECORDED - len(FUSED))
    assert {k[0] for k in eng.captured_programs} == {"frame", "step",
                                                     "shadows", "render"}


def test_the_flight_is_the_references():
    """W and a mouse turn fly the port's detached camera as the
    reference's ``fly`` does."""
    cam = CameraBuilder().with_position(10.0, -5.0, 30.0) \
        .with_yaw_pitch_degrees(-80.0, 10.0).build()
    camv = cam.serialize().clone()
    keys = np.zeros(16, bool)
    keys[[KEY_W, 3, 4]] = True  # W, D, Space
    dt = float(np.float32(1.0 / 60.0))
    for _ in range(5):
        cam = cam.rotated(0.01, -0.02)
        cam = cam.float_position(_flight_accel(cam, keys), dt)
        camv = reference.fly(camv, keys, np.array([0.01, -0.02], np.float32),
                             dt)
    torch.testing.assert_close(cam.serialize(), camv, rtol=0, atol=1e-5)
    # idle controls: the pose holds, the velocity decays and moves it
    idle = reference.fly(camv, np.zeros(16, bool), np.zeros(2, np.float32),
                         dt)
    vel = camv[5:8] * torch.tensor(0.9)
    assert torch.equal(idle[3:5], camv[3:5])
    assert torch.equal(idle[5:8], vel)
    assert torch.equal(idle[0:3], camv[0:3] + vel * torch.tensor(dt))


@pytest.fixture(scope="module")
def traced():
    """A span phase of a playback with tracing on, through the end of its
    recording and two frames past it (and its record after two frames),
    and one of the ``space`` program."""
    cfg = _config(frames=4)
    traffic = Traffic(manifest.traffic("coast"), SEED)
    prog = program.build(cfg, SEED, "cpu", SIZE)
    space = space_program.build(_config(), SEED, "cpu", SIZE)
    out = {}

    def record(name, report):
        out[name] = {"spans": {"frames": report["frames"],
                               "counters": report["counters"]}}

    for name, p in (("playback", prog), ("space", space)):
        p.set_tracing(True)
        for i in range(6):
            fr = traffic.frame(i)
            p.frame(_inputs(fr), fr.dt)
            if p is prog and i == 1:
                record("replaying", p.trace_report())
        record(name, p.trace_report())
    return out


def test_the_player_records_its_spans_and_counters(traced):
    calls = traced["playback"]["spans"]["frames"]
    players = [c for c in calls if c["call"] == "player.step"]
    assert len(players) == 6 + 1  # Up at the end is one step more
    first = players[0]
    assert [h["name"] for h in first["host"]] == [
        "player.step", "player.controls", "player.history", "player.camera",
        "engine.trace"]
    within = [(c["call"], c["within"]) for c in calls
              if c["within"] == first["index"]]
    assert within == [("engine.frame", first["index"]),
                      ("engine.update_shadows", first["index"]),
                      ("engine.render", first["index"])]
    c = traced["playback"]["spans"]["counters"]
    assert (c["replayed_frames"], c["detached_renders"],
            c["single_render_frames"], c["live_frames"]) == (4, 4, 4, 2)
    # a replay that has not reached its end counts its live frames as 0
    assert traced["replaying"]["spans"]["counters"]["live_frames"] == 0
    assert not set(COUNTERS) & set(traced["space"]["spans"]["counters"])


def _kind(program):
    """The kind of a program's key as a trace names it: ``('step',)``
    is ``step``."""
    return program[2:].split("'")[0]


def test_a_traced_detached_frame_renders_once(traced):
    """Each replayed detached frame of the span phase replays no
    ``render_shadowed`` program and one program that renders, the
    detached camera's."""
    calls = traced["playback"]["spans"]["frames"]
    players = [c["index"] for c in calls if c["call"] == "player.step"]
    for index in players[:4]:  # the recording's frames
        kinds = [_kind(p) for c in calls if c.get("within") == index
                 for p in c["programs"]]
        assert "render_shadowed" not in kinds
        assert [k for k in kinds if k in (
            "frame", "render_shadowed", "render")] == ["render"], kinds


@pytest.mark.parametrize("name", READERS)
def test_the_readers_read_the_playback_alone(traced, name):
    read = manifest.metric_reader(name)
    assert read(traced["playback"]) > 0.0
    assert read(traced["space"]) is None
    assert read({"spans": None}) is None


def test_the_configuration_states_its_deployment():
    b = manifest.load()
    entry = next(c for c in b["configs"] if c["name"] == CONFIG)
    cfg = manifest.config(b, CONFIG)
    assert entry["reduced"] == [] == cfg["reduced"]
    assert cfg["program"] == "playback" and cfg["source"] == entry["source"]
    base = manifest.config(b, "space-1080p-10k")
    for k in ("space_config", "scene", "fused_shading"):
        assert cfg[k] == base[k], k
    assert cfg["recording"] == {"frames": 10000, "traffic": "step"}
    assert {"recording", "log", "detached_pose"} <= set(cfg["assumed"])
    assert set(cfg["limits_why"]) == set(cfg["limits"]) == set(check.NUMBERS)
    assert os.path.exists(os.path.join(manifest.ROOT, entry["file"]))
    cell = manifest.cell(b, CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "coast", 1)
    for m in b["per_layer"]:
        assert (m["name"] in READERS) == (CELL in m.get("workloads", []))
    # the reference imports nothing of the port or JAX
    tree = ast.parse(open(reference.__file__).read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names if n.split(".")[0] in (
        "render_engine_tpu", "render_engine_tpu_torch", "jax")]
