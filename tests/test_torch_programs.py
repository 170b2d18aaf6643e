"""The Engine's programs (render_engine_tpu_torch/runtime/engine.py) on the
CPU, where they run eagerly: the same functions a card captures as CUDA
graphs.

* The packed input wire: the port's ``InputState.unpack_with_dt`` of a
  tensor against the JAX package's traced inverse, exact.
* 12 frames of the demo engine (256x192, capacity 128, 40 asteroids,
  shadows at 128^2 with an update every 3 frames over 2 slots, so the
  frames pass through every schedule variant) against the JAX Engine's
  ``frame``, with ``dt`` and the seed varying per frame and one frame of
  4.5 s, which fires the mine spawner inside the step program. The JAX
  engine runs its Pallas kernels in interpret mode, its shadow raster
  patched to the Pallas path (ROADMAP Queue 3). Tolerances, as in
  tests/test_torch_engine_shadows.py: integer columns, the shadow
  schedule and every drop counter exact; float columns rtol 1e-5 / atol
  1e-4 (XLA's and PyTorch's sin and cos differ in the last bit, so the
  world hashes of the two packages differ after the first step: positions
  by one ulp at 1000); images within 2/255 with at most 0.1% of u8 values
  differing. The spawned mine's velocity, which is the draw itself, is
  held bit for bit to ``jax.random``.
* No host traffic: after a warm-up call, the step, the shadowed frame and
  the rendered burst run again with every read of a tensor's value on the
  host and every upload raising (the CPU's stand-in for the card's sync
  debug mode and for capture's ban on pageable copies). K1's plain
  version, which stands in for a kernel, reads its loop's trip count from
  its inputs; the patches are lifted inside it.
* One program per shadow decision: six slots at interval 1 run through
  ``("frame", "map")`` alone, the slot fed as data, frame for frame equal
  to the program's function fed by hand.
* Invalidation: each config event drops exactly the programs it must; a
  new window renders at its size; a recorded run with window and
  draw-distance events replays twice on one engine, ``reset`` between,
  to the same hashes and images.
* ``run_frames`` keeps the per-counter max of a counter that overflows in
  the middle of the burst only, as the JAX package's ``run_frames``.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.logic.step import unpack_drop_stats as j_drops
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.math.camera import CameraBuilder as JCameraBuilder
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.runtime.engine import Engine as JEngine

from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.logic.step import unpack_drop_stats
from render_engine_tpu_torch.logic.types import KEY_W, NUM_KEYS
from render_engine_tpu_torch.logic.types import InputState as TInput
from render_engine_tpu_torch.render import skybox as SB
from render_engine_tpu_torch.render.frame import to_srgb_u8
from render_engine_tpu_torch.runtime import engine as E
from render_engine_tpu_torch.runtime.history import HistoryLog
from render_engine_tpu_torch.runtime.replay import Player
from render_engine_tpu_torch.utils.hashing import world_hash

from test_torch_shadows import assert_state_close
from host_traffic import no_host_traffic
from torch_threads import one_torch_thread  # noqa: F401

KW = dict(width=256, height=192, capacity=128, num_asteroids=40,
          shadow_update_interval=3, shadow_slots=2)
SMALL = dict(width=128, height=32, capacity=128, num_asteroids=10,
             max_tris=2048, shadow_update_interval=3, shadow_slots=2)
# per frame: dt (the third fires the mine spawner: its period is 4 s) and
# the seed
DTS = (1 / 60, 1 / 30, 4.5, 1 / 60, 0.05, 1 / 60, 1 / 45, 1 / 60, 0.1,
       1 / 60, 1 / 60, 1 / 30)
SEEDS = tuple((s + i) & 0xFFFFFFFF for i, s in enumerate(
    (7, 2 ** 32 - 1, 12345, 2 ** 31) * 3))
DT = 1 / 60
VARIANTS = {("frame", "skip"), ("frame", "map")}


def _inputs(cls, i, seed=None):
    base = cls.idle(0).with_keys(KEY_W) if i % 2 else cls.idle(0)
    seed = SEEDS[i % len(SEEDS)] if seed is None else seed
    return dataclasses.replace(
        base, rng_seed=np.uint32(seed) if cls is JInput else seed,
        mouse_delta=np.array([0.01 * (i % 3), -0.005 * (i % 2)],
                             np.float32))


def _jax_engine(kw):
    cfg = JS.space_config(**kw)
    cfg.record_history = False
    cfg.render = dataclasses.replace(cfg.render, backend="pallas")
    cam = (JCameraBuilder().with_position(1000.0, 1000.0, 1150.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(kw["width"] / kw["height"])
           .with_near_far(0.5, 1500.0).with_draw_distance(1500.0).build())
    return JEngine(cfg, camera=cam)


def _columns(world, jax_world=False):
    cols = {"alive": world.alive, "comp_mask": world.comp_mask,
            **world.comps}
    out = {}
    for k, v in cols.items():
        a = np.asarray(v) if jax_world else v.numpy()
        out[k] = a.view(np.int32) if a.dtype == np.uint32 else a
    return out


@pytest.fixture(scope="module")
def runs():
    """Both engines through the 12 frames; per-frame snapshots."""
    mp = pytest.MonkeyPatch()
    mp.setattr(FJ, "pick_rasterizer",
               lambda backend="auto": RPJ.rasterize_depth_winner_pallas)
    try:
        jeng = _jax_engine(KW)
        teng = TS.build_space_engine(device="cpu", **KW)
        teng.config.record_history = False
        out = []
        for i, dt in enumerate(DTS):
            jimg = np.asarray(jeng.frame(_inputs(JInput, i), dt))
            timg = teng.frame(_inputs(TInput, i), dt).numpy()
            out.append(dict(
                jimg=jimg, timg=timg,
                jw=_columns(jeng.world, True), tw=_columns(teng.world),
                jcam=np.asarray(jeng.camera.serialize()),
                tcam=teng.camera.serialize().numpy(),
                jdrops=jeng.drop_stats(), tdrops=teng.drop_stats(),
                jsh=jax.tree_util.tree_map(np.asarray, jeng.shadow_state),
                tsh=teng.shadow_state))
    finally:
        mp.undo()
    return dict(frames=out, programs=teng.captured_programs)


@pytest.mark.parametrize("frame", range(len(DTS)))
def test_program_frames_match_jax(runs, frame):
    r = runs["frames"][frame]
    assert set(r["jw"]) == set(r["tw"])
    for name, want in r["jw"].items():
        got = r["tw"][name]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    np.testing.assert_allclose(r["tcam"], r["jcam"], rtol=1e-5, atol=1e-5)
    assert r["tdrops"] == r["jdrops"]
    assert_state_close(r["tsh"], r["jsh"])


@pytest.mark.parametrize("frame", range(len(DTS)))
def test_program_images_match_jax(runs, frame):
    r = runs["frames"][frame]
    assert r["timg"].shape == (KW["height"], KW["width"], 3)
    diff = np.abs(r["timg"] - r["jimg"])
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = to_srgb_u8(torch.from_numpy(r["timg"])).numpy()
    b = to_srgb_u8(torch.from_numpy(np.array(r["jimg"]))).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()


def test_step_program_draws_equal_jax(runs):
    """The mine spawned by the 4.5 s frame: its velocity is the step's
    second draw, bit for bit ``jax.random``'s."""
    r = runs["frames"][2]
    mine = r["tw"]["type_id"] == TS.TYPE_MINE
    assert r["tw"]["alive"][mine].sum() == 1
    np.testing.assert_array_equal(r["tw"]["type_id"], r["jw"]["type_id"])
    np.testing.assert_array_equal(r["tw"]["velocity"][mine].view(np.uint32),
                                  r["jw"]["velocity"][mine].view(np.uint32))
    assert not runs["frames"][1]["tw"]["alive"][mine].any()


def test_frames_pass_every_schedule_variant(runs):
    assert VARIANTS <= runs["programs"]
    assert runs["frames"][-1]["tsh"].tick == len(DTS)


@pytest.mark.parametrize("seed", [0, 1, 2 ** 31, 2 ** 32 - 1])
def test_device_unpack_matches_jax(seed):
    rng = np.random.default_rng(seed % 97)
    inp = dataclasses.replace(
        TInput.idle(seed), keys=rng.random(NUM_KEYS) < 0.5,
        mouse_delta=rng.normal(size=2).astype(np.float32),
        prev_keys=rng.random(NUM_KEYS) < 0.5)
    dt = np.float32(rng.uniform(0.001, 5.0))
    packed = inp.pack_with_dt(dt)
    jin, jdt = JInput.unpack_with_dt(jnp.asarray(packed))
    tin, tdt = TInput.unpack_with_dt(torch.from_numpy(packed))
    assert tdt.dtype == torch.float32 and tdt.dim() == 0
    assert tin.rng_seed.dtype == torch.int64 and tin.rng_seed.dim() == 0
    assert int(tin.rng_seed) == int(jin.rng_seed) == seed
    assert np.float32(tdt).view(np.uint32) == np.float32(jdt).view(np.uint32)
    np.testing.assert_array_equal(tin.keys.numpy(), np.asarray(jin.keys))
    np.testing.assert_array_equal(tin.prev_keys.numpy(),
                                  np.asarray(jin.prev_keys))
    np.testing.assert_array_equal(
        tin.mouse_delta.numpy().view(np.uint32),
        np.asarray(jin.mouse_delta).view(np.uint32))


# ------------------------------------------------------------ host traffic
@pytest.fixture(scope="module")
def small():
    eng = TS.build_space_engine(device="cpu", **SMALL)
    eng.config.record_history = False
    return eng


@pytest.mark.parametrize("what", ["step", "shadowed_frame",
                                  "rendered_burst"])
def test_no_host_traffic(small, what):
    eng = small
    eng.reset()
    eng.frame(_inputs(TInput, 0), DT)

    def run():
        if what == "step":
            eng.program_function(("step",))(eng._state)
        elif what == "shadowed_frame":
            eng.program_function(("frame", "map"))(eng._state)
        else:
            eng.run_frames_rendered(
                [_inputs(TInput, i) for i in range(4)], [DT] * 4)

    run()
    eng.reset()
    eng.frame(_inputs(TInput, 0), DT)
    with no_host_traffic():
        run()
    assert bool(torch.isfinite(eng._state.image).all())


def test_no_host_traffic_refuses_a_read(small):
    """The patches do catch a host read in a program."""
    drops = small._state.drops
    with no_host_traffic(), pytest.raises(AssertionError, match="__int__"):
        int(drops[0])
    for index in (drops.argmax(), drops > 0, [0, 1]):
        with no_host_traffic(), pytest.raises(AssertionError,
                                              match="read or uploaded"):
            drops[index]


# ------------------------------------------------ one program per decision
def test_one_map_program_serves_every_slot():
    """Six slots at interval 1: 13 frames wrap the round-robin cursor twice
    through the one program ``("frame", "map")``. Each frame's image, world
    hash and four shadow tables equal those of the same frame run eagerly
    through ``program_function`` on a second engine whose packed inputs
    and slot are written by hand; the cursor and the tick count the frames.
    A map program run on a state built from the public views (as the
    benchmark's bound run builds one, without a slot) leaves the schedule
    where it was."""
    kw = dict(SMALL, shadow_slots=6, shadow_update_interval=1)
    eng = TS.build_space_engine(device="cpu", **kw)
    ref = TS.build_space_engine(device="cpu", **kw)
    for e in (eng, ref):
        e.config.record_history = False
    fn, st = ref.program_function(("frame", "map")), ref._state
    prev = np.zeros(NUM_KEYS, bool)
    for i in range(13):
        # the two spot lights move, so each refresh shows in its slot's
        # light matrix
        w = eng.world
        w["position"][:2] += 1.0
        eng.world = w
        st.world["position"][:2] += 1.0
        img = eng.frame(_inputs(TInput, i), DT)
        inputs = _inputs(TInput, i).with_prev(prev)
        prev = np.asarray(inputs.keys, bool)
        st.packed.copy_(torch.from_numpy(inputs.pack_with_dt(DT)))
        st.slot.fill_(i % 6)
        fn(st)
        sh = eng.shadow_state
        assert torch.equal(img, st.image), i
        assert world_hash(eng.world) == world_hash(st.world), i
        for a, b in zip((sh.maps, sh.light_mats, sh.slot_entity,
                         sh.slot_face), st.shadow):
            assert torch.equal(a, b), i
        assert (sh.cursor, sh.tick) == (i + 1, i + 1)
    assert eng.captured_programs == {("frame", "map")}
    assert st.shadow[2].tolist() == [0, 1, -1, -1, -1, -1]

    sh, camv = eng.shadow_state, eng.camera.serialize().clone()
    bench = E.ProgramState(
        world=eng.world, camv=camv,
        shadow=(sh.maps, sh.light_mats, sh.slot_entity, sh.slot_face),
        packed=torch.as_tensor(_inputs(TInput, 13).pack_with_dt(DT)),
        view=camv.clone(), drops=torch.zeros(6, dtype=torch.int32),
        image=torch.empty(kw["height"], kw["width"], 3))
    eng.program_function(("frame", "map"))(bench)
    assert bench.slot.tolist() == [0.0]
    assert (eng.shadow_state.cursor, eng.shadow_state.tick) == (13, 13)
    assert torch.isfinite(bench.image).all()


# ------------------------------------------------------------ invalidation
def _kept(before, which):
    if which == "all":
        return set()
    if which == "render":
        return {k for k in before if k[0] == "step"}
    return set(before)


def _drive(eng):
    eng.frame(_inputs(TInput, 0), DT)
    eng.frame(_inputs(TInput, 1), DT, advance="step")
    eng.render()


def _toggle_determinism(eng):
    torch.use_deterministic_algorithms(
        not torch.are_deterministic_algorithms_enabled())


# event -> (the programs it drops, what runs before the programs are
# captured, the event)
EVENTS = {
    "finalize_scene": ("all", None, lambda e: e.finalize_scene()),
    "set_window": ("all", None, lambda e: e.set_window(96, 16)),
    "set_draw_distances": ("all", None,
                           lambda e: e.set_draw_distances(draw_distance=900)),
    "deterministic_algorithms": ("all", None, _toggle_determinism),
    "set_render_systems": ("render", None, lambda e: e.set_render_systems(
        lambda bank: e.config.render_systems(bank))),
    "set_skybox": ("render", None, lambda e: e.set_skybox(
        SB.make_starfield(64, device="cpu"))),
    "set_atlas": ("render", None, lambda e: e.set_atlas(copy.copy(e.atlas))),
    "compiled_systems": ("render", None, lambda e: setattr(
        e, "compiled_systems", copy.copy(e.compiled_systems))),
    "render_settings": ("render", None, lambda e: setattr(
        e.config, "render", dataclasses.replace(e.config.render,
                                                texture_tile_budget=1.0))),
    "reset": ("none", None, lambda e: e.reset()),
    "reset_after_set_window": ("all", lambda e: e.set_window(96, 16),
                               lambda e: e.reset()),
}


@pytest.mark.parametrize("event", list(EVENTS))
def test_events_drop_their_programs(event):
    which, setup, act = EVENTS[event]
    eng = TS.build_space_engine(device="cpu", **SMALL)
    eng.config.record_history = False
    if setup is not None:
        setup(eng)
    _drive(eng)
    before = eng.captured_programs
    assert {("step",), ("frame", "map"), ("render_shadowed", "skip")} <= \
        before
    assert any(k[0] == "render" for k in before)
    prev = torch.are_deterministic_algorithms_enabled()
    try:
        act(eng)
        assert eng.captured_programs == _kept(before, which)
    finally:
        torch.use_deterministic_algorithms(prev)


def test_new_window_renders_at_its_size():
    eng = TS.build_space_engine(device="cpu", **SMALL)
    eng.config.record_history = False
    assert eng.frame(_inputs(TInput, 0), DT).shape == (32, 128, 3)
    eng.set_window(96, 16)
    assert eng.captured_programs == frozenset()
    img = eng.frame(_inputs(TInput, 1), DT)
    assert img.shape == (16, 96, 3) and bool(torch.isfinite(img).all())
    assert eng.render().shape == (16, 96, 3)


def test_recorded_events_replay_twice_on_one_engine(tmp_path):
    eng = TS.build_space_engine(device="cpu", **SMALL)
    eng.config.history_dir = str(tmp_path)
    eng.reset()
    live = []
    for i in range(6):
        if i == 2:
            eng.set_window(96, 16)
        if i == 4:
            eng.set_draw_distances(draw_distance=900.0)
        img = eng.frame(_inputs(TInput, i), DT, render=i != 3)
        live.append((world_hash(eng.world), img))
    eng.flush_history()
    eng2 = TS.build_space_engine(device="cpu", **SMALL)
    eng2.config.record_history = False
    runs = []
    for _ in range(2):
        eng2.reset()
        player = Player(eng2, HistoryLog.load(str(tmp_path)))
        run = []
        for i in range(6):
            img, _ = player.step(render=i != 3)
            run.append((world_hash(eng2.world), img))
        runs.append(run)
        assert eng2.camera.draw_distance == 900.0
        assert (eng2.config.render.width, eng2.config.render.height) == (
            96, 16)
    for a, b, c in zip(live, *runs):
        assert a[0] == b[0] == c[0]
        assert (a[1] is None) == (b[1] is None) == (c[1] is None)
        if a[1] is not None:
            assert torch.equal(a[1], b[1]) and torch.equal(b[1], c[1])


def test_run_frames_keeps_a_mid_burst_overflow():
    """28 slots hold the 26 fixed entities and two free; the mine producer
    fires every 4 s at dt 1 s, so the third spawn (frame 11) finds no slot
    and frame 12 drops nothing."""
    kw = dict(width=64, height=16, capacity=28, num_asteroids=20,
              max_tris=2048, spawn_budget=2)
    n = 13
    tin = [_inputs(TInput, i, seed=i) for i in range(n)]
    loop = TS.build_space_engine(device="cpu", **kw)
    loop.config.record_history = False
    per_frame = []
    for inp in tin:
        loop.frame(inp, 1.0, render=False, advance="step")
        per_frame.append(unpack_drop_stats(loop._last_drops)["spawn_dropped"])
    assert per_frame[-1] == 0 and max(per_frame) > 0
    burst = TS.build_space_engine(device="cpu", **kw)
    burst.config.record_history = False
    assert burst.run_frames(tin, [1.0] * n) is None
    jeng = _jax_engine(kw)
    jeng.run_frames([_inputs(JInput, i, seed=i) for i in range(n)],
                    [1.0] * n)
    got = unpack_drop_stats(burst._last_drops)
    assert got == j_drops(jeng._last_drops)
    assert got["spawn_dropped"] == max(per_frame)
    assert world_hash(burst.world) == world_hash(loop.world)
