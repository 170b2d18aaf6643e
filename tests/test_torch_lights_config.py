"""The many-lights deployment (``build_many_lights_engine``: 200 asteroids,
256 point lights from a fixed rig, per-tile light lists of 96 entries on
the fused route) through ``Engine.frame``, on the CPU, against the
benchmark's plain reference of it (``port_bench/reference/lights.py``,
which shades every live light at every covered pixel and takes no list).

The size: 128x240 (the smallest frame with the deployment's shadow
settings: 2 slots, a map every 3rd frame), the rig's 256 lights, shadow
maps of 128^2 for the CPU's time.

Tolerances, each with its reason:

* the program against the reference: the configuration's own limits
  (``world_err``, ``shadow_err``, ``image_err``), as the benchmark's
  check holds every run to them;
* the list route against the dense route (``light_tile_budget`` 0): equal
  to the bit while no tile's list overflows, since a culled light adds
  exactly 0 and the lists keep the table's order;
* the reference's light term against a hand-computed pixel: 1e-6
  relative, float32 against float64 over a dozen operations; beyond the
  radius exactly 0.
"""

import math

import numpy as np
import pytest
import torch

from port_bench import check, manifest
from port_bench.programs import lights as program
from port_bench.programs import space as space_program
from port_bench.reference import frames
from port_bench.reference import lights as RL
from port_bench.reference.programs import lights as reference
from port_bench.traffic import Traffic
from render_engine_tpu_torch.logic.types import InputState
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.render import lighting as LG
from render_engine_tpu_torch.render import shade_pallas as SP
from render_engine_tpu_torch.runtime import profiling as P

from host_traffic import no_host_traffic
from torch_threads import one_torch_thread  # noqa: F401

CONFIG = "lights-720p-256"
SIZE = dict(width=128, height=240, n_lights=256, shadow_resolution=128)
SEED = 4
START = 4  # frames 0 to 3 from the start
MAP = 6  # a map frame (the round robin's first re-render), from a state
STAGES = ["render.geometry", "render.raster", "render.resolve",
          "render.shade", "render.compose"]


def _config(name=CONFIG):
    return manifest.config(manifest.load(), name)


def _inputs(fr):
    return InputState(keys=fr.keys, mouse_delta=fr.mouse_delta,
                      rng_seed=fr.rng_seed)


def _names(report):
    return [s["name"] for s in report["frames"][-1]["spans"]]


@pytest.fixture(scope="module")
def run():
    """The program's frames 0 to ``MAP``, traced: frames 0 to 3 against
    the reference following its own state, frame ``MAP`` against the
    reference from the program's state before it; the images, the
    reference's state after frame 0 and the trace report."""
    cfg = _config()
    eng = program.build(cfg, SEED, "cpu", SIZE)
    eng.set_tracing(True)
    traffic = Traffic(manifest.traffic("coast"), SEED)
    ref = reference.Reference(cfg, SEED, "cpu", SIZE)
    rd = check.Readings()
    rd.add("world_err", check.compare(frames.state_of(eng)["world"],
                                      ref.state()["world"]))
    images, after0 = {}, None
    for i in range(MAP + 1):
        fr = traffic.frame(i)
        if i == MAP:
            ref.load(frames.state_of(eng))
        images[i] = eng.frame(_inputs(fr), fr.dt)
        if i < START or i == MAP:
            ref_img = ref.frame(fr)
            rd.frame(i, frames.state_of(eng), images[i], ref.state(),
                     ref_img, True)
        if i == 0:
            after0 = ref.state()
    return {"cfg": cfg, "eng": eng, "readings": rd, "images": images,
            "after0": after0, "report": eng.trace_report()}


def test_the_frames_are_the_references(run):
    ok, rows = check.judge(run["readings"].values, run["cfg"]["limits"])
    assert ok, (rows, run["readings"].where)
    assert {name for name, _, _ in rows} == set(check.NUMBERS)


def test_the_map_frames_keep_the_stars_in_the_slots(run):
    """Frames 0 and 3 map the two stars (entities 0 and 1, within the 800
    units around the camera), frame 6 maps a star again: no point light
    takes a slot (the reference would raise)."""
    sh = run["eng"].shadow_state
    assert sorted(sh.slot_entity.tolist()) == [0, 1]
    assert int(sh.tick) == MAP + 1


def test_without_the_point_lights_the_image_fails(run):
    """The reference's image after frame 0 with the table's point budget
    at 0 (the spot lights alone) differs from the program's frame on more
    than the image limit's share of pixels: the point lights are shaded."""
    ref = reference.Reference(run["cfg"], SEED, "cpu", SIZE)
    st = run["after0"]
    budget = ref.budget
    spots = RL.frame_image(st["world"], st["camv"], st["shadow"], ref.sc,
                           (budget[0], 0, budget[2]))
    share = check.pixel_share(run["images"][0], spots)
    assert share > run["cfg"]["limits"]["image_err"], share


def test_lists_equal_the_dense_loop():
    """The same frames at ``light_tile_budget`` 0 (K3 over every live
    light): equal to the bit, no list having overflowed."""
    cfg = _config()
    images = {}
    for budget in (cfg["lights"]["light_tile_budget"], 0):
        eng = program.build(cfg, SEED + 1, "cpu",
                            dict(SIZE, light_tile_budget=budget))
        traffic = Traffic(manifest.traffic("coast"), SEED + 1)
        out = []
        for i in range(2):
            fr = traffic.frame(i)
            out.append(eng.frame(_inputs(fr), fr.dt))
        if budget:
            assert int(eng.render_drop_stats()["light_tile_overflow"]) == 0
        images[budget] = out
    for a, b in zip(*images.values()):
        assert torch.equal(a, b)


def test_the_point_term_is_the_formula():
    """A point light's term at one pixel against the formula worked out in
    float64: Blinn-Phong over the albedo, attenuation 1 / (1 + l d +
    q d^2); beyond the radius exactly 0."""
    pos = torch.tensor([[10.0, 2.0, -3.0]])
    n = torch.nn.functional.normalize(torch.tensor([[0.3, 1.0, 0.2]]),
                                      dim=-1)
    eye = torch.tensor([14.0, 9.0, 5.0])
    v = torch.nn.functional.normalize(eye - pos, dim=-1)
    albedo = torch.tensor([[0.45, 0.38, 0.33]])
    spec_k = torch.tensor([0.7])
    light = {"position": torch.tensor([12.0, 8.0, -1.0]),
             "light_direction": torch.zeros(3),
             "light_diffuse": torch.tensor([0.9, 0.5, 0.2]),
             "light_specular": torch.tensor([0.3, 0.3, 0.3]),
             "light_ambient": torch.tensor([0.02, 0.03, 0.04]),
             "light_atten": torch.tensor([0.05, 0.01]),
             "light_cutoff": torch.zeros(2),
             "light_radius": torch.tensor(40.0)}

    d64 = lambda t: t.double().numpy()  # noqa: E731
    p, nn_, vv, a = d64(pos[0]), d64(n[0]), d64(v[0]), d64(albedo[0])
    to = d64(light["position"]) - p
    dist = math.sqrt(to @ to)
    ld = to / dist
    att = 1.0 / (1.0 + 0.05 * dist + 0.01 * dist * dist)
    ndl = max(nn_ @ ld, 0.0)
    h = (ld + vv) / np.linalg.norm(ld + vv)
    spec = max(nn_ @ h, 0.0) ** 64.0 * 0.7
    want = (d64(light["light_ambient"]) * a
            + d64(light["light_diffuse"]) * ndl * a
            + d64(light["light_specular"]) * spec)
    s, c = RL.term(RL.SORTABLE_POINT, light, pos, n, v, albedo, spec_k)
    assert ndl > 0 and spec > 1e-4  # every term of the formula counts
    np.testing.assert_allclose(d64((s * c)[0]), att * want, rtol=1e-6)
    # beyond the radius
    far = dict(light, light_radius=torch.tensor(dist * 0.99))
    s, c = RL.term(RL.SORTABLE_POINT, far, pos, n, v, albedo, spec_k)
    assert float(s) == 0.0 and torch.equal(s * c, torch.zeros_like(c))
    # a radius of 0 has no cutoff
    none = dict(light, light_radius=torch.tensor(0.0))
    s, _ = RL.term(RL.SORTABLE_POINT, none, pos, n, v, albedo, spec_k)
    assert float(s) == pytest.approx(att, rel=1e-6)


def test_a_traced_frame_reports_the_lists(run):
    """``render.lights`` between ``render.resolve`` and ``render.shade``,
    under ``render``; ``tile_light_pairs`` the lists' summed counts;
    ``light_tile_overflow`` 0 among the render drop counters, as the
    Engine's re-run counts it."""
    report, eng = run["report"], run["eng"]
    names = _names(report)
    assert [n for n in names if n.startswith("render")] == [
        "render", "render.geometry", "render.raster", "render.resolve",
        "render.lights", "render.shade", "render.compose"]
    call = report["frames"][-1]
    sp = call["spans"][names.index("render.lights")]
    assert call["spans"][sp["parent"]]["name"] == "render"
    c = report["counters"]
    assert c["render_drops"]["light_tile_overflow"] == 0
    assert int(eng.render_drop_stats()["light_tile_overflow"]) == 0
    # the lists of the state's camera and lights, counted afresh
    r = eng.config.render
    cam = eng.camera
    la = LG.extract_lights(eng.world, max_dir=r.max_dir_lights,
                           max_point=r.max_point_lights,
                           max_spot=r.max_spot_lights)
    ltab, n_live = SP.pack_lights(la, r.max_dir_lights + r.max_point_lights
                                  + r.max_spot_lights)
    tiles_x, tiles_y = -(-r.width // 128), -(-r.height // 8)
    _, tcount, dropped = SP.select_tile_lights(
        ltab, n_live, cam.position, T.inv44(cam.proj_view()), tiles_x,
        tiles_y, 8, 128, r.width, r.height, 0.0, r.light_tile_budget)
    assert int(dropped) == 0 and int(n_live) == 258
    assert c["tile_light_pairs"] == int(tcount.sum())
    # the lists cull: fewer pairs than every tile with every light
    assert 0 < c["tile_light_pairs"] < tiles_x * tiles_y * int(n_live)


def test_a_starved_budget_counts_its_drops():
    cfg = _config()
    eng = program.build(cfg, SEED, "cpu", dict(SIZE, light_tile_budget=4))
    eng.set_tracing(True)
    fr = Traffic(manifest.traffic("coast"), SEED).frame(0)
    eng.frame(_inputs(fr), fr.dt)
    c = eng.trace_report()["counters"]
    dropped = c["render_drops"]["light_tile_overflow"]
    assert dropped > 0
    assert dropped == int(eng.render_drop_stats()["light_tile_overflow"])
    tiles = -(-SIZE["width"] // 128) * -(-SIZE["height"] // 8)
    assert 0 < c["tile_light_pairs"] <= 4 * tiles


def test_a_space_frame_keeps_its_spans():
    """Lists off (the headline configuration): no ``render.lights`` span,
    no list counter, the fused frame's spans and drop counters as
    before."""
    cfg = _config("space-1080p-10k")
    small = dict(width=128, height=32, capacity=128, num_asteroids=10,
                 shadow_resolution=128, shadow_max_tris=1024)
    eng = space_program.build(cfg, SEED, "cpu", small)
    eng.set_tracing(True)
    fr = Traffic(manifest.traffic("coast"), SEED).frame(0)
    eng.frame(_inputs(fr), fr.dt)
    report = eng.trace_report()
    assert [n for n in _names(report) if n.startswith("render")] == [
        "render"] + STAGES
    c = report["counters"]
    assert "tile_light_pairs" not in c
    assert set(c["render_drops"]) == {"triangle_budget_dropped",
                                      "tile_candidate_dropped"}


def test_the_frame_reads_and_uploads_nothing_on_the_host(run):
    """The frame program with the lists and their counters, traced, as a
    capture would run it: no host read, no upload."""
    eng = run["eng"]
    fn = eng.program_function(("frame", "skip"))
    marks = P.ProgramMarks(False, "frame")
    with no_host_traffic(), marks.recording():
        fn(eng._state)
    c = marks.counters()
    assert c["tile_light_pairs"] > 0 and c["light_tile_overflow"] == 0


def test_the_configuration_states_its_deployment():
    """The file: the source's own sizes (nothing reduced), the settings
    ``build_many_lights_engine`` gives at full size (the program's build
    refuses any other), the rig the reference draws, and limits with
    their readings."""
    b = manifest.load()
    entry = next(c for c in b["configs"] if c["name"] == CONFIG)
    cfg = _config()
    assert entry["reduced"] == [] == cfg["reduced"]
    assert cfg["program"] == "lights" and cfg["source"] == entry["source"]
    assert set(cfg["limits_why"]) == set(cfg["limits"]) == set(check.NUMBERS)
    assert {"scene_seed", "light_rig"} <= set(cfg["assumed"])
    cell = manifest.cell(b, f"{CONFIG}.coast")
    assert cell["chips"] == 1 and cell["traffic"] == "coast"
    eng = program.build(cfg, 11, "cpu")  # no frame: the build alone
    w = eng.world
    rig = RL.rig(cfg["lights"])
    ids = torch.nonzero(w.sortable_mask(RL.SORTABLE_POINT)).flatten()
    assert len(ids) == cfg["lights"]["count"] == 256
    for name, want in rig.items():
        assert torch.equal(w[name][ids], torch.as_tensor(want)), name
    ref = reference.Reference(cfg, 11, "cpu")
    assert check.compare(frames.state_of(eng)["world"],
                         ref.state()["world"]) == 0.0
    # 4 + 256 + 8 rows, 258 of them live
    assert RL.budgets(cfg["lights"]) == (4, 256, 8)
    assert len(RL.table(ref.world, ref.budget)) == 258
