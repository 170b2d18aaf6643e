"""The demo's render systems as a user writes them
(``demo/user_systems.py``: ``fog_rim`` on the lit system, a draw callback
on the light sources) through ``Engine.frame``, on the CPU, against the
benchmark's plain reference of them (``port_bench/reference/custom.py``).

The size: 192x144 with 4,000 asteroids in the demo's wide shell, so that
the lit system owns some 1% of the pixels and a wrong material moves more
than the image limit's share of them (the demo's 20 asteroids at 128x96
own 0.14%, under the limit of 0.1% of pixels changed by any material).

* the world, the shadow maps and the image after 3 frames from the start
  and after one frame from the program's state, within the
  configuration's limits; the same frames against the reference with its
  ``fog_density`` times 1.1, and against the ``space`` reference (no
  material), fail the image limit;
* the trace report's custom-shading counters against the reference's
  count of owned pixels; the ``render.custom`` span only in a program
  with a shading system, on the fused and the default route; the
  coast configuration's spans as before;
* the systems reach the Engine through ``set_render_systems`` and run
  with no host read or upload; ``fog_rim`` is the formula.
"""

import copy
import os

import pytest
import torch

from port_bench import check, manifest
from port_bench.programs import custom as program
from port_bench.programs import space as space_program
from port_bench.reference import frames
from port_bench.reference.programs import custom as reference
from port_bench.reference.programs import space as space_reference
from port_bench.traffic import Traffic
from render_engine_tpu_torch.demo import user_systems as U
from render_engine_tpu_torch.logic.types import InputState
from render_engine_tpu_torch.math.camera import CameraBuilder
from render_engine_tpu_torch.render.render_system import ShadeParam
from render_engine_tpu_torch.runtime import profiling as P

from host_traffic import no_host_traffic
from torch_threads import one_torch_thread  # noqa: F401

SIZE = dict(width=192, height=144, capacity=4096, num_asteroids=4000,
            shadow_resolution=128, shadow_max_tris=1024)
SEED = 3
CONFIG = "space-1080p-10k-custom"
START = 3  # frames from the start; then one from the program's state
STAGES = ["render.geometry", "render.raster", "render.resolve",
          "render.shade", "render.compose"]


def _config(name=CONFIG):
    return manifest.config(manifest.load(), name)


def _inputs(fr):
    return InputState(keys=fr.keys, mouse_delta=fr.mouse_delta,
                      rng_seed=fr.rng_seed)


def _names(report):
    call = report["frames"][-1]
    return [s["name"] for s in call["spans"]]


@pytest.fixture(scope="module")
def run():
    """The program's first ``START`` frames and one more from its state,
    each against the reference, the reference with a denser fog and the
    ``space`` reference; the trace report after the last frame."""
    cfg = _config()
    fog = copy.deepcopy(cfg)
    fog["material"]["fog_density"] *= 1.1
    eng = program.build(cfg, SEED, "cpu", SIZE)
    eng.set_tracing(True)
    traffic = Traffic(manifest.traffic("coast"), SEED)
    refs = {"reference": reference.Reference(cfg, SEED, "cpu", SIZE),
            "denser fog": reference.Reference(fog, SEED, "cpu", SIZE),
            "space": space_reference.Reference(cfg, SEED, "cpu", SIZE)}
    readings = {k: check.Readings() for k in refs}
    for i in range(START + 1):
        fr = traffic.frame(i)
        if i == START:
            pre = frames.state_of(eng)
            for r in refs.values():
                r.load(pre)
        img = eng.frame(_inputs(fr), fr.dt)
        post = frames.state_of(eng)
        for k, r in refs.items():
            ref_img = r.frame(fr)
            readings[k].frame(i, post, img, r.state(), ref_img, True)
    return {"cfg": cfg, "eng": eng, "refs": refs, "readings": readings,
            "report": eng.trace_report()}


def test_the_frames_are_the_references(run):
    ok, rows = check.judge(run["readings"]["reference"].values,
                           run["cfg"]["limits"])
    assert ok, rows
    assert {name for name, _, _ in rows} == set(check.NUMBERS)


@pytest.mark.parametrize("other", ["denser fog", "space"])
def test_another_material_fails_the_image_limit(run, other):
    values = run["readings"][other].values
    limits = run["cfg"]["limits"]
    # the world and the maps are the same: only the image tells
    assert values["world_err"] <= limits["world_err"]
    assert values["shadow_err"] <= limits["shadow_err"]
    assert values["image_err"] > limits["image_err"], values


def test_the_counters_count_what_the_reference_owns(run):
    c = run["report"]["counters"]
    nt = -(-SIZE["height"] // 8) * -(-SIZE["width"] // 128)
    assert c["custom_tiles_resolved"] == 2 * nt
    assert 0 < c["custom_tiles_owned"] <= c["custom_tiles_resolved"]
    layers = run["refs"]["reference"].last["layers"]
    owned = sum(int(((la["system"] == 0) & la["covered"]).sum())
                for la in layers)
    assert c["custom_pixels"] == owned > 0
    # the drop counters keep their own key
    assert set(c["render_drops"]) == {"triangle_budget_dropped",
                                      "tile_candidate_dropped"}


def test_the_custom_span_follows_the_shade_span(run):
    names = _names(run["report"])
    i = names.index("render.custom")
    assert names[i - 1:i + 2] == ["render.shade", "render.custom",
                                  "render.compose"]
    call = run["report"]["frames"][-1]
    sp = call["spans"][i]
    assert call["spans"][sp["parent"]]["name"] == "render"


def test_the_coast_configuration_keeps_its_spans():
    """No shading system: no ``render.custom`` span, no custom counter;
    the spans are the fused frame's as before."""
    cfg = _config("space-1080p-10k")
    small = dict(width=128, height=32, capacity=128, num_asteroids=10,
                 shadow_resolution=128, shadow_max_tris=1024)
    eng = space_program.build(cfg, SEED, "cpu", small)
    eng.set_tracing(True)
    fr = Traffic(manifest.traffic("coast"), SEED).frame(0)
    eng.frame(_inputs(fr), fr.dt)
    report = eng.trace_report()
    render = [n for n in _names(report) if n.startswith("render")]
    assert render == ["render"] + STAGES
    assert not set(report["counters"]) & {"custom_tiles_resolved",
                                          "custom_tiles_owned",
                                          "custom_pixels"}


def test_the_default_route_marks_its_custom_shading():
    cfg = dict(_config(), fused_shading=False)
    small = dict(width=128, height=32, capacity=128, num_asteroids=10,
                 shadow_resolution=128, shadow_max_tris=1024)
    eng = program.build(cfg, SEED, "cpu", small)
    eng.set_tracing(True)
    fr = Traffic(manifest.traffic("coast"), SEED).frame(0)
    eng.frame(_inputs(fr), fr.dt)
    render = [n for n in _names(eng.trace_report()) if n.startswith("render")]
    assert render == ["render", "render.geometry", "render.raster",
                      "render.shade", "render.custom", "render.compose"]


def test_the_systems_come_through_the_users_path(run):
    eng = run["eng"]
    assert callable(eng.config.render_systems)
    lit, sources = eng.compiled_systems.src
    assert lit.shade is U.fog_rim and sources.draw is not None
    assert lit.draw is None and sources.shade is None
    assert dict(lit.uniforms) == {
        k: tuple(v) if isinstance(v, list) else v
        for k, v in run["cfg"]["material"].items()}
    assert not sources.lit and sources.emissive_boost == 6.0


def test_the_frame_reads_and_uploads_nothing_on_the_host(run):
    """The frame program with the user's systems, traced, as a capture
    would run it: no host read, no upload."""
    eng = run["eng"]
    fn = eng.program_function(("frame", "map"))
    marks = P.ProgramMarks(False, "frame")
    with no_host_traffic(), marks.recording():
        fn(eng._state)
    assert marks.counters()["custom_pixels"] > 0


def test_fog_rim_is_the_formula():
    torch.manual_seed(0)
    pos = torch.randn(5, 4, 3) * 300.0
    nrm = torch.nn.functional.normalize(torch.randn(5, 4, 3), dim=-1)
    base = torch.rand(5, 4, 3)
    cam = CameraBuilder().with_position(10.0, -20.0, 30.0).build()
    sp = ShadeParam(position=pos, normal=nrm, albedo=base,
                    depth=torch.zeros(5, 4),
                    material=torch.zeros(5, 4, dtype=torch.int32),
                    covered=torch.ones(5, 4, dtype=torch.bool),
                    base_color=base, camera=cam, lights=None,
                    uniforms=dict(U.MATERIAL))
    m = U.MATERIAL
    c = cam.position.double()
    d = torch.linalg.vector_norm(c - pos.double(), dim=-1, keepdim=True)
    v = (c - pos.double()) / d
    f = torch.exp(-m["fog_density"] * d)
    rim = torch.tensor(m["rim_color"], dtype=torch.float64) * (
        1.0 - (nrm.double() * v).sum(-1, keepdim=True).clamp(min=0.0)
    ) ** m["rim_power"]
    want = (f * (base.double() + rim) + (1.0 - f) * torch.tensor(
        m["fog_color"], dtype=torch.float64)).clamp(0.0, 1.0)
    torch.testing.assert_close(U.fog_rim(sp).double(), want, rtol=0,
                               atol=1e-5)
    # the reference's shader is the same function
    from port_bench.reference import custom as RC

    torch.testing.assert_close(RC.fog_rim(base, pos, nrm, cam.position, m),
                               U.fog_rim(sp), rtol=0, atol=1e-6)


def test_repeated_counts_add_up():
    marks = P.ProgramMarks(False)
    with marks.recording():
        P.count("n", torch.tensor(3))
        P.count("n", torch.tensor(4))
        P.count("over", torch.tensor(5), over=7)
    assert marks.counters() == {"n": 7, "over": 0}


def test_the_configuration_states_its_deployment():
    b = manifest.load()
    entry = next(c for c in b["configs"] if c["name"] == CONFIG)
    cfg = _config()
    assert entry["reduced"] == [] == cfg["reduced"]
    assert cfg["program"] == "custom" and cfg["source"] == entry["source"]
    base = _config("space-1080p-10k")
    for k in ("space_config", "scene", "fused_shading", "record_history",
              "precision"):
        assert cfg[k] == base[k], k
    assert {k: tuple(v) if isinstance(v, list) else v
            for k, v in cfg["material"].items()} == U.MATERIAL
    assert {"material", "scene_seed"} <= set(cfg["assumed"])
    assert set(cfg["limits_why"]) == set(cfg["limits"]) == set(check.NUMBERS)
    assert os.path.exists(os.path.join(manifest.ROOT, entry["file"]))
