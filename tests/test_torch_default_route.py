"""The JAX package's default render route, ``RenderSettings(fused_shading=
False)``, in the port: the non-fused tiled frame (K1, the tall G-buffers
of both layers over every tile, ``tall_gbuffer``, and the shading stage)
taken by ``render_frame`` without a
callback, its shadows from the shadow maps (``shadows.make_shadow_factor``),
and the Engine's programs on that route.

* Frames against the JAX package's ``backend="pallas",
  fused_shading=False`` frame (interpret mode, its shadow raster patched to
  the Pallas path as tests/test_torch_nonfused.py does): the frame scene of
  tests/test_torch_frame.py, its "featured" variant (every texture role),
  the point light's shadow maps of tests/test_torch_shadow_frame.py, the
  textured scene 200 pixels wide (a partial last tile column), the "lit"
  scene of tests/deferred_scenes.py (textures with spec and normal maps
  under six shadow slots: a directional light's map, a spot light's and
  four cube faces of a point light; light tables with dead rows of every
  kind) at ``pcf_scale`` 1 and 3, 32 and 44 rows high, so that the PCF
  blocks cross tile rows, and the featured scene with a fragment-shading
  system (the shading stage hands it the textured G-buffers).
  Tolerance: max abs diff <= 2/255 and at most 0.1% of the u8 values
  differing, as the fused frame is held; the lit scene every channel
  within 1e-3 instead. Its eleven live lights, some a few units from the
  surfaces, carry the G-buffers' position noise (1e-5 relative against
  JAX, near 64) into differences up to about 2.3e-4, which turn about
  0.1% of the u8 values over a rounding step; a channel off by 1e-3 or
  more, as a PCF tap, a texel or a light row of its own would give, fails.
* The default route with a ``shadow_state`` ``torch.equal`` to the frame
  with the callback the golden path builds from it (the route before this
  setting existed); ``backend="pallas"`` ``torch.equal`` to ``"auto"`` on
  both routes; an unknown backend raises.
* A 128x32 demo engine (10 asteroids, 128^2 shadow maps, an update every
  3 frames over 2 slots, one frame of 4.5 s that fires the mine spawner)
  with ``fused_shading=False``, 4 frames against the JAX Engine with the
  same configuration: integer columns, the shadow schedule and every drop
  counter exact; float columns rtol 1e-5 / atol 1e-4 (tests/
  test_torch_programs.py's limits); images at the 2/255 limit. Its program
  functions run under ``host_traffic.no_host_traffic`` (the CPU's stand-in
  for a CUDA graph's capture); a recorded session replays bit for bit;
  toggling ``fused_shading`` drops the programs that render.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.math.camera import CameraBuilder as JCameraBuilder
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.render import render_system as RSJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu.runtime.engine import Engine as JEngine
from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.logic.types import InputState as TInput
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import raster_pallas as RPT
from render_engine_tpu_torch.render import render_system as RST
from render_engine_tpu_torch.render import shade_pallas as SPT
from render_engine_tpu_torch.render import tall_gbuffer as TG
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT
from render_engine_tpu_torch.runtime.config import EngineConfig
from render_engine_tpu_torch.runtime.history import HistoryLog
from render_engine_tpu_torch.runtime.replay import Player
from render_engine_tpu_torch.utils.hashing import world_hash

import deferred_scenes as DSC
import test_torch_partial_tiles as TPT
import test_torch_render_systems as TRS
from host_traffic import no_host_traffic
from test_torch_frame import JAX_PK, RASTER, TORCH_PK, build
from test_torch_nonfused import pallas_shadows, shadowed  # noqa: F401
from test_torch_nonfused import (assert_images_close, scene, settings,
                                 shadows_of)
from test_torch_programs import SMALL, _columns, _inputs, _kept
from test_torch_shadows import JAX, TORCH, assert_state_close
from torch_threads import one_torch_thread  # noqa: F401

SCENES = ["plain", "featured"]
# the lit scene's cases: pcf_scale, width, height, extra point lights
LIT = {"k1-128x32": (1, 128, 32, 7), "k3-128x32": (3, 128, 32, 7),
       "k3-200x44": (3, 200, 44, 2)}
# frames 0 and 3 render maps into slots 0 and 1, 1 and 2 skip; frame 2
# fires the mine spawner
DTS = (1 / 60, 1 / 30, 4.5, 1 / 60)


def default(st, **kw):
    """The port's settings on the default route."""
    return dataclasses.replace(st, fused_shading=False, **kw)


@pytest.fixture
def counted(monkeypatch):
    """The tile counts of each layer the tall G-buffers resolve, frame
    after frame; K3 refused."""
    resolved = []
    real = TG.tall_gbuffer

    def spy(layers, *a, **kw):
        resolved.extend(slot.shape[0] for slot, _, _ in layers)
        return real(layers, *a, **kw)

    def no_k3(*a, **kw):
        raise AssertionError("K3 ran on the default route")

    monkeypatch.setattr(TG, "tall_gbuffer", spy)
    monkeypatch.setattr(SPT, "shade_tiles", no_k3)
    return resolved


def test_default_settings_are_the_reference_default():
    assert FT.RenderSettings().fused_shading is FJ.RenderSettings(
    ).fused_shading is False
    assert "pallas" in FT.BACKENDS
    assert FT.RenderSettings(fused_shading=True) != FT.RenderSettings()
    assert hash(FT.RenderSettings(fused_shading=True)) != hash(
        FT.RenderSettings())


@pytest.mark.parametrize("name", SCENES)
def test_default_frame_matches_reference(name, counted):
    wj, bj, cj, aj = scene(JAX_PK, name)
    wt, bt, ct, at = scene(TORCH_PK, name)
    sj, st = settings()
    img_t = FT.render_frame(wt, ct, bt, default(st), atlas=at)
    nt = -(-st.width // st.raster.tile_w) * -(-st.height // st.raster.tile_h)
    assert counted == [nt, nt]
    assert_images_close(img_t, FJ.render_frame(wj, cj, bj, sj, atlas=aj))
    assert float(img_t.max()) > 0.9


def test_shadowed_default_frame_matches_reference(shadowed, counted):
    wt, bt, ct, sht = shadowed["t"]
    wj, bj, cj, shj = shadowed["j"]
    sj, st = settings()
    img_t = FT.render_frame(wt, ct, bt, default(st), shadow_state=sht)
    assert len(counted) == 2
    assert_images_close(img_t, FJ.render_frame(wj, cj, bj, sj,
                                               shadow_state=shj))
    # the maps shade the frame
    assert not torch.equal(img_t, FT.render_frame(wt, ct, bt, default(st)))


def test_default_frame_on_a_partial_tile():
    width, height = 200, 48
    wj, bj, cj, aj = build(JAX_PK, True)
    wt, bt, ct, at = build(TORCH_PK, True)
    cj = TPT.with_aspect(cj, width, height)
    ct = TPT.with_aspect(ct, width, height)
    sj, st = TPT.settings(width, height)
    sj = dataclasses.replace(sj, fused_shading=False)
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, sj, atlas=aj))
    img_t = FT.render_frame(wt, ct, bt, default(st), atlas=at)
    TPT.assert_images_close(img_t, img_j, width, height)
    assert (img_t[:, 128:] > 0.05).any()


@pytest.fixture(scope="module", params=list(LIT))
def lit(request):
    """The lit scene in both packages with its six shadow slots, each
    package's maps rendered by itself; ten point-light rows (the shadowed
    head of four and a chunk of six)."""
    k, width, height, extra = LIT[request.param]
    mp = pytest.MonkeyPatch()
    mp.setattr(FJ, "pick_rasterizer",
               lambda backend="auto": RPJ.rasterize_depth_winner_pallas)
    try:
        out = {}
        for name, pk, ns in (("t", TORCH_PK, TORCH), ("j", JAX_PK, JAX)):
            w, bank, cam, atlas = DSC.lit(pk, width / height, extra)
            sh = ns.SH.create_shadow_state(resolution=64,
                                           budget=DSC.LIT_SLOTS,
                                           pcf_scale=k)
            for _ in range(DSC.LIT_SLOTS):
                sh = ns.render(sh, w, cam, bank, max_tris=256,
                               raster_cfg=ns.RC(**RASTER))
            out[name] = (w, bank, cam, atlas, sh)
    finally:
        mp.undo()
    sj = FJ.RenderSettings(width=width, height=height, max_tris=256,
                           backend="pallas", fused_shading=False,
                           raster=RCJ(chunk=4, **RASTER), max_point_lights=10)
    st = FT.RenderSettings(width=width, height=height, max_tris=256,
                           fused_shading=False, raster=RCT(**RASTER),
                           max_point_lights=10)
    return out, sj, st


def test_lit_default_frame_matches_reference(lit, counted):
    out, sj, st = lit
    wt, bt, ct, at, sht = out["t"]
    wj, bj, cj, aj, shj = out["j"]
    assert sht.slot_entity.tolist() == [0, 1, 2, 2, 2, 2]
    assert np.asarray(shj.slot_entity).tolist() == [0, 1, 2, 2, 2, 2]
    img_t = FT.render_frame(wt, ct, bt, st, atlas=at, shadow_state=sht)
    assert len(counted) == 2
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, sj, atlas=aj,
                                       shadow_state=shj))
    assert tuple(img_t.shape) == img_j.shape
    diff = np.abs(img_t.numpy() - img_j)
    assert diff.max() <= 1e-3, diff.max()
    # the maps shade the frame
    bare = FT.render_frame(wt, ct, bt, st, atlas=at)
    assert (img_t != bare).any(dim=-1).double().mean() > 0.05


def test_custom_shading_default_frame_matches_reference(counted):
    """The featured scene with a fragment-shading system on its cubes:
    the stage textures the G-buffers the function reads."""
    sj, st = settings()

    def systems(rs, bank, shade):
        return rs.compile_systems((
            rs.RenderSystemBuilder("n").with_models(0)
            .write_uniform("tone", 0.8).with_fragment_shading(shade).build(),
            rs.RenderSystemBuilder("s").with_models(1, 2).build()), bank)

    wj, bj, cj, aj = scene(JAX_PK, "featured")
    wt, bt, ct, at = scene(TORCH_PK, "featured")
    sys_t = systems(RST, bt, TRS.fancy)
    img_t = FT.render_frame(wt, ct, bt, default(st), atlas=at, systems=sys_t)
    assert len(counted) == 2
    assert_images_close(img_t, FJ.render_frame(
        wj, cj, bj, sj, atlas=aj, systems=systems(RSJ, bj, TRS.fancy_jnp)))
    # the function shades the cubes' pixels
    plain = FT.render_frame(wt, ct, bt, default(st), atlas=at)
    assert (img_t != plain).any(dim=-1).double().mean() > 0.01


def test_default_frame_equals_the_callback_route(shadowed):
    """The factor built inside the frame is the golden path's callback:
    the frame equals the one rendered with that callback, to the bit."""
    w, bank, cam, sh = shadowed["t"]
    _, st = settings()
    s = default(st)
    got = FT.render_frame(w, cam, bank, s, shadow_state=sh)
    assert torch.equal(got, FT.render_frame(
        w, cam, bank, s, shadow_factor=shadows_of(sh, w, s)))
    # a callback given wins over the maps, as in the JAX package
    assert torch.equal(
        FT.render_frame(w, cam, bank, s, shadow_state=sh,
                        shadow_factor=lambda kind, i, pos: 1.0),
        FT.render_frame(w, cam, bank, s,
                        shadow_factor=lambda kind, i, pos: 1.0))


@pytest.mark.parametrize("fused", [False, True])
def test_pallas_backend_is_auto(shadowed, fused):
    w, bank, cam, sh = shadowed["t"]
    _, st = settings()
    s = dataclasses.replace(st, fused_shading=fused)
    a = FT.render_frame(w, cam, bank, s, shadow_state=sh)
    b = FT.render_frame(w, cam, bank, dataclasses.replace(s,
                                                          backend="pallas"),
                        shadow_state=sh)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="none of"):
        FT.render_frame(w, cam, bank, dataclasses.replace(s, backend="tpu"))


# ------------------------------------------------------------ the Engine
def _jax_engine(kw):
    cfg = JS.space_config(**kw)
    cfg.record_history = False
    cfg.render = dataclasses.replace(cfg.render, backend="pallas",
                                     fused_shading=False)
    cam = (JCameraBuilder().with_position(1000.0, 1000.0, 1150.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(kw["width"] / kw["height"])
           .with_near_far(0.5, 1500.0).with_draw_distance(1500.0).build())
    return JEngine(cfg, camera=cam)


def _port_engine(**kw):
    eng = TS.build_space_engine(device="cpu", **SMALL, **kw)
    eng.config.render = default(eng.config.render)
    return eng


@pytest.fixture(scope="module")
def engines():
    """Both engines on the default route through the frames of DTS."""
    mp = pytest.MonkeyPatch()
    mp.setattr(FJ, "pick_rasterizer",
               lambda backend="auto": RPJ.rasterize_depth_winner_pallas)
    try:
        jeng = _jax_engine(SMALL)
        teng = _port_engine()
        teng.config.record_history = False
        out = []
        for i, dt in enumerate(DTS):
            jimg = np.asarray(jeng.frame(_inputs(JInput, i), dt))
            timg = teng.frame(_inputs(TInput, i), dt).numpy()
            out.append(dict(
                jimg=jimg, timg=timg,
                jw=_columns(jeng.world, True), tw=_columns(teng.world),
                jdrops=jeng.drop_stats(), tdrops=teng.drop_stats(),
                jsh=jax.tree_util.tree_map(np.asarray, jeng.shadow_state),
                tsh=teng.shadow_state))
    finally:
        mp.undo()
    return dict(frames=out, programs=teng.captured_programs)


@pytest.mark.parametrize("frame", range(len(DTS)))
def test_engine_frames_match_reference(engines, frame):
    r = engines["frames"][frame]
    for name, want in r["jw"].items():
        got = r["tw"][name]
        if np.issubdtype(want.dtype, np.floating):
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4,
                                       err_msg=name)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)
    assert r["tdrops"] == r["jdrops"]
    assert_state_close(r["tsh"], r["jsh"])
    assert r["timg"].shape == (SMALL["height"], SMALL["width"], 3)
    assert_images_close(torch.from_numpy(r["timg"]), r["jimg"])


def test_engine_passes_every_schedule_variant(engines):
    assert {("frame", "skip"), ("frame", "map")} <= engines["programs"]
    # the mine spawned by the 4.5 s frame
    assert engines["frames"][2]["tw"]["alive"].sum() == \
        engines["frames"][1]["tw"]["alive"].sum() + 1


@pytest.mark.parametrize("key", [("frame", "map"), ("frame", "skip"),
                                 ("render_shadowed", "map"), ("step",)])
def test_engine_programs_without_host_traffic(key, counted):
    eng = _port_engine()
    eng.config.record_history = False
    eng.frame(_inputs(TInput, 0), 1 / 60)
    eng.render()
    counted.clear()
    fn = eng.program_function(key)
    fn(eng._state)
    with no_host_traffic():
        fn(eng._state)
    assert len(counted) == (0 if key[0] == "step" else 4)
    assert bool(torch.isfinite(eng._state.image).all())


def test_engine_records_and_replays_bit_for_bit(tmp_path):
    eng = _port_engine(is_debugging=True)
    assert eng.config.is_debugging and EngineConfig(
        is_debugging=True).is_debugging
    eng.config.history_dir = str(tmp_path)
    eng.reset()
    live = []
    for i in range(5):
        img = eng.frame(_inputs(TInput, i), 1 / 60 if i == 4 else DTS[i],
                        render=i != 3, advance="step" if i == 1 else None)
        live.append((world_hash(eng.world), img))
    eng.flush_history()
    eng2 = _port_engine()
    eng2.config.record_history = False
    player = Player(eng2, HistoryLog.load(str(tmp_path)))
    for i, (h, img) in enumerate(live):
        got, _ = player.step(render=i != 3)
        assert world_hash(eng2.world) == h
        assert (got is None) == (img is None)
        assert img is None or torch.equal(got, img)


def test_toggling_fused_shading_drops_the_render_programs():
    eng = _port_engine()
    eng.config.record_history = False
    eng.frame(_inputs(TInput, 0), 1 / 60)
    eng.frame(_inputs(TInput, 1), 1 / 60, advance="step")
    eng.render()
    before = eng.captured_programs
    assert {("step",), ("frame", "map"), ("render_shadowed", "skip")} <= \
        before
    eng.config.render = dataclasses.replace(eng.config.render,
                                            fused_shading=True)
    assert eng.captured_programs == _kept(before, "render")
