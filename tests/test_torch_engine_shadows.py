"""The port's headline frame with shadows: the space engine's frames (step,
shadow-map update, shadowed tiled fused render) in render_engine_tpu_torch
against the JAX package's, on the CPU at the demo test size (128x32, 10
asteroids; the demo's small-target shadow settings: 128^2 maps, 6 slots,
an update every frame).

The JAX engine runs its Pallas kernels in interpret mode
(``backend="pallas"``); its shadow raster, which picks the jnp golden path
on the CPU, is patched for these engines to ``rasterize_depth_winner_pallas``
(interpret mode), the path the port takes.

Tolerances, as in tests/test_torch_engine.py: world columns rtol 1e-5 /
atol 1e-4, the camera vector 1e-5, integer state and every drop counter
(the 6 step and 7 render counters) exact, images within 2/255 with at most
0.1% of u8 values differing. The shadow state as in
tests/test_torch_shadows.py: schedule exact, light_mats 1e-5, maps within
1e-5 where both cover a texel with at most 0.5% of texels differing in
coverage.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.logic.types import KEY_W
from render_engine_tpu.math.camera import CameraBuilder as JCameraBuilder
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.runtime.engine import Engine as JEngine

from render_engine_tpu_torch import convert
from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.logic.types import InputState as TInput
from render_engine_tpu_torch.render.frame import render_frame, to_srgb_u8

from test_torch_shadows import assert_state_close

KW = dict(width=128, height=32, capacity=128, num_asteroids=10,
          max_tris=2048)
DT = 1.0 / 60.0
DROP_KEYS = {
    "collision_cell_dropped", "collision_large_dropped",
    "collision_pair_dropped", "collision_query_dropped", "oob_killed",
    "spawn_dropped", "triangle_budget_dropped", "tile_candidate_dropped",
    "texture_tile_overflow", "shadow_triangle_dropped",
    "shadow_caster_outside_volume", "shadow_tile_candidate_dropped",
    "shadow_tile_overflow"}


def _inputs(cls, i):
    base = cls.idle(i)
    if i == 1:
        return base.with_keys(KEY_W)
    if i >= 2:
        return dataclasses.replace(
            base, keys=np.array(base.with_keys(KEY_W).keys),
            mouse_delta=np.array([0.02, -0.01], np.float32))
    return base


@pytest.fixture(scope="module")
def runs():
    """The JAX and port engines, shadows on, driven through 4 frames;
    per-frame snapshots (the JAX programs are traced here, with its shadow
    raster patched)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(FJ, "pick_rasterizer",
               lambda backend="auto": RPJ.rasterize_depth_winner_pallas)
    try:
        cfg = JS.space_config(**KW)
        cfg.record_history = False
        cfg.render = dataclasses.replace(cfg.render, backend="pallas")
        cam = (JCameraBuilder().with_position(1000.0, 1000.0, 1150.0)
               .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
               .with_aspect(KW["width"] / KW["height"])
               .with_near_far(0.5, 1500.0).with_draw_distance(1500.0)
               .build())
        jeng, teng = JEngine(cfg, camera=cam), TS.build_space_engine(
            device="cpu", **KW)
        assert teng.config.enable_shadows and teng.shadow_state is not None
        out = []
        for i in range(4):
            jimg = np.asarray(jeng.frame(_inputs(JInput, i), DT))
            timg = teng.frame(_inputs(TInput, i), DT)
            out.append(dict(
                jimg=jimg, timg=timg.numpy(),
                jw={k: np.asarray(v) for k, v in jeng.world.comps.items()},
                tw={k: v.numpy() for k, v in teng.world.comps.items()},
                jalive=np.asarray(jeng.world.alive),
                talive=teng.world.alive.numpy(),
                jcam=np.asarray(jeng.camera.serialize()),
                tcam=teng.camera.serialize().numpy(),
                jdrops=jeng.drop_stats(), tdrops=teng.drop_stats(),
                # host copies: the next JAX frame donates these buffers
                jsh=jax.tree_util.tree_map(np.asarray, jeng.shadow_state),
                tsh=teng.shadow_state.clone()))
        # render() draws the current state with the current maps and does
        # not update them
        before = teng.shadow_state
        again = teng.render().numpy()
        assert teng.shadow_state is before
    finally:
        mp.undo()
    return dict(frames=out, engines=(jeng, teng), again=again)


@pytest.mark.parametrize("frame", range(4))
def test_world_and_camera_match(runs, frame):
    r = runs["frames"][frame]
    np.testing.assert_array_equal(r["jalive"], r["talive"])
    for name in ("type_id", "model_id"):
        np.testing.assert_array_equal(r["jw"][name], r["tw"][name])
    for name in ("position", "velocity", "orientation", "aabb_min",
                 "aabb_max"):
        np.testing.assert_allclose(r["tw"][name], r["jw"][name], rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(r["tcam"], r["jcam"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("frame", range(4))
def test_all_drop_counters_match(runs, frame):
    r = runs["frames"][frame]
    assert set(r["jdrops"]) == set(r["tdrops"]) == DROP_KEYS
    assert r["tdrops"] == r["jdrops"]


@pytest.mark.parametrize("frame", range(4))
def test_shadow_state_matches(runs, frame):
    r = runs["frames"][frame]
    assert_state_close(r["tsh"], r["jsh"])
    assert r["tsh"].tick == frame + 1
    # the scene's two spot lights are mapped from the second update on
    assert (r["tsh"].slot_entity.numpy() >= 0).sum() == min(frame + 1, 2)


@pytest.mark.parametrize("frame", range(4))
def test_image_matches(runs, frame):
    r = runs["frames"][frame]
    assert r["timg"].shape == (KW["height"], KW["width"], 3)
    assert np.isfinite(r["timg"]).all()
    diff = np.abs(r["timg"] - r["jimg"])
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = to_srgb_u8(torch.as_tensor(r["timg"])).numpy()
    b = to_srgb_u8(torch.as_tensor(r["jimg"])).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()


def test_render_keeps_shadow_state_and_image(runs):
    """Engine.render() after the last frame redraws that frame."""
    np.testing.assert_array_equal(runs["again"], runs["frames"][-1]["timg"])


def test_converted_shadow_state_renders_like_the_port(runs):
    """convert.shadow_state_from_numpy carries the JAX engine's shadow
    state across; the port renders its own final state with it like its
    own last frame."""
    jeng, teng = runs["engines"]
    js = runs["frames"][-1]["jsh"]
    sh = convert.shadow_state_from_numpy(
        np.asarray(js.maps), np.asarray(js.light_mats),
        np.asarray(js.slot_entity), np.asarray(js.slot_face), js.cursor,
        js.tick, js.resolution, js.pcf_scale)
    assert (sh.cursor, sh.tick, sh.resolution, sh.pcf_scale) == (
        4, 4, 128, teng.config.shadow_pcf_scale)
    img = render_frame(teng.world, teng.camera, teng.bank, teng.config.render,
                       cubemap=teng.cubemap, atlas=teng.atlas,
                       shadow_state=sh, systems=teng.compiled_systems).numpy()
    want = runs["frames"][-1]["timg"]
    diff = np.abs(img - want)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = to_srgb_u8(torch.as_tensor(img)).numpy()
    b = to_srgb_u8(torch.as_tensor(want)).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()
