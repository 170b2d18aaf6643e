"""The port's slice end to end: the space engine's frames (step + fused
tiled render) in render_engine_tpu_torch against the JAX package's, on the
CPU at the demo test size (128x32, 10 asteroids).

The JAX engine runs the same tiled fused path with its Pallas kernels in
interpret mode (``backend="pallas"``), not its jnp golden path.

Tolerances: world columns rtol 1e-5 / atol 1e-4 and the camera vector
1e-5 (transcendentals and 4x4 products round differently in XLA and in
PyTorch); integer state exact; the image within 2/255 with at most 0.1% of
its u8 values differing (a last-bit difference in a triangle's screen
position can move a pixel center across an edge).
"""

import dataclasses

import numpy as np
import pytest
import torch

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.logic.types import KEY_W
from render_engine_tpu.math.camera import CameraBuilder as JCameraBuilder
from render_engine_tpu.runtime.engine import Engine as JEngine

from render_engine_tpu_torch import convert
from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.logic.types import InputState as TInput
from render_engine_tpu_torch.render.frame import render_frame, to_srgb_u8

KW = dict(width=128, height=32, capacity=128, num_asteroids=10,
          max_tris=2048)
DT = 1.0 / 60.0


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
def engines():
    """The JAX engine (tiled fused Pallas path, interpret mode) and the
    port's, built once for the module."""
    cfg = JS.space_config(enable_shadows=False, **KW)
    cfg.record_history = False
    cfg.render = dataclasses.replace(cfg.render, backend="pallas")
    cam = (JCameraBuilder().with_position(1000.0, 1000.0, 1150.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(KW["width"] / KW["height"])
           .with_near_far(0.5, 1500.0).with_draw_distance(1500.0).build())
    return JEngine(cfg, camera=cam), TS.build_space_engine(
        device="cpu", enable_shadows=False, **KW)


@pytest.fixture(scope="module")
def runs(engines):
    """Both engines driven through 4 frames; per-frame snapshots."""
    jeng, teng = engines
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
            jdrops=jeng.drop_stats(), tdrops=teng.drop_stats()))
    return out


@pytest.mark.parametrize("frame", range(4))
def test_world_columns_match(runs, frame):
    r = runs[frame]
    np.testing.assert_array_equal(r["jalive"], r["talive"])
    np.testing.assert_array_equal(r["jw"]["type_id"], r["tw"]["type_id"])
    np.testing.assert_array_equal(r["jw"]["model_id"], r["tw"]["model_id"])
    np.testing.assert_array_equal(r["jw"]["flags"].view(np.int32),
                                  r["tw"]["flags"])
    for name in ("position", "velocity", "orientation", "aabb_min",
                 "aabb_max", "orbit_angle", "spawn_timer"):
        np.testing.assert_allclose(r["tw"][name], r["jw"][name], rtol=1e-5,
                                   atol=1e-4, err_msg=name)


@pytest.mark.parametrize("frame", range(4))
def test_camera_and_counters_match(runs, frame):
    r = runs[frame]
    np.testing.assert_allclose(r["tcam"], r["jcam"], rtol=1e-5, atol=1e-5)
    for k, v in r["tdrops"].items():
        assert r["jdrops"][k] == v, k


@pytest.mark.parametrize("frame", range(4))
def test_image_matches(runs, frame):
    r = runs[frame]
    assert r["timg"].shape == (KW["height"], KW["width"], 3)
    assert np.isfinite(r["timg"]).all()
    diff = np.abs(r["timg"] - r["jimg"])
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = to_srgb_u8(torch.as_tensor(r["timg"])).numpy()
    b = to_srgb_u8(torch.tensor(r["jimg"])).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()


def test_converted_jax_state_renders_like_the_port(engines, runs):
    """convert.py carries the JAX engine's scene and its state after the
    4 frames across; the port's own scene tables equal the converted ones,
    and the converted state renders like the port's last frame."""
    jeng, teng = engines
    bank = convert.bank_from_numpy(
        {f: np.asarray(getattr(jeng.bank, f)) for f in convert.BANK_FIELDS},
        jeng.bank.names)
    for f in convert.BANK_FIELDS:
        torch.testing.assert_close(getattr(bank, f), getattr(teng.bank, f),
                                   rtol=0, atol=0, msg=f)
    ja = jeng.atlas
    atlas = convert.atlas_from_numpy(
        np.asarray(ja.layers), np.asarray(ja.tex_layer),
        np.asarray(ja.uv_rect), np.asarray(ja.bilin_rows))
    for f in ("layers", "tex_layer", "uv_rect", "bilin_rows"):
        torch.testing.assert_close(getattr(atlas, f), getattr(teng.atlas, f),
                                   rtol=0, atol=0, msg=f)
    js = jeng.compiled_systems
    systems = convert.systems_from_numpy(
        np.asarray(js.model_system), np.asarray(js.sys_table),
        np.asarray(js.sys_lov), js.names)
    for f in ("model_system", "sys_table", "sys_lov"):
        torch.testing.assert_close(getattr(systems, f),
                                   getattr(teng.compiled_systems, f),
                                   rtol=0, atol=0, msg=f)
    assert systems.names == teng.compiled_systems.names
    stars = convert.starfield_from_numpy(np.asarray(jeng.cubemap.dirs),
                                         np.asarray(jeng.cubemap.colors))
    torch.testing.assert_close(stars.dirs, teng.cubemap.dirs, rtol=0, atol=0)
    world = convert.world_from_numpy(
        teng.world.config, np.asarray(jeng.world.alive),
        np.asarray(jeng.world.comp_mask),
        {k: np.asarray(v) for k, v in jeng.world.comps.items()})
    cam = convert.camera_from_serialized(np.asarray(jeng.camera.serialize()),
                                         teng.camera)
    img = render_frame(world, cam, bank, teng.config.render, cubemap=stars,
                       atlas=atlas, systems=systems).numpy()
    diff = np.abs(img - runs[-1]["timg"])
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = to_srgb_u8(torch.as_tensor(img)).numpy()
    b = to_srgb_u8(torch.as_tensor(runs[-1]["timg"])).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()


def test_default_device_is_the_card(monkeypatch):
    """The entry points default to the card: with no card, a build that
    names no device raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TS.build_space_engine(enable_shadows=False, **KW)
