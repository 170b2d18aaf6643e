"""The shadowed frame of the port (render_engine_tpu_torch/render/frame.py:
the per-slot PCF factor tiles, ``shadow_tile_overflow`` and the fused frame
with shadow slots) against the JAX package's, on the CPU, on the scene of
tests/test_frame_tiled.py with a point light's cube-face maps.

The JAX shadow raster is patched to ``rasterize_depth_winner_pallas``
(interpret mode) inside these tests, as in tests/test_torch_shadows.py.

Tolerances:
* the shadow state each package renders: as in tests/test_torch_shadows.py
  (schedule exact, light_mats 1e-5, maps within 1e-5 where both cover a
  texel and at most 0.5% of texels differing in coverage);
* per-slot factor tiles, their inverse map and ``shadow_tile_overflow``,
  given the same shadow state, depth and inverse proj_view: exact (the
  clip rows are formed with the fused multiply-adds XLA contracts them
  into);
* the shadowed fused frame: within 2/255 with at most 0.1% of u8 values
  differing, as the slice's image tests.

Against the JAX package's golden jnp maps (its CPU default) the port's maps
cover the same texels; on this scene 8 of the 1,329 covered texels (0.6%)
hold another triangle's depth (overlapping triangles at a shared edge
resolve in another order) and the rest agree within 1.2e-7.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.ecs import registry as RJ
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.render import shadows as SHJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

from test_torch_shadows import (JAX, TORCH, _JAX_AUTO_RASTERIZER, _np,
                                _world, assert_schedule_equal,
                                assert_state_close, to_port)


@pytest.fixture(autouse=True)
def pallas_shadows(monkeypatch):
    monkeypatch.setattr(FJ, "pick_rasterizer",
                        lambda backend="auto":
                        RPJ.rasterize_depth_winner_pallas)


def frame_scene(pk):
    """The scene of tests/test_frame_tiled.py: two cubes, a point-lit
    emissive star, a glass pane."""
    bb = pk.MB()
    red = bb.add_material(albedo=(1.0, 0.1, 0.1))
    glow = bb.add_material(albedo=(1.0, 0.9, 0.6), emissive=4.0)
    glass = bb.add_material(albedo=(0.2, 0.9, 0.4), alpha=0.4)
    cube = bb.add_model("cube", pk.P.cube(1.5), material=red)
    star = bb.add_model("star", pk.P.uv_sphere(0.7, 6, 8), material=glow)
    pane = bb.add_model("pane", pk.P.quad(2.0), material=glass)
    bank = bb.finalize()
    w = _world(pk, bank, 16, 128.0, 16.0,
               position=np.array([[62.0, 64.0, 58.0], [66.0, 64.0, 58.0],
                                  [64.0, 65.5, 57.0], [64.0, 64.0, 60.5]],
                                 np.float32),
               model_id=np.array([cube, star, cube, pane], np.int32),
               sortable=np.array([0, RJ.SORTABLE_POINT, 0, 0], np.int32),
               light_diffuse=np.array([[0, 0, 0], [1.0, 0.9, 0.8], [0, 0, 0],
                                       [0, 0, 0]], np.float32),
               light_atten=np.array([[0, 0], [0.05, 0.01], [0, 0], [0, 0]],
                                    np.float32))
    cam = (pk.CB().with_position(64.0, 64.0, 64.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(128 / 32).with_near_far(0.1, 100.0)
           .with_draw_distance(100.0).build())
    return w, bank, cam


H, WIDTH = 32, 128
RASTER = dict(tile_budget=32, max_tiles_per_tri=8, global_budget=16)


@pytest.fixture(scope="module")
def frame_case():
    """The frame scene in both packages, its shadow map rendered by each
    (six updates, so the point light owns several faces), and the JAX
    opaque raster of the frame (tiled depth / winner) as shared input."""
    mp = pytest.MonkeyPatch()
    mp.setattr(FJ, "pick_rasterizer",
               lambda backend="auto": RPJ.rasterize_depth_winner_pallas)
    try:
        out = {}
        for name, pk in (("t", TORCH), ("j", JAX)):
            w, bank, cam = frame_scene(pk)
            sh = pk.SH.create_shadow_state(resolution=64, budget=4,
                                           pcf_scale=1)
            for _ in range(6):
                sh = pk.render(sh, w, cam, bank, max_tris=256,
                                             raster_cfg=pk.RC(**RASTER))
            out[name] = (w, bank, cam, sh)
        wj, bj, cj, sj = out["j"]
        from render_engine_tpu.render.geometry import (build_triangle_batch,
                                                       to_screen)
        batch = to_screen(build_triangle_batch(wj, bj, cj, max_tris=256),
                          WIDTH, H)
        cfg = RCJ(**RASTER)
        tri_class = jnp.where(batch.valid,
                              jnp.where(batch.transparent, 2.0, 1.0),
                              0.0).astype(jnp.float32)
        d, wn, *_ = RPJ._launch(batch, H, WIDTH, cfg, tri_class,
                                two_pass=True, interpret=True, classed=True)
        out["raster"] = (np.asarray(d), np.asarray(wn))
        from render_engine_tpu.math import transforms as TJ
        out["inv_pv"] = np.asarray(TJ.inv44(cj.proj_view()))
    finally:
        mp.undo()
    return out


def test_frame_scene_shadow_state_matches(frame_case):
    st, sj = frame_case["t"][3], frame_case["j"][3]
    assert_state_close(st, sj)
    assert (_np(st.slot_entity) == 1).sum() >= 4


def _tile_args(frame_case, pcf_scale):
    sj = dataclasses.replace(frame_case["j"][3], pcf_scale=pcf_scale)
    d, wn = frame_case["raster"]
    tiles_x = -(-WIDTH // 128)
    common = (tiles_x, 8, 128, WIDTH, H)
    return sj, to_port(sj), d, wn, common, frame_case["inv_pv"]


@pytest.mark.parametrize("pcf_scale", [1, 2, 3])
@pytest.mark.parametrize("frac", [1.0, 0.75, 0.25])
def test_per_slot_factor_tiles_exact(frame_case, pcf_scale, frac):
    sj, st, d, wn, common, ipv = _tile_args(frame_case, pcf_scale)
    fj, ij = FJ._per_slot_factor_tiles(sj, jnp.asarray(d), jnp.asarray(wn),
                                       *common, jnp.asarray(ipv), 0.0, frac)
    ft, it = FT._per_slot_factor_tiles(st, torch.as_tensor(d),
                                       torch.as_tensor(wn), *common,
                                       torch.as_tensor(ipv), 0.0, frac)
    np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
    assert (it.numpy() >= 0).any() and (ft.numpy() < 1.0).any()


@pytest.mark.parametrize("frac", [1.0, 0.25])
def test_shadow_tile_overflow_exact(frame_case, frac):
    sj, st, d, wn, common, ipv = _tile_args(frame_case, 1)
    oj = int(FJ.shadow_tile_overflow(sj, jnp.asarray(d), jnp.asarray(wn),
                                     *common, jnp.asarray(ipv), 0.0, frac))
    ot = int(FT.shadow_tile_overflow(st, torch.as_tensor(d),
                                     torch.as_tensor(wn), *common,
                                     torch.as_tensor(ipv), 0.0, frac))
    assert ot == oj
    assert (ot > 0) == (frac < 0.5)


def _settings_pair(**kw):
    sj = FJ.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           backend="pallas", fused_shading=True,
                           raster=RCJ(chunk=4, **RASTER), max_point_lights=4,
                           **kw)
    st = FT.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           fused_shading=True, raster=RCT(**RASTER),
                           max_point_lights=4, **kw)
    return sj, st


def _assert_images_close(a, b):
    a = _np(a)
    b = _np(b)
    assert np.abs(a - b).max() <= 2.0 / 255.0, np.abs(a - b).max()
    ua = FT.to_srgb_u8(torch.as_tensor(a)).numpy()
    ub = FT.to_srgb_u8(torch.as_tensor(b)).numpy()
    assert (ua != ub).mean() <= 1e-3, (ua != ub).sum()


@pytest.mark.parametrize("budget", [1.0, 0.25])
def test_shadowed_fused_frame_matches(frame_case, budget):
    """The port's shadowed fused frame (its own shadow maps) against the
    JAX fused frame with shadows; the shadows darken the unshadowed
    frame; the port rendering the converted JAX state matches too."""
    wt, bt, ct, st = frame_case["t"]
    wj, bj, cj, sj = frame_case["j"]
    s_j, s_t = _settings_pair(shadow_tile_budget=budget)
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, s_j, shadow_state=sj))
    img_t = FT.render_frame(wt, ct, bt, s_t, shadow_state=st)
    _assert_images_close(img_t, img_j)
    _assert_images_close(FT.render_frame(wt, ct, bt, s_t,
                                         shadow_state=to_port(sj)), img_j)
    img_ns = FT.render_frame(wt, ct, bt, s_t).numpy()
    assert (img_t.numpy() <= img_ns + 1e-5).all()
    # a starved budget leaves the overflow tiles lit
    assert (img_t.numpy() < img_ns - 1e-3).any() == (budget == 1.0)


def test_maps_against_jax_golden_path(frame_case, monkeypatch):
    """The JAX package's own CPU default (the jnp golden raster) against
    the port's K1 maps: only edge texels differ."""
    monkeypatch.setattr(FJ, "pick_rasterizer", _JAX_AUTO_RASTERIZER)
    w, bank, cam = frame_scene(JAX)
    sh = SHJ.create_shadow_state(resolution=64, budget=4, pcf_scale=1)
    for _ in range(6):
        sh = SHJ.render_shadow_map(sh, w, cam, bank, max_tris=256,
                                   raster_cfg=RCJ(**RASTER))
    st = frame_case["t"][3]
    assert_schedule_equal(st, sh)
    mt, mg = st.maps.numpy(), np.asarray(sh.maps)
    cov_t, cov_g = mt < 1.0, mg < 1.0
    assert (cov_t != cov_g).mean() <= 5e-3, (cov_t != cov_g).sum()
    diff = np.abs(mt - mg)[cov_t & cov_g]
    assert (diff > 1e-5).mean() <= 0.01, (diff > 1e-5).sum()
