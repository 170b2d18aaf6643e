"""Per-tile light lists: the port's ``select_tile_lights``,
``RenderSettings.light_tile_budget`` and the ``light_tile_overflow`` counter
against the JAX package's (CPU; the JAX side runs its Pallas kernels in
interpret mode). Mirrors ``tests/test_frame_tiled.py``'s tile-light tests.

Tolerances. ``tcount`` / ``tlist`` / ``dropped`` are integers and must be
equal, except for lights on a pyramid plane: the two packages round the
corner rays (a difference of two numbers near 64, so their relative error
is about 1e-5) and with them the plane distance d differently, so a
(tile, light) pair may differ where |d + radius| <= 1e-3; such a light
contributes nothing visible to the tile either way. On the seeded scene one
light does so, in three tiles that share a plane. Inside the port the
frame through the lists must equal the frame through the loop over every
light bit for bit (``torch.equal``). Images against JAX: 2/255 and at most
0.1% of the u8 values.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.demo import space_scene as JS
from render_engine_tpu.math.camera import CameraBuilder as JCameraBuilder
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import lighting as LJ
from render_engine_tpu.render import shade_pallas as SPJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu.runtime.engine import Engine as JEngine
from render_engine_tpu_torch.demo import space_scene as TS
from render_engine_tpu_torch.math import transforms as TT
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import lighting as LT
from render_engine_tpu_torch.render import shade_pallas as SPT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

from test_torch_frame import H, JAX_PK, RASTER, TORCH_PK, WIDTH, build

N_LIGHTS = 40
BOUNDARY_EPS = 1e-3


def lit_scene(pk, seed=11):
    """The test_frame_tiled scene plus 40 seeded point lights (radii 3 to
    14, spread through and around the view) and one directional light."""
    w, bank, cam, _ = build(pk, False, capacity=64)
    W, R = pk[2], pk[3]
    rng = np.random.default_rng(seed)
    n = N_LIGHTS + 1
    pos = (np.array([64.0, 64.0, 56.0])
           + rng.uniform(-14, 14, (n, 3)) * np.array([2.0, 0.6, 1.0]))
    radius = rng.uniform(3.0, 14.0, n)
    radius[-1] = 0.0
    direction = np.zeros((n, 3))
    direction[-1] = [0.3, -1.0, 0.2]
    w, _ = W.spawn_host(
        w, n, position=pos.astype(np.float32),
        model_id=np.full(n, -1, np.int32),
        sortable=np.array([R.SORTABLE_POINT] * N_LIGHTS
                          + [R.SORTABLE_DIRECTIONAL], np.int32),
        light_diffuse=rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32),
        light_specular=rng.uniform(0.0, 0.5, (n, 3)).astype(np.float32),
        light_atten=np.tile(np.array([[0.05, 0.01]], np.float32), (n, 1)),
        light_radius=radius.astype(np.float32),
        light_direction=direction.astype(np.float32))
    return w, bank, cam


def select_both(budget, width, height):
    """tlist / tcount / dropped of both packages for the lit scene on a
    ``width`` x ``height`` tiling, and the port's plane distances."""
    wj, _, cj = lit_scene(JAX_PK)
    wt, _, ct = lit_scene(TORCH_PK)
    tiles_x, tiles_y = -(-width // 128), -(-height // 8)
    cj = dataclasses.replace(cj, aspect=width / height)
    ct = dataclasses.replace(ct, aspect=width / height)
    lj = LJ.extract_lights(wj, max_dir=4, max_point=48, max_spot=4)
    lt = LT.extract_lights(wt, max_dir=4, max_point=48, max_spot=4)
    tab_j, live_j = SPJ.pack_lights(lj, 56)
    tab_t, live_t = SPT.pack_lights(lt, 56)
    np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j))
    assert int(live_t) == int(live_j) == N_LIGHTS + 2  # + the scene's own
    out_j = SPJ.select_tile_lights(
        tab_j, live_j, cj.position, jnp.linalg.inv(cj.proj_view()), tiles_x,
        tiles_y, 8, 128, width, height, 0.0, budget)
    out_t = SPT.select_tile_lights(
        tab_t, live_t, ct.position, TT.inv44(ct.proj_view()), tiles_x,
        tiles_y, 8, 128, width, height, 0.0, budget)
    return [np.asarray(a) for a in out_j], [a.numpy() for a in out_t], \
        (tab_t, ct, tiles_x, tiles_y, width, height)


def members(tlist, tcount):
    return [set(row[:n].tolist()) for row, n in zip(tlist, tcount)]


def boundary_distance(tab, cam, tiles_x, tiles_y, width, height, tile, light):
    """min over the 5 planes of |d + radius| for one (tile, light) pair, in
    float64 from the port's own corner rays."""
    ndc = SPT._tile_corner_ndc(tiles_x, tiles_y, 8, 128, width, height, 0.0,
                               torch.device("cpu")).double()
    wp = ndc @ TT.inv44(cam.proj_view()).double().T
    rays = wp[..., :3] / wp[..., 3:4] - cam.position.double()
    ty, tx = divmod(tile, tiles_x)
    tl, tr = rays[ty, tx], rays[ty, tx + 1]
    bl, br = rays[ty + 1, tx], rays[ty + 1, tx + 1]
    center = tl + tr + bl + br
    planes = [torch.linalg.cross(a, b) for a, b in
              ((tl, bl), (br, tr), (tr, tl), (bl, br))]
    planes = [p * torch.sign(p @ center) / p.norm() for p in planes]
    planes.append(center / center.norm())
    lpos = tab[light, 1:4].double() - cam.position.double()
    return min(abs(float(p @ lpos) + float(tab[light, 20])) for p in planes)


def boundary_pairs(a, b, geo):
    """The (tile, light) pairs on which two (tlist, tcount) selections
    differ; each must lie within BOUNDARY_EPS of a pyramid plane."""
    pairs = [(tile, light) for tile, (ma, mb) in
             enumerate(zip(members(*a), members(*b))) for light in ma ^ mb]
    for tile, light in pairs:
        assert boundary_distance(*geo, tile, light) <= BOUNDARY_EPS
    return pairs


def test_select_tile_lights_matches_reference():
    """A budget that holds every light: the lists agree but for lights on
    a plane (seed 11 has one, 8.9e-5 from the top plane of tile row 1, so
    three tiles list it in one package only)."""
    (tl_j, tc_j, dr_j), (tl_t, tc_t, dr_t), geo = select_both(48, 768, 80)
    assert tl_t.shape == tl_j.shape == (60, 48)
    assert tl_t.dtype == tc_t.dtype == np.int32
    pairs = boundary_pairs((tl_t, tc_t), (tl_j, tc_j), geo)
    assert len(pairs) <= 3, pairs
    touched = {tile for tile, _ in pairs}
    for tile in set(range(60)) - touched:
        np.testing.assert_array_equal(tl_t[tile], tl_j[tile])
        assert tc_t[tile] == tc_j[tile]
    assert int(dr_t) == int(dr_j) == 0
    # the selection does cull, and keeps the directional light and the
    # scene's own unbounded light everywhere
    assert (tc_t >= 2).all() and tc_t.min() < tc_t.max() < N_LIGHTS + 2
    for row, n in zip(tl_t, tc_t):  # ascending table order, zero padding
        assert (np.diff(row[:n]) > 0).all() and (row[n:] == 0).all()


def test_select_tile_lights_starved_budget_drops_and_counts():
    """Budget 6: counts clamp, lists are the 6 lowest rows, and ``dropped``
    is the exact excess, equal to JAX's but for the boundary pairs."""
    (tl_j, tc_j, dr_j), (tl_t, tc_t, dr_t), geo = select_both(6, 768, 80)
    (_, fc_j, _), (fl_t, fc_t, _), _ = select_both(56, 768, 80)
    assert tc_t.max() == 6
    np.testing.assert_array_equal(tc_t, np.minimum(fc_t, 6))
    np.testing.assert_array_equal(tl_t, np.where(
        np.arange(6)[None] < tc_t[:, None], fl_t[:, :6], 0))
    assert int(dr_t) == int(np.maximum(fc_t - 6, 0).sum()) > 0
    assert int(dr_j) == int(np.maximum(fc_j - 6, 0).sum())
    assert abs(int(dr_t) - int(dr_j)) <= int(np.abs(fc_t - fc_j).sum()) <= 3


def test_select_tile_lights_rows_shifted_band():
    """``y_off`` selects a band of tile rows: its lists are the whole
    frame's lists of those rows (the per-band body of a split frame)."""
    wt, _, ct = lit_scene(TORCH_PK)
    ct = dataclasses.replace(ct, aspect=768 / 80)
    lt = LT.extract_lights(wt, max_dir=4, max_point=48, max_spot=4)
    tab, live = SPT.pack_lights(lt, 56)
    ipv = TT.inv44(ct.proj_view())
    full = SPT.select_tile_lights(tab, live, ct.position, ipv, 6, 10, 8, 128,
                                  768, 80, 0.0, 48)
    band = SPT.select_tile_lights(tab, live, ct.position, ipv, 6, 5, 8, 128,
                                  768, 80, 40.0, 48)
    assert torch.equal(band[0], full[0][30:])
    assert torch.equal(band[1], full[1][30:])


def settings(pk_frame, pk_raster, **kw):
    extra = dict(backend="pallas") if pk_frame is FJ else {}
    raster = pk_raster(chunk=4, **RASTER) if pk_frame is FJ \
        else pk_raster(**RASTER)
    return pk_frame.RenderSettings(width=WIDTH, height=H, max_tris=256,
                                   raster=raster, max_point_lights=48,
                                   fused_shading=True, **extra, **kw)


def test_tile_light_lists_bit_identical_in_the_port():
    """The frame through the tile lists equals the frame through the loop
    over every live light bit for bit while no tile overflows; a starved
    budget changes it."""
    w, bank, cam = lit_scene(TORCH_PK)
    dense = FT.render_frame(w, cam, bank, settings(FT, RCT))
    listed = FT.render_frame(w, cam, bank,
                             settings(FT, RCT, light_tile_budget=48))
    assert torch.equal(dense, listed)
    starved = FT.render_frame(w, cam, bank,
                              settings(FT, RCT, light_tile_budget=2))
    assert not torch.equal(dense, starved)
    assert torch.isfinite(starved).all()


def test_tile_light_frame_matches_reference():
    wj, bj, cj = lit_scene(JAX_PK)
    wt, bt, ct = lit_scene(TORCH_PK)
    img_j = np.asarray(FJ.render_frame(
        wj, cj, bj, settings(FJ, RCJ, light_tile_budget=48)))
    img_t = FT.render_frame(wt, ct, bt,
                            settings(FT, RCT, light_tile_budget=48))
    diff = np.abs(img_t.numpy() - img_j)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = FT.to_srgb_u8(img_t).numpy()
    b = FT.to_srgb_u8(torch.tensor(img_j)).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()
    # the lights are really there: brighter than the scene lit by its own
    # point light alone
    w0, b0, c0, _ = build(TORCH_PK, False)
    base = FT.render_frame(w0, c0, b0, settings(FT, RCT))
    assert float(img_t.sum()) > float(base.sum()) + 1.0


KW = dict(width=128, height=32, capacity=128, num_asteroids=10,
          max_tris=2048)


@pytest.fixture(scope="module")
def engines():
    """The space engine of both packages with a light-list budget of 1,
    which the demo's lights overflow in every tile."""
    cfg = JS.space_config(enable_shadows=False, light_tile_budget=1, **KW)
    cfg.record_history = False
    cfg.render = dataclasses.replace(cfg.render, backend="pallas")
    cam = (JCameraBuilder().with_position(1000.0, 1000.0, 1150.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(KW["width"] / KW["height"])
           .with_near_far(0.5, 1500.0).with_draw_distance(1500.0).build())
    return JEngine(cfg, camera=cam), TS.build_space_engine(
        device="cpu", enable_shadows=False, light_tile_budget=1, **KW)


def test_light_tile_overflow_counter_matches_reference(engines):
    jeng, teng = engines
    jd, td = jeng.render_drop_stats(), teng.render_drop_stats()
    assert "light_tile_overflow" in td
    assert td["light_tile_overflow"] == jd["light_tile_overflow"] > 0
    assert td == jd


def test_light_tile_overflow_absent_without_a_budget(engines):
    """Budget 0 (the default) reports no such counter, as in the JAX
    package; the golden backend has no tile lists either."""
    _, teng = engines
    saved = teng.config.render
    try:
        teng.config.render = dataclasses.replace(saved, light_tile_budget=0)
        assert "light_tile_overflow" not in teng.render_drop_stats()
        teng.config.render = dataclasses.replace(saved, backend="jnp")
        stats = teng.render_drop_stats()
        assert "light_tile_overflow" not in stats
        assert "texture_tile_overflow" not in stats
    finally:
        teng.config.render = saved


def test_drop_stats_has_all_14_counters():
    """With shadows and a light-list budget ``drop_stats()`` gives the 6
    step counters and all 8 render counters."""
    eng = TS.build_space_engine(device="cpu", light_tile_budget=8, **KW)
    eng.config.record_history = False
    eng.frame(None, 1.0 / 60.0)
    stats = eng.drop_stats()
    assert len(stats) == 14, sorted(stats)
    assert stats["light_tile_overflow"] == 0
