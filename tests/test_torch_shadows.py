"""The port's shadow pass (render_engine_tpu_torch/render/shadows.py)
against the JAX package's, on the CPU: the shadow half of
tests/test_shadows_textures.py through both packages, the light cameras,
the slot schedule, caster counts and PCF from light-clip coordinates.

The JAX shadow raster picks its rasterizer with ``pick_rasterizer("auto")``,
which is the jnp golden path on the CPU. The fixture ``pallas_shadows``
patches it, inside these tests only, to ``rasterize_depth_winner_pallas``
(interpret mode): the K1 path the JAX package takes on the TPU and the one
the port always takes.

Tolerances:
* the slot schedule (slot_entity, slot_face, cursor, tick, the chosen slot,
  light, face and do_render) and caster counts: exact;
* light matrices (``light_proj_view``, ``light_mats``): 1e-5 (tan, arccos
  and 4x4 products round differently in XLA and in PyTorch);
* depth maps rendered by each package: within 1e-5 where both cover a
  texel, with at most 0.5% of texels differing in coverage (the light
  matrices' last bits move triangle edges across texel centers);
* PCF factors, given the same shadow state and coordinates: exact.

The frame's per-slot factor tiles and the shadowed frame are held in
tests/test_torch_shadow_frame.py.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.ecs import registry as RJ
from render_engine_tpu.ecs import world as WJ
from render_engine_tpu.logic import kinematics as KJ
from render_engine_tpu.math.camera import CameraBuilder as CBJ
from render_engine_tpu.models import primitives as PJ
from render_engine_tpu.models.bank import ModelBankBuilder as MBJ
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.render import shadows as SHJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu_torch import convert
from render_engine_tpu_torch.ecs import registry as RT
from render_engine_tpu_torch.ecs import world as WT
from render_engine_tpu_torch.logic import kinematics as KT
from render_engine_tpu_torch.math.camera import CameraBuilder as CBT
from render_engine_tpu_torch.models import primitives as PT
from render_engine_tpu_torch.models.bank import ModelBankBuilder as MBT
from render_engine_tpu_torch.render import shadows as SHT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

_JITTED = {}


def _jax_render_shadow_map(shadow, world, camera, bank, caster_mask=None,
                           **kw):
    """The JAX update under jit (one compile per bank, settings and mask
    kind), so a run of updates does not re-run the interpreted kernel op
    by op. A callable caster mask is traced into the program."""
    fn_mask = caster_mask if callable(caster_mask) else None
    key = (id(bank), id(fn_mask), caster_mask is None,
           tuple(sorted(kw.items())))
    fn = _JITTED.get(key)
    if fn is None:
        fn = _JITTED[key] = jax.jit(
            lambda sh, w, cam, m: SHJ.render_shadow_map(
                sh, w, cam, bank, caster_mask=fn_mask or m, **kw))
    return fn(shadow, world, camera, None if fn_mask else caster_mask)


JAX = types.SimpleNamespace(W=WJ, K=KJ, CB=CBJ, MB=MBJ, P=PJ, SH=SHJ, R=RJ,
                            RC=RCJ, asarray=jnp.asarray,
                            render=_jax_render_shadow_map)
TORCH = types.SimpleNamespace(W=WT, K=KT, CB=CBT, MB=MBT, P=PT, SH=SHT,
                              R=RT, RC=RCT, asarray=torch.as_tensor,
                              render=SHT.render_shadow_map)
SMALL_CFG = dict(tile_budget=16, global_budget=8)
_JAX_AUTO_RASTERIZER = FJ.pick_rasterizer


@pytest.fixture(autouse=True)
def pallas_shadows(monkeypatch):
    monkeypatch.setattr(FJ, "pick_rasterizer",
                        lambda backend="auto":
                        RPJ.rasterize_depth_winner_pallas)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _bank(pk):
    bb = pk.MB()
    m = bb.add_material(albedo=(1.0, 1.0, 1.0))
    bb.add_model("cube", pk.P.cube(2.0), material=m)
    return bb.finalize()


def _world(pk, bank, capacity, world_length, section_length, **cols):
    w = pk.W.create_world(pk.W.WorldConfig(
        capacity=capacity, world_length=world_length,
        section_length=section_length))
    n = len(cols["position"])
    w, _ = pk.W.spawn_host(w, n, **cols)
    return pk.K.refresh_transforms(w, bank.aabb_min, bank.aabb_max,
                                   pk.asarray(w.alive))


def _cam(pk, pos, draw=500.0):
    return pk.CB().with_position(*pos).with_draw_distance(draw).build()


def light_and_blocker(pk):
    """A spot light above looking down, a cube between it and the ground."""
    bank = _bank(pk)
    w = _world(pk, bank, 16, 256.0, 32.0,
               position=np.array([[64.0, 40.0, 64.0], [64.0, 20.0, 64.0]],
                                 np.float32),
               model_id=np.array([-1, 0], np.int32),
               sortable=np.array([RJ.SORTABLE_SPOT, RJ.SORTABLE_DEFAULT],
                                 np.int32),
               light_direction=np.array([[0.0, -1.0, 0.0], [0, 0, 0]],
                                        np.float32),
               light_fov=np.array([1.2, 0.0], np.float32))
    return w, bank, _cam(pk, (64.0, 25.0, 80.0))


def point_and_blocker(pk, blocker_x):
    bank = _bank(pk)
    w = _world(pk, bank, 8, 256.0, 32.0,
               position=np.array([[64.0, 40.0, 64.0], [blocker_x, 40.0, 64.0]],
                                 np.float32),
               model_id=np.array([-1, 0], np.int32),
               sortable=np.array([RJ.SORTABLE_POINT, RJ.SORTABLE_DEFAULT],
                                 np.int32))
    return w, bank, _cam(pk, (64.0, 45.0, 80.0))


def directional(pk):
    """A radius-400 directional light; a caster 300 units off its axis."""
    bank = _bank(pk)
    lpos = np.array([1024.0, 600.0, 1024.0], np.float32)
    w = _world(pk, bank, 16, 2048.0, 256.0,
               position=np.stack([lpos, lpos + np.array([300.0, -50.0, 0.0],
                                                        np.float32)]),
               model_id=np.array([-1, 0], np.int32),
               scale=np.array([[1.0, 1, 1], [20.0, 20, 20]], np.float32),
               sortable=np.array([RJ.SORTABLE_DIRECTIONAL,
                                  RJ.SORTABLE_DEFAULT], np.int32),
               light_direction=np.array([[0.0, -1.0, 0.0], [0, 0, 0]],
                                        np.float32),
               light_radius=np.array([400.0, 0.0], np.float32))
    return w, bank, _cam(pk, (1024.0, 500.0, 1100.0), draw=1000.0)


def spot_cone(pk):
    """A spot light with a 1.0 rad outer cutoff and light_fov 1.2; a caster
    0.8 rad off its axis."""
    bank = _bank(pk)
    lpos = np.array([256.0, 200.0, 256.0], np.float32)
    off = (np.array([np.sin(0.8), -np.cos(0.8), 0.0]) * 100.0).astype(
        np.float32)
    w = _world(pk, bank, 16, 512.0, 64.0,
               position=np.stack([lpos, lpos + off]),
               model_id=np.array([-1, 0], np.int32),
               sortable=np.array([RJ.SORTABLE_SPOT, RJ.SORTABLE_DEFAULT],
                                 np.int32),
               light_direction=np.array([[0.0, -1.0, 0.0], [0, 0, 0]],
                                        np.float32),
               light_fov=np.array([1.2, 0.0], np.float32),
               light_cutoff=np.tile(np.array([[np.cos(0.6), np.cos(1.0)]],
                                             np.float32), (2, 1)),
               light_radius=np.array([400.0, 0.0], np.float32))
    return w, bank, _cam(pk, (256.0, 150.0, 300.0))


def assert_schedule_equal(st, sj):
    np.testing.assert_array_equal(_np(st.slot_entity), _np(sj.slot_entity))
    np.testing.assert_array_equal(_np(st.slot_face), _np(sj.slot_face))
    assert st.cursor == int(sj.cursor) and st.tick == int(sj.tick)


def assert_maps_close(mt, mj):
    mt, mj = _np(mt), _np(mj)
    cov_t, cov_j = mt < 1.0, mj < 1.0
    assert (cov_t != cov_j).mean() <= 5e-3, (cov_t != cov_j).sum()
    both = cov_t & cov_j
    np.testing.assert_allclose(mt[both], mj[both], rtol=0, atol=1e-5)


def assert_state_close(st, sj):
    assert_schedule_equal(st, sj)
    np.testing.assert_allclose(_np(st.light_mats), _np(sj.light_mats),
                               rtol=1e-5, atol=1e-5)
    assert_maps_close(st.maps, sj.maps)


def both(scene, fn):
    """Run ``fn(pk, *scene(pk))`` in each package: (torch, jax)."""
    return fn(TORCH, *scene(TORCH)), fn(JAX, *scene(JAX))


def to_port(sj):
    return convert.shadow_state_from_numpy(
        np.asarray(sj.maps), np.asarray(sj.light_mats),
        np.asarray(sj.slot_entity), np.asarray(sj.slot_face), sj.cursor,
        sj.tick, sj.resolution, sj.pcf_scale)


# ---------------------------------------------------------------------------
# the shadow half of tests/test_shadows_textures.py, through both packages
# ---------------------------------------------------------------------------
def test_render_shadow_map_fills_slot():
    def run(pk, w, bank, cam):
        sh = pk.SH.create_shadow_state(resolution=64, budget=2)
        return pk.render(sh, w, cam, bank, max_tris=64,
                                       raster_cfg=pk.RC(**SMALL_CFG))

    st, sj = both(light_and_blocker, run)
    assert_state_close(st, sj)
    slot = int(np.argmax(_np(st.slot_entity) >= 0))
    assert (_np(st.maps[slot]) < 1.0).any()


def test_pcf_shadowing():
    """A point under the blocker is shadowed, one beside it lit; the port's
    PCF of the JAX state equals the JAX PCF."""
    def run(pk, w, bank, cam):
        sh = pk.SH.create_shadow_state(resolution=128, budget=2)
        return pk.render(sh, w, cam, bank, max_tris=64,
                                       raster_cfg=pk.RC(**SMALL_CFG))

    st, sj = both(light_and_blocker, run)
    assert_state_close(st, sj)
    slot = int(np.argmax(_np(st.slot_entity) >= 0))
    pts = np.array([[[64.0, 5.0, 64.0], [80.0, 5.0, 64.0]]], np.float32)
    ft = SHT.pcf_factor(st, slot, torch.as_tensor(pts)).numpy()
    assert ft[0, 0, 0] < 0.5 and ft[0, 1, 0] > 0.5
    fj = np.asarray(SHJ.pcf_factor(sj, jnp.int32(slot), jnp.asarray(pts)))
    np.testing.assert_array_equal(
        SHT.pcf_factor(to_port(sj), slot, torch.as_tensor(pts)).numpy(), fj)


def test_eviction_when_light_leaves():
    def run(pk, w, bank, cam):
        sh = pk.SH.create_shadow_state(resolution=32, budget=2)
        sh = pk.render(sh, w, cam, bank, max_tris=64)
        far = dataclasses.replace(
            cam, position=pk.asarray(np.array([5000.0, 5000.0, 5000.0],
                                              np.float32)))
        return sh, pk.SH.choose_light(sh, w, far.position)

    (st, ct), (sj, cj) = both(light_and_blocker, run)
    assert_state_close(st, sj)
    assert (_np(st.slot_entity) >= 0).any()
    assert_schedule_equal(ct[0], cj[0])
    assert (_np(ct[0].slot_entity) == -1).all()
    for a, b in zip(ct[1:], cj[1:]):
        assert int(a) == int(b)


@pytest.mark.parametrize("mask", ["none", "zeros", "callable"])
def test_user_caster_mask_controls_shadow_pass(mask):
    def run(pk, w, bank, cam):
        m = {"none": None,
             "zeros": pk.asarray(np.zeros(w.capacity, bool)),
             "callable": lambda world: world["position"][:, 1] < 30.0}[mask]
        sh = pk.SH.create_shadow_state(resolution=64, budget=2)
        return pk.render(sh, w, cam, bank, max_tris=64,
                                       raster_cfg=pk.RC(**SMALL_CFG),
                                       caster_mask=m)

    st, sj = both(light_and_blocker, run)
    assert_state_close(st, sj)
    slot = int(np.argmax(_np(st.slot_entity) >= 0))
    empty = (_np(st.maps[slot]) == 1.0).all()
    assert empty == (mask == "zeros")


def test_directional_camera_fits_light_radius():
    def run(pk, w, bank, cam):
        e = pk.asarray(np.int32(0))
        pv = pk.SH.light_proj_view(w, e)
        pv_old = pk.SH.light_proj_view(w, e, ortho_extent=200.0, far=600.0)
        sh = pk.SH.create_shadow_state(resolution=128, budget=1)
        sh = pk.render(sh, w, cam, bank, max_tris=64,
                                     raster_cfg=pk.RC(**SMALL_CFG))
        return (pv, pv_old, int(pk.SH.casters_outside_volume(w, e, pv)),
                int(pk.SH.casters_outside_volume(w, e, pv_old)), sh)

    rt, rj = both(directional, run)
    for a, b in zip(rt[:2], rj[:2]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    assert rt[2:4] == rj[2:4] == (0, 1)
    assert_state_close(rt[4], rj[4])
    assert int(rt[4].slot_entity[0]) == 0
    assert (_np(rt[4].maps[0]) < 1.0).any()


def test_spot_camera_widens_to_outer_cutoff():
    def run(pk, w, bank, cam):
        e = pk.asarray(np.int32(0))
        pv = pk.SH.light_proj_view(w, e)
        w_nocut = w.replace(light_cutoff=pk.asarray(
            np.zeros((w.capacity, 2), np.float32)))
        pv_narrow = pk.SH.light_proj_view(w_nocut, e)
        return (pv, pv_narrow, int(pk.SH.casters_outside_volume(w, e, pv)),
                int(pk.SH.casters_outside_volume(w, e, pv_narrow)))

    rt, rj = both(spot_cone, run)
    for a, b in zip(rt[:2], rj[:2]):
        np.testing.assert_allclose(_np(a), _np(b), rtol=1e-5, atol=1e-5)
    assert rt[2:] == rj[2:] == (0, 1)


def test_update_interval_skips_frames():
    def run(pk, w, bank, cam):
        sh = pk.SH.create_shadow_state(resolution=64, budget=2)
        out = []
        for _ in range(4):
            sh = pk.render(sh, w, cam, bank, max_tris=64,
                                         raster_cfg=pk.RC(**SMALL_CFG),
                                         interval=2)
            out.append(sh)
        return out

    rt, rj = both(light_and_blocker, run)
    for a, b in zip(rt, rj):
        assert_state_close(a, b)
    assert [s.tick for s in rt] == [1, 2, 3, 4]
    assert [s.cursor for s in rt] == [1, 1, 2, 2]


def test_point_light_fills_faces_over_frames():
    def run(pk, w, bank, cam):
        sh = pk.SH.create_shadow_state(resolution=32, budget=6)
        out = []
        for _ in range(6):
            sh = pk.render(sh, w, cam, bank, max_tris=64)
            out.append(sh)
        return out

    rt, rj = both(lambda pk: point_and_blocker(pk, 80.0), run)
    for a, b in zip(rt, rj):
        assert_state_close(a, b)
    assert (_np(rt[-1].slot_entity) == 0).sum() == 6
    assert sorted(_np(rt[-1].slot_face).tolist()) == [0, 1, 2, 3, 4, 5]


def test_cube_face_shadows_blocker_direction():
    """The product of the PCF factors of every face the light owns: the
    port on the JAX state equals the JAX ``make_shadow_factor``; behind the
    +X blocker is shadowed, the -X side lit."""
    def run(pk, w, bank, cam):
        sh = pk.SH.create_shadow_state(resolution=64, budget=6)
        for _ in range(6):
            sh = pk.render(sh, w, cam, bank, max_tris=64)
        return sh, w

    (st, _), (sj, wj) = both(lambda pk: point_and_blocker(pk, 72.0), run)
    assert_state_close(st, sj)
    pts = np.array([[[90.0, 40.0, 64.0], [40.0, 40.0, 64.0]]], np.float32)
    factor = SHJ.make_shadow_factor(sj, wj, {"point": jnp.array([0],
                                                                jnp.int32)})
    fj = np.asarray(factor("point", 0, jnp.asarray(pts)))
    port = to_port(sj)
    ft = torch.ones((1, 2, 1))
    for s in range(port.slots):
        if int(port.slot_entity[s]) == 0:
            ft = ft * SHT.pcf_factor(port, s, torch.as_tensor(pts))
    np.testing.assert_array_equal(ft.numpy(), fj)
    assert fj[0, 0, 0] < 0.5 and fj[0, 1, 0] > 0.5


# ---------------------------------------------------------------------------
# light cameras, the schedule, caster counts
# ---------------------------------------------------------------------------
def lights_scene(pk):
    """A directional, a spot, a point light and 20 casters from a seed."""
    rng = np.random.default_rng(7)
    bank = _bank(pk)
    n = 23
    pos = np.concatenate([
        np.array([[500.0, 700.0, 500.0], [560.0, 540.0, 480.0],
                  [440.0, 520.0, 530.0]], np.float32),
        rng.uniform(380.0, 620.0, (20, 3)).astype(np.float32)])
    w = _world(pk, bank, 32, 1024.0, 64.0,
               position=pos,
               model_id=np.array([-1, -1, -1] + [0] * 20, np.int32),
               scale=np.concatenate([np.ones((3, 3)), rng.uniform(
                   1.0, 8.0, (20, 1)).repeat(3, 1)]).astype(np.float32),
               sortable=np.array([RJ.SORTABLE_DIRECTIONAL, RJ.SORTABLE_SPOT,
                                  RJ.SORTABLE_POINT] + [0] * 20, np.int32),
               light_direction=np.concatenate([
                   np.array([[0.2, -1.0, 0.1], [-0.3, -1.0, 0.2],
                             [0.0, 0.0, 0.0]]),
                   np.zeros((20, 3))]).astype(np.float32),
               light_fov=np.array([0.0, 0.9, 0.0] + [0.0] * 20, np.float32),
               light_cutoff=np.concatenate([
                   np.array([[0.0, 0.0], [np.cos(0.5), np.cos(0.8)],
                             [0.0, 0.0]]),
                   np.zeros((20, 2))]).astype(np.float32),
               light_radius=np.array([300.0, 250.0, 0.0] + [0.0] * 20,
                                     np.float32))
    assert n == 23
    return w, bank, _cam(pk, (500.0, 550.0, 700.0), draw=1000.0)


@pytest.mark.parametrize("entity,face", [(0, 0), (1, 0)]
                         + [(2, f) for f in range(6)])
def test_light_proj_view_matches(entity, face):
    def run(pk, w, bank, cam):
        return pk.SH.light_proj_view(w, pk.asarray(np.int32(entity)),
                                     face=pk.asarray(np.int32(face)))

    pt, pj = both(lights_scene, run)
    np.testing.assert_allclose(_np(pt), _np(pj), rtol=1e-5, atol=1e-5)


def test_casters_outside_volume_exact():
    """Per light, with the fitted camera and with forced narrow volumes
    (so the counts are not all zero)."""
    def run(pk, w, bank, cam):
        out = []
        for e in range(3):
            ent = pk.asarray(np.int32(e))
            for kw in ({}, dict(ortho_extent=60.0, far=150.0),
                       dict(far=90.0)):
                pv = pk.SH.light_proj_view(w, ent, **kw)
                out.append(int(pk.SH.casters_outside_volume(w, ent, pv)))
        return out

    ct, cj = both(lights_scene, run)
    assert ct == cj
    assert max(ct) > 0 and ct[6:9] == [0, 0, 0]


def test_choose_light_schedule_12_frames():
    """Four slots, three lights (the point light wants six faces): each
    update's (slot, light, face, do_render) and the state after it, while
    the camera wanders off and back (the lights leave and re-enter the
    neighborhood)."""
    path = [(500.0, 550.0, 700.0)] * 5 + [(2500.0, 550.0, 700.0)] * 2 \
        + [(500.0, 550.0, 700.0)] * 5

    def run(pk, w, bank, cam):
        sh = pk.SH.create_shadow_state(resolution=16, budget=4)
        picks, states = [], []
        for p in path:
            cam = dataclasses.replace(
                cam, position=pk.asarray(np.array(p, np.float32)))
            _, slot, light, face, do = pk.SH.choose_light(sh, w,
                                                          cam.position)
            picks.append((int(slot), int(light), int(face), bool(do)))
            # no casters: the schedule does not depend on what is drawn,
            # and empty candidate lists keep the interpreted raster fast
            sh = pk.render(
                sh, w, cam, bank, max_tris=256,
                caster_mask=pk.asarray(np.zeros(w.capacity, bool)))
            states.append(sh)
        return picks, states

    (pt, st), (pj, sj) = both(lights_scene, run)
    assert pt == pj
    for a, b in zip(st, sj):
        assert_schedule_equal(a, b)
    assert any(not p[3] for p in pt) or any(
        (_np(s.slot_entity) == -1).all() for s in st)


# ---------------------------------------------------------------------------
# PCF from light-clip coordinates and the per-slot factor tiles
# ---------------------------------------------------------------------------
def _random_state(seed, res=32, slots=3, pcf_scale=1):
    rng = np.random.default_rng(seed)
    maps = rng.uniform(-1.0, 1.0, (slots, res, res)).astype(np.float32)
    maps[rng.random(maps.shape) < 0.3] = 1.0
    mats = rng.normal(size=(slots, 4, 4)).astype(np.float32)
    ents = np.array([3, -1, 5][:slots], np.int32)
    sj = SHJ.create_shadow_state(resolution=res, budget=slots,
                                 pcf_scale=pcf_scale)
    sj = dataclasses.replace(
        sj, maps=jnp.asarray(maps),
        maps_pcf=jnp.stack([SHJ.neighborhood_stack(jnp.asarray(m))
                            for m in maps]),
        light_mats=jnp.asarray(mats), slot_entity=jnp.asarray(ents))
    return sj, to_port(sj)


@pytest.mark.parametrize("seed", [0, 1])
def test_pcf_factor_from_clip_exact(seed):
    sj, st = _random_state(seed)
    rng = np.random.default_rng(100 + seed)
    c = rng.uniform(-1.5, 1.5, (4, 40, 50)).astype(np.float32)
    c[3] = np.abs(c[3]) + 0.2
    c[3, :5] = -c[3, :5]  # some points behind the light
    for slot in range(3):
        fj = np.asarray(SHJ.pcf_factor_from_clip(sj, slot,
                                                 *map(jnp.asarray, c)))
        ft = SHT.pcf_factor_from_clip(st, slot, *map(torch.as_tensor, c))
        np.testing.assert_array_equal(ft.numpy(), fj)
    # every slot at once (the leading slot axis the factor tiles use)
    fj = np.stack([np.asarray(SHJ.pcf_factor_from_clip(
        sj, s, *map(jnp.asarray, c))) for s in range(3)])
    ft = SHT.pcf_factor_from_clip(st, None, *(torch.as_tensor(
        np.broadcast_to(x, (3,) + x.shape).copy()) for x in c))
    np.testing.assert_array_equal(ft.numpy(), fj)
    assert 0.0 < fj.mean() < 1.0
