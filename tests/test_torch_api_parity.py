"""Public functions of the port that no frame calls, each against its JAX
counterpart on the same numpy inputs made from a seed (CPU).

Mirrors the matching cases of tests/test_math.py, test_ecs.py,
test_world_grid.py, test_logic_step.py, test_models.py and
test_transform_builder.py. Tolerances: integer and boolean outputs exact;
float outputs rtol = atol = 1e-6 (sums of three to four float32 products in
another order), except where a case states its own: norms of differences of
coordinates near 100 at atol 1e-5, and the orthographic frame as the other
image tests (2/255, at most 0.1% of u8 values differing).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.ecs import changes as CJ
from render_engine_tpu.ecs import registry as RJ
from render_engine_tpu.ecs import world as WJ
from render_engine_tpu.ecs.transform_builder import \
    EntityTransformBuilder as ETBJ
from render_engine_tpu.logic import collision as COLJ
from render_engine_tpu.logic import kinematics as KJ
from render_engine_tpu.logic.types import InputState as JInput
from render_engine_tpu.math import aabb as AJ
from render_engine_tpu.math import camera as CAMJ
from render_engine_tpu.math import transforms as TJ
from render_engine_tpu.models import primitives as PJ
from render_engine_tpu.models.bank import ModelBankBuilder as MBJ
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import textures as TXJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu.world import grid as GJ
from render_engine_tpu_torch.ecs import changes as CT
from render_engine_tpu_torch.ecs import registry as RT
from render_engine_tpu_torch.ecs import world as WT
from render_engine_tpu_torch.ecs.transform_builder import \
    EntityTransformBuilder as ETBT
from render_engine_tpu_torch.logic import collision as COLT
from render_engine_tpu_torch.logic import kinematics as KT
from render_engine_tpu_torch.logic.types import InputState as TInput
from render_engine_tpu_torch.math import aabb as AT
from render_engine_tpu_torch.math import camera as CAMT
from render_engine_tpu_torch.math import transforms as TT
from render_engine_tpu_torch.models import primitives as PT
from render_engine_tpu_torch.models.bank import ModelBankBuilder as MBT
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import textures as TXT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT
from render_engine_tpu_torch.world import grid as GT

from test_torch_frame import H, JAX_PK, RASTER, TORCH_PK, WIDTH, build
from torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)


def tt(a):
    a = np.asarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.tensor(a)


def close(t, j, **tol):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **(tol or TOL))


def same(t, j):
    j = np.asarray(j)
    if j.dtype == np.uint32:
        j = j.view(np.int32)
    np.testing.assert_array_equal(np.asarray(t), j)


# ---------------------------------------------------------------- InputState
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_input_edges(seed):
    rng = np.random.default_rng(seed)
    keys, prev = rng.random(16) < 0.5, rng.random(16) < 0.5
    mouse = np.zeros(2, np.float32)
    ij = JInput(keys=keys, mouse_delta=mouse, rng_seed=np.uint32(3),
                prev_keys=prev)
    it = TInput(keys=keys, mouse_delta=mouse, rng_seed=3, prev_keys=prev)
    dev = it.to_device("cpu")
    for i in range(16):
        for name in ("pressed", "released", "held"):
            want = bool(getattr(ij, name)(i))
            assert bool(getattr(it, name)(i)) == want
            assert bool(getattr(dev, name)(i)) == want
    assert any(it.pressed(i) for i in range(16))
    assert any(it.released(i) for i in range(16))
    assert any(it.held(i) for i in range(16))


# --------------------------------------------------------------------- math
@pytest.fixture(scope="module")
def boxes():
    rng = np.random.default_rng(7)
    mn = rng.uniform(-50, 50, (12, 3)).astype(np.float32)
    mx = mn + rng.uniform(0.1, 20, (12, 3)).astype(np.float32)
    p = rng.uniform(-60, 60, (12, 3)).astype(np.float32)
    p[:4] = 0.5 * (mn[:4] + mx[:4])  # some points inside
    pts = rng.uniform(-5, 5, (12, 9, 3)).astype(np.float32)
    q = rng.normal(size=(12, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    s = rng.uniform(0.5, 3.0, (12, 3)).astype(np.float32)
    return dict(mn=mn, mx=mx, p=p, pts=pts, q=q, s=s)


def test_aabb_from_points_translate_combine(boxes):
    b = boxes
    for t, j in zip(AT.from_points(tt(b["pts"])),
                    AJ.from_points(jnp.asarray(b["pts"]))):
        same(t, j)
    for t, j in zip(AT.translate(tt(b["mn"]), tt(b["mx"]), tt(b["p"])),
                    AJ.translate(b["mn"], b["mx"], b["p"])):
        same(t, j)
    mn2, mx2 = np.roll(b["mn"], 1, 0), np.roll(b["mx"], 1, 0)
    for t, j in zip(AT.combine(tt(b["mn"]), tt(b["mx"]), tt(mn2), tt(mx2)),
                    AJ.combine(b["mn"], b["mx"], mn2, mx2)):
        same(t, j)


def test_aabb_contains_and_distances(boxes):
    b = boxes
    mn, mx, p = b["mn"], b["mx"], b["p"]
    inside = AT.contains_point(tt(mn), tt(mx), tt(p))
    same(inside, AJ.contains_point(mn, mx, p))
    assert inside[:4].all() and not inside.all()
    close(AT.bounding_sphere_radius(tt(mn), tt(mx)),
          AJ.bounding_sphere_radius(mn, mx))
    # norms of differences of coordinates up to 110: 1e-5 absolute
    close(AT.distance_to_point(tt(mn), tt(mx), tt(p)),
          AJ.distance_to_point(mn, mx, p), rtol=1e-6, atol=1e-5)
    exact = AT.exact_distance_to_point(tt(mn), tt(mx), tt(p))
    close(exact, AJ.exact_distance_to_point(mn, mx, p), rtol=1e-6, atol=1e-5)
    assert (exact[:4] == 0).all() and (exact[4:] > 0).any()


def test_compose_apply_and_aabb_transform(boxes):
    b = boxes
    mt = TT.compose_trs(tt(b["p"]), tt(b["q"]), tt(b["s"]))
    mj = TJ.compose_trs(jnp.asarray(b["p"]), jnp.asarray(b["q"]),
                        jnp.asarray(b["s"]))
    assert tuple(mt.shape) == (12, 4, 4)
    close(mt, mj)
    close(TT.quat_to_matrix(tt(b["q"])), TJ.quat_to_matrix(b["q"]))
    # one translation broadcast over a batch of rotations
    close(TT.compose_trs(tt(b["p"][0]), tt(b["q"]), tt(b["s"])),
          TJ.compose_trs(jnp.asarray(b["p"][0]), jnp.asarray(b["q"]),
                         jnp.asarray(b["s"])))
    mj_np = np.asarray(mj)
    # |coordinates| up to 60 + 3 * 5: 1e-5 absolute
    close(TT.apply_transform(tt(mj_np), tt(b["pts"])),
          TJ.apply_transform(mj, jnp.asarray(b["pts"])), rtol=1e-6,
          atol=1e-5)
    for t, j in zip(AT.transform(tt(b["mn"]), tt(b["mx"]), tt(mj_np)),
                    AJ.transform(jnp.asarray(b["mn"]), jnp.asarray(b["mx"]),
                                 mj)):
        close(t, j, rtol=1e-6, atol=2e-4)  # corners up to 70 scaled by 3
    new_t = b["p"][::-1].copy()
    ut = TT.translation_update(tt(mj_np), tt(new_t))
    same(ut, TJ.translation_update(mj, jnp.asarray(new_t)))
    assert not torch.equal(ut, tt(mj_np))
    same(TT.quat_identity((3, 2)), TJ.quat_identity((3, 2)))
    same(TT.quat_identity(), TJ.quat_identity())


def test_orthographic_camera_matrices():
    assert (CAMT.PERSPECTIVE, CAMT.ORTHOGRAPHIC) == (CAMJ.PERSPECTIVE,
                                                    CAMJ.ORTHOGRAPHIC)

    def make(cb):
        return (cb().with_position(3.0, 4.0, 5.0)
                .with_yaw_pitch_degrees(-70.0, 10.0).with_aspect(2.0)
                .with_near_far(0.5, 80.0).with_orthographic(12.0).build())

    ct, cj = make(CAMT.CameraBuilder), make(CAMJ.CameraBuilder)
    assert ct.projection_kind == cj.projection_kind == CAMJ.ORTHOGRAPHIC
    assert ct.ortho_half_extent == cj.ortho_half_extent == 12.0
    close(ct.projection_matrix(), cj.projection_matrix())
    close(ct.proj_view(), cj.proj_view(), rtol=1e-6, atol=1e-5)
    close(ct.frustum_planes(), cj.frustum_planes(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("half_extent", [4.0, 7.0])
def test_orthographic_frame_matches(half_extent):
    """The test_frame_tiled scene through an orthographic camera, fused
    tiled path in both packages (JAX: Pallas interpret mode)."""
    wj, bj, cj, _ = build(JAX_PK, False)
    wt, bt, ct, _ = build(TORCH_PK, False)
    cj = dataclasses.replace(cj, projection_kind=CAMJ.ORTHOGRAPHIC,
                             ortho_half_extent=half_extent)
    ct = dataclasses.replace(ct, projection_kind=CAMT.ORTHOGRAPHIC,
                             ortho_half_extent=half_extent)
    sj = FJ.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           backend="pallas", fused_shading=True,
                           raster=RCJ(chunk=4, **RASTER), max_point_lights=4)
    st = FT.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           fused_shading=True, raster=RCT(**RASTER),
                           max_point_lights=4)
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, sj))
    img_t = FT.render_frame(wt, ct, bt, st)
    persp = FT.render_frame(wt, dataclasses.replace(
        ct, projection_kind=CAMT.PERSPECTIVE), bt, st)
    assert not torch.allclose(img_t, persp, atol=1e-2)
    assert float(img_t.max()) > 0.5
    diff = np.abs(img_t.numpy() - img_j)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = FT.to_srgb_u8(img_t).numpy()
    b = FT.to_srgb_u8(torch.tensor(img_j)).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()


# ---------------------------------------------------------------------- ECS
CAP = 48


def seeded_world(seed, n=30):
    """The same seeded world in both packages: ``n`` entities in a
    128-unit world of 16-unit sections, clustered so that cells fill."""
    rng = np.random.default_rng(seed)
    pos = (60.0 + rng.uniform(-20, 20, (n, 3))).astype(np.float32)
    pos[:6] = 64.0 + rng.uniform(-1, 1, (6, 3))  # one crowded cell
    kw = dict(
        position=pos,
        velocity=rng.uniform(-1, 1, (n, 3)).astype(np.float32),
        orientation=np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        scale=rng.uniform(0.5, 2.0, (n, 3)).astype(np.float32),
        type_id=rng.integers(0, 3, n).astype(np.int32),
        model_id=np.zeros(n, np.int32),
        flags=np.full(n, RJ.FLAG_COLLIDABLE, np.uint32))
    kw["flags"][5] |= RJ.FLAG_USER
    q = rng.normal(size=(n, 4)).astype(np.float32)
    kw["orientation"] = q / np.linalg.norm(q, axis=1, keepdims=True)
    out = []
    for W, K, mk in ((WJ, KJ, jnp.asarray), (WT, KT, tt)):
        w = W.create_world(W.WorldConfig(capacity=CAP, world_length=128.0,
                                         section_length=16.0))
        w, _ = W.spawn_host(w, n, **kw)
        half = np.full((1, 3), 1.0, np.float32)
        half[0, 0] = 3.0
        w = K.refresh_transforms(w, mk(-half), mk(half), w.alive)
        out.append(w)
    return out


def assert_worlds_equal(wt, wj):
    same(wt.alive, wj.alive)
    same(wt.comp_mask, wj.comp_mask)
    for name, col in wj.comps.items():
        col = np.asarray(col)
        if col.dtype.kind in "iu":
            same(wt[name], col)
        else:
            close(wt[name], col)


def test_world_get_count_user_index():
    wj, wt = seeded_world(1)
    assert wt.get("position") is wt["position"]
    assert int(wt.count_alive()) == int(wj.count_alive()) == 30
    assert int(wt.user_index()) == int(wj.user_index()) == 5
    assert RT.MAX_REF_EDGES == RJ.MAX_REF_EDGES == wt["ref_edges"].shape[1]
    assert_worlds_equal(wt, wj)


def test_world_transforms():
    wj, wt = seeded_world(2)
    close(KT.world_transforms(wt), KJ.world_transforms(wj))
    idx = np.array([0, 7, 29])
    m = KT.world_transforms(wt, torch.as_tensor(idx))
    close(m, KJ.world_transforms(wj, idx))
    close(m[:, :3, 3], np.asarray(wj["position"])[idx])


def _masks(rng, p=0.4):
    return rng.random(CAP) < p


def test_with_flags_and_merge():
    wj, wt = seeded_world(3)
    rng = np.random.default_rng(30)
    m1, m2, m3 = _masks(rng), _masks(rng), _masks(rng)
    vals = rng.uniform(-1, 1, (CAP, 3)).astype(np.float32)
    vals2 = rng.uniform(-1, 1, (CAP, 3)).astype(np.float32)
    out = []
    for C, R, w, mk in ((CJ, RJ, wj, jnp.asarray), (CT, RT, wt, tt)):
        a = C.empty_changeset(w, spawn_budget=4)
        a = C.with_flags(a, set_mask=mk(m1), set_bits=R.FLAG_STATIC,
                         clear_mask=mk(m2), clear_bits=R.FLAG_COLLIDABLE)
        a = C.with_flags(a, set_mask=mk(m3), set_bits=R.FLAG_EMISSIVE)
        a = C.with_update(a, "velocity", mk(vals), mk(m1))
        b = C.empty_changeset(w)
        b = C.with_update(b, "velocity", mk(vals2), mk(m2))
        b = C.with_update(b, "acceleration", mk(vals), mk(m3))
        b = C.with_flags(b, clear_mask=mk(m3), clear_bits=R.FLAG_STATIC)
        b = C.with_despawn(b, mk(m1 & m2 & m3))
        merged = C.merge(a, b)
        assert merged.spawns is a.spawns
        out.append(C.apply_changeset(w, merged))
        with pytest.raises(ValueError):
            C.merge(a, C.empty_changeset(w, spawn_budget=2))
    assert_worlds_equal(out[1], out[0])
    wt2 = out[1]
    # b's velocity wins where both wrote; a static flag set by a and
    # cleared by b ends cleared
    both = torch.as_tensor(m1 & m2) & wt2.alive
    close(wt2["velocity"][both], vals2[both.numpy()])
    st = torch.as_tensor(m1 & m3) & wt2.alive
    assert st.any() and not (wt2["flags"][st] & RT.FLAG_STATIC).any()


def test_references_add_remove_despawn():
    """Add edges (duplicates and a full owner drop), remove one, merge the
    two change sets, then despawn an owner whose child follows it."""
    wj, wt = seeded_world(4)
    rng = np.random.default_rng(40)
    owners = np.zeros(CAP, bool)
    owners[[1, 2, 3, 9]] = True
    steps = [rng.integers(10, 30, CAP).astype(np.int32) for _ in range(6)]
    steps[1] = steps[0].copy()  # a duplicate add: no-op
    steps[2][3] = -1  # a negative id: dropped
    remove = steps[0].copy()
    parent = np.full(30, -1, np.int32)
    parent[20] = 2  # entity 20 is owned by entity 2
    kill = np.zeros(CAP, bool)
    kill[2] = True
    worlds = []
    for C, W, w, mk in ((CJ, WJ, wj, jnp.asarray), (CT, WT, wt, tt)):
        col = np.asarray(w["parent"]).copy()
        col[:30] = parent
        w = w.replace(parent=mk(col))
        for other in steps:  # six adds into four slots: the last two drop
            cs = C.with_add_reference(C.empty_changeset(w), w, mk(owners),
                                      mk(other))
            w = C.apply_changeset(w, cs)
        full = w
        a = C.with_remove_reference(C.empty_changeset(w), w, mk(owners),
                                    mk(remove))
        b = C.with_despawn(C.empty_changeset(w), mk(kill))
        w = C.apply_changeset(w, C.merge(a, b))
        worlds.append((full, w))
    (fj, ej), (ft, et) = worlds
    assert_worlds_equal(ft, fj)
    assert_worlds_equal(et, ej)
    edges = ft["ref_edges"].numpy()
    assert (edges[1] >= 0).all() and (edges[0] == -1).all()
    assert len(set(edges[1].tolist())) == 4  # set semantics
    after = et["ref_edges"].numpy()
    assert (after[1] == remove[1]).sum() == 0 and (after[1] >= 0).sum() == 3
    assert not bool(et.alive[2]) and not bool(et.alive[20])
    assert bool(ft.alive[20])


# ------------------------------------------------------- grid and collisions
@pytest.mark.parametrize("budget", [2, 8])
def test_neighbor_candidates_and_section_count(budget):
    wj, wt = seeded_world(5)
    gj, gt = GJ.build_grid(wj), GT.build_grid(wt)
    qk = np.asarray(gj.keys)[:30]
    cj, vj = GJ.neighbor_candidates(gj, jnp.asarray(qk), wj.config, budget)
    ct, vt = GT.neighbor_candidates(gt, tt(qk), wt.config, budget)
    assert tuple(ct.shape) == (30, 27 * budget)
    same(vt, vj)
    same(ct[vt], np.asarray(cj)[np.asarray(vj)])
    assert bool(vt.any())
    assert int(GT.occupied_section_count(gt)) == \
        int(GJ.occupied_section_count(gj)) > 1


@pytest.mark.parametrize("large_budget", [0, 8])
def test_first_hit_of_type(large_budget):
    wj, wt = seeded_world(6)
    cam = np.array([64.0, 64.0, 64.0], np.float32)
    qm = np.asarray(wj.alive)
    rj = COLJ.find_collisions(wj, GJ.build_grid(wj), jnp.asarray(cam),
                              jnp.asarray(qm), per_cell_budget=8,
                              query_budget=32, large_budget=large_budget)
    rt = COLT.find_collisions(wt, GT.build_grid(wt), tt(cam), tt(qm),
                              per_cell_budget=8, query_budget=32,
                              large_budget=large_budget)
    hits = 0
    for type_index in (-1, 0, 1, 2):
        oj, hj = rj.first_hit_of_type(wj, type_index)
        ot, ht = rt.first_hit_of_type(wt, type_index)
        same(ht, hj)
        same(ot, oj)
        hits += int(ht.sum())
        if type_index >= 0 and bool(ht.any()):
            assert (wt["type_id"][ot[ht].long()] == type_index).all()
    assert hits > 0
    with pytest.raises(NotImplementedError):
        rt.any_hit()
    with pytest.raises(NotImplementedError):
        rj.any_hit()


# ------------------------------------------------------- models and textures
def test_skybox_cube_and_bank_lookups():
    for a, b in zip(PT.skybox_cube(), PJ.skybox_cube()):
        same(a, b)
    banks = []
    for MB, P, TX in ((MBT, PT, TXT), (MBJ, PJ, TXJ)):
        ab = TX.TextureAtlasBuilder(layer_size=64)
        t0 = ab.add_checkerboard(a=(1.0, 0.8, 0.2), b=(0.1, 0.2, 0.9),
                                 cells=4)
        rng = np.random.default_rng(8)
        t1 = ab.add_image(rng.random((20, 36, 3)).astype(np.float32))
        bb = MB()
        m = bb.add_material(albedo=(1, 1, 1), texture=t0,
                            texture_shininess=t1, shininess=20.0)
        bb.add_model("box", P.cube(1.0), material=m)
        bb.add_model("sky", P.skybox_cube())
        banks.append((bb.finalize(), ab.finalize()))
    (bt, at), (bj, aj) = banks
    assert bt.model_index("sky") == bj.model_index("sky") == 1
    with pytest.raises(ValueError):
        bt.model_index("nope")
    assert bt.has_shininess_maps() and bj.has_shininess_maps()
    same(bt.mat_texture_shin, bj.mat_texture_shin)
    assert int(bt.mat_texture_shin[1]) >= 0
    plain = MBT()
    plain.add_model("box", PT.cube(1.0))
    assert not plain.finalize().has_shininess_maps()
    assert at.wasted_fraction() == pytest.approx(aj.wasted_fraction(),
                                                 abs=1e-7)
    assert 0.0 < at.wasted_fraction() < 1.0


# --------------------------------------------------------- transform builder
def _spec(cls, R):
    return (cls().with_translation(1.0, 2.0, 3.0).with_velocity(0.5, 0.0, 0.0)
            .with_acceleration(0.0, -1.0, 0.0)
            .with_rotation((0, 1, 0), np.pi / 2)
            .with_rotation_velocity((0.1, 0.2, 0.3)).with_scale(2.0)
            .collidable().static().always_logic()
            .as_light(R.SORTABLE_POINT))


def test_transform_builder_spawn_kwargs():
    kt = _spec(ETBT, RT).spawn_kwargs(count=2, model_id=0, type_id=7)
    kj = _spec(ETBJ, RJ).spawn_kwargs(count=2, model_id=0, type_id=7)
    assert list(kt) == list(kj)
    for name in kj:
        assert kt[name].dtype == kj[name].dtype, name
        np.testing.assert_allclose(kt[name], kj[name], **TOL, err_msg=name)
    wt = WT.create_world(WT.WorldConfig(capacity=8))
    wt, _ = WT.spawn_host(wt, 2, **kt)
    wj = WJ.create_world(WJ.WorldConfig(capacity=8))
    wj, _ = WJ.spawn_host(wj, 2, **kj)
    assert_worlds_equal(wt, wj)
    assert bool(wt.flag_set(RT.FLAG_STATIC)[0])
    m = KT.world_transforms(wt, torch.tensor([0]))[0].numpy()
    np.testing.assert_allclose(m[:3, 3], [1, 2, 3], atol=1e-6)
    # rotated pi/2 about y with scale 2: the x axis maps to -z * 2
    np.testing.assert_allclose(m[:3, 0], [0, 0, -2], atol=1e-5)


def test_transform_builder_serialize_roundtrip():
    b = ETBT().with_translation(4, 5, 6).as_light(RT.SORTABLE_POINT)
    d = b.serialize()
    assert d == ETBJ().with_translation(4, 5, 6).as_light(
        RJ.SORTABLE_POINT).serialize()
    b2 = ETBT.deserialize(d)
    kw1, kw2 = b.spawn_kwargs(), b2.spawn_kwargs()
    assert list(kw1) == list(kw2)
    for k in kw1:
        np.testing.assert_array_equal(kw1[k], kw2[k])
