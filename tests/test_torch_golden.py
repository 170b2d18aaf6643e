"""The port's golden path (``lighting.shade``, the image-layout raster and
G-buffer resolve, ``sample_atlas``, the shadow-factor callback, cubemap
skyboxes, ``RenderSettings(backend="jnp")``) against the JAX package's, on
the CPU, from numpy-seeded inputs.

Tolerances:
* ``shade`` on the same G-buffer and lights: 1e-5 (rtol and atol);
* ``rasterize_depth_winner`` on the same screen-space batch: the golden
  rasters of the two packages form their edge functions differently (the
  port uses K1's fused forms), so a pixel centre on an edge or a depth tie
  may flip: winners equal on at least 99.5% of pixels, depths within 1e-5
  where the winners agree;
* ``resolve_gbuffer`` given the same depth and winner images: 1e-4 on
  positions (coordinates near 64), 1e-5 on normals, albedo and the map
  images; material and triangle ids exact;
* ``sample_atlas``, ``sample_cubemap``, ``sample_cubemap_rows``: 1e-6;
  ``cubemap_rows`` and ``starfield_cubemap``: exact;
* ``slot_factors`` / ``make_shadow_factor`` given the same shadow state:
  factors are multiples of 1/9, equal but where a position sits on a
  texel or depth boundary (at most 0.5% of values);
* golden frame against the port's fused frame: as the JAX tests hold
  theirs (``test_frame_tiled.py``): 98% of pixels within 2e-2, median 0;
  with shadows max 0.05;
* golden frame against the JAX golden frame: 2/255, at most 0.5% of the u8
  values differing (edge pixels of the two golden rasters).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from render_engine_tpu.models import primitives as PJ
from render_engine_tpu.models.bank import ModelBankBuilder as MBJ
from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import geometry as GJ
from render_engine_tpu.render import lighting as LJ
from render_engine_tpu.render import raster_jnp as RJJ
from render_engine_tpu.render import shadows as SHJ
from render_engine_tpu.render import skybox as SBJ
from render_engine_tpu.render import textures as TXJ
from render_engine_tpu.render.gbuffer import GBuffer as GBJ
from render_engine_tpu_torch import convert
from render_engine_tpu_torch.models import primitives as PT
from render_engine_tpu_torch.models.bank import ModelBankBuilder as MBT
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import lighting as LT
from render_engine_tpu_torch.render import raster_jnp as RJT
from render_engine_tpu_torch.render import shadows as SHT
from render_engine_tpu_torch.render import skybox as SBT
from render_engine_tpu_torch.render import textures as TXT
from render_engine_tpu_torch.render.gbuffer import (GBuffer as GBT,
                                                    empty_gbuffer)

from test_torch_frame import H, JAX_PK, RASTER, TORCH_PK, WIDTH, build
from test_torch_shadows import JAX, light_and_blocker

GH, GW = 24, 40


def _materials(mb, primitives):
    bb = mb()
    bb.add_material(albedo=(1.0, 0.1, 0.1), specular=0.5, shininess=16.0)
    bb.add_material(albedo=(0.9, 0.9, 0.6), emissive=3.0)
    bb.add_material(albedo=(0.2, 0.9, 0.4), specular=2.0, shininess=200.0)
    bb.add_model("cube", primitives.cube(1.0), material=0)
    return bb.finalize()


def gbuffer_arrays(seed):
    rng = np.random.default_rng(seed)
    nrm = rng.normal(size=(GH, GW, 3))
    nrm /= np.linalg.norm(nrm, axis=-1, keepdims=True)
    tri = rng.integers(-1, 30, (GH, GW)).astype(np.int32)
    return dict(
        depth=rng.uniform(-1, 1, (GH, GW)).astype(np.float32),
        position=(64.0 + rng.uniform(-8, 8, (GH, GW, 3))).astype(np.float32),
        normal=nrm.astype(np.float32),
        albedo=rng.uniform(0, 1, (GH, GW, 3)).astype(np.float32),
        material=np.where(tri >= 0, rng.integers(0, 3, (GH, GW)),
                          -1).astype(np.int32),
        tri_id=tri)


def light_arrays(seed, nd=2, npt=13, ns=3):
    """Seeded ``LightArrays`` fields: 2 directional (1 live), 13 point (11
    live, some with a radius that cuts inside the scene), 3 spot (2 live)."""
    rng = np.random.default_rng(seed)
    f = np.float32

    def col(n):
        return rng.uniform(0.1, 1.0, (n, 3)).astype(f)

    def pos(n):
        return (64.0 + rng.uniform(-10, 10, (n, 3))).astype(f)

    return dict(
        dir_direction=rng.normal(size=(nd, 3)).astype(f),
        dir_diffuse=col(nd), dir_specular=col(nd), dir_ambient=col(nd) * f(0.1),
        dir_count=np.int32(1), dir_entity=np.arange(nd, dtype=np.int32),
        pt_position=pos(npt), pt_diffuse=col(npt), pt_specular=col(npt),
        pt_ambient=col(npt) * f(0.05),
        pt_atten=rng.uniform(0.0, 0.1, (npt, 2)).astype(f),
        pt_radius=np.where(rng.random(npt) < 0.5, rng.uniform(4, 12, npt),
                           0.0).astype(f),
        pt_count=np.int32(11), pt_entity=np.arange(npt, dtype=np.int32) + 10,
        sp_position=pos(ns), sp_direction=rng.normal(size=(ns, 3)).astype(f),
        sp_diffuse=col(ns), sp_specular=col(ns), sp_ambient=col(ns) * f(0.05),
        sp_atten=rng.uniform(0.0, 0.05, (ns, 2)).astype(f),
        sp_cutoff=np.tile(np.array([[np.cos(0.5), np.cos(0.9)]], f), (ns, 1)),
        sp_count=np.int32(2), sp_entity=np.arange(ns, dtype=np.int32) + 40)


@pytest.mark.parametrize("variant", ["plain", "shadow_factor", "images"])
def test_shade_matches_reference(variant):
    g, la = gbuffer_arrays(3), light_arrays(4)
    bank_j, bank_t = _materials(MBJ, PJ), _materials(MBT, PT)
    assert bank_t.uniform_shininess() is None  # per-material exponents
    gj = GBJ(**{k: jnp.asarray(v) for k, v in g.items()})
    gt = GBT(**{k: torch.tensor(v) for k, v in g.items()})
    lj = LJ.LightArrays(**{k: jnp.asarray(v) for k, v in la.items()})
    lt = LT.LightArrays(**{k: torch.tensor(v) for k, v in la.items()})
    rng = np.random.default_rng(5)
    bg = rng.uniform(0, 1, (GH, GW, 3)).astype(np.float32)
    cam = np.array([64.0, 66.0, 80.0], np.float32)
    kw_j, kw_t = {}, {}
    if variant == "shadow_factor":
        # darker left of x = 64, by light kind and index
        scale = {"dir": 0.2, "point": 0.5, "spot": 0.8}
        kw_j["shadow_factor"] = lambda kind, i, p: jnp.where(
            p[..., 0:1] < 64.0, scale[kind] / (1 + i), 1.0)
        kw_t["shadow_factor"] = lambda kind, i, p: torch.where(
            p[..., 0:1] < 64.0, scale[kind] / (1 + i), 1.0)
    if variant == "images":
        imgs = dict(
            emissive_image=np.where(rng.random((GH, GW)) < 0.2, 2.0,
                                    0.0).astype(np.float32),
            specular_image=rng.uniform(0, 2, (GH, GW)).astype(np.float32),
            shininess_image=rng.integers(1, 300, (GH, GW)).astype(np.float32))
        kw_j = {k: jnp.asarray(v) for k, v in imgs.items()}
        kw_t = {k: torch.tensor(v) for k, v in imgs.items()}
    want = np.asarray(LJ.shade(gj, lj, bank_j, jnp.asarray(cam),
                               background=jnp.asarray(bg), **kw_j))
    got = LT.shade(gt, lt, bank_t, torch.tensor(cam),
                   background=torch.tensor(bg), **kw_t).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(got[g["tri_id"] < 0], bg[g["tri_id"] < 0])
    assert (got[g["tri_id"] >= 0] > 0).any()


def test_empty_gbuffer_shades_to_background():
    g = empty_gbuffer(4, 6)
    assert g.shape == (4, 6) and not g.covered().any()
    lt = LT.LightArrays(**{k: torch.tensor(v)
                           for k, v in light_arrays(4).items()})
    bg = torch.full((4, 6, 3), 0.25)
    out = LT.shade(g, lt, _materials(MBT, PT), torch.zeros(3),
                   background=bg)
    assert torch.equal(out, bg)


def _screen_batches(textured):
    """The frame scene's screen-space triangle batch from the JAX package,
    and the same arrays as the port's batch."""
    wj, bj, cj, aj = build(JAX_PK, textured)
    _, bt, _, at = build(TORCH_PK, textured)
    batch_j = GJ.to_screen(GJ.build_triangle_batch(wj, bj, cj, max_tris=256),
                           WIDTH, H)
    batch_t = convert.triangle_batch_from_numpy(
        {f.name: np.asarray(getattr(batch_j, f.name))
         for f in dataclasses.fields(batch_j)})
    return batch_j, batch_t, bj, bt, aj, at


@pytest.mark.parametrize("layer", ["opaque", "transparent"])
def test_golden_raster_matches_reference(layer):
    batch_j, batch_t, *_ = _screen_batches(False)
    mj = batch_j.transparent if layer == "transparent" \
        else ~batch_j.transparent
    mt = batch_t.transparent if layer == "transparent" \
        else ~batch_t.transparent
    dj, wj = RJJ.rasterize_depth_winner(batch_j, H, WIDTH,
                                        RJJ.RasterConfig(chunk=4, **RASTER),
                                        mj)
    dt, wt = RJT.rasterize_depth_winner(batch_t, H, WIDTH,
                                        RJT.RasterConfig(**RASTER), mt)
    dj, wj = np.asarray(dj), np.asarray(wj)
    assert wt.dtype == torch.int32 and tuple(wt.shape) == (H, WIDTH)
    same = wt.numpy() == wj
    assert same.mean() >= 0.995, (~same).sum()
    np.testing.assert_allclose(dt.numpy()[same], dj[same], rtol=0, atol=1e-5)
    assert (wj >= 0).sum() > 50  # the layer is really drawn
    # chunking does not change the result
    d2, w2 = RJT.rasterize_depth_winner(batch_t, H, WIDTH,
                                        RJT.RasterConfig(**RASTER), mt,
                                        chunk=5)
    assert torch.equal(w2, wt) and torch.equal(d2, dt)


def test_golden_raster_agrees_with_k1_inside_the_port():
    """The golden raster and K1 (its plain version here) share the fused
    edge forms: with budgets that drop nothing, winners and depths of both
    layers are equal bit for bit."""
    from render_engine_tpu_torch.render import raster_pallas as RPT

    _, batch_t, *_ = _screen_batches(False)
    cfg = RJT.RasterConfig(**RASTER)
    d, w, td, tw = RPT.rasterize_two_pass_pallas(batch_t, H, WIDTH, cfg)
    gd, gw = RJT.rasterize_depth_winner(batch_t, H, WIDTH, cfg,
                                        ~batch_t.transparent)
    gtd, gtw = RJT.rasterize_depth_winner(batch_t, H, WIDTH, cfg,
                                          batch_t.transparent)
    assert torch.equal(gw, w) and torch.equal(gd, d)
    assert torch.equal(gtw, tw) and torch.equal(gtd, td)


@pytest.mark.parametrize("textured", [False, True])
def test_resolve_gbuffer_matches_reference(textured):
    batch_j, batch_t, bj, bt, aj, at = _screen_batches(textured)
    dj, wj = RJJ.rasterize_depth_winner(batch_j, H, WIDTH,
                                        RJJ.RasterConfig(chunk=4, **RASTER),
                                        ~batch_j.transparent)
    flags = dict(with_specular=textured, with_emissive=textured,
                 with_dissolve=textured)
    out_j = RJJ.resolve_gbuffer(batch_j, bj, dj, wj, atlas=aj, **flags)
    out_t = RJT.resolve_gbuffer(batch_t, bt, torch.tensor(np.asarray(dj)),
                                torch.tensor(np.asarray(wj)), atlas=at,
                                **flags)
    if textured:
        # the images follow the G-buffer in flag order: spec, emis, diss
        assert len(out_t) == len(out_j) == 4
        for a, b in zip(out_t[1:], out_j[1:]):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-5)
        gt, gj = out_t[0], out_j[0]
        only_diss = RJT.resolve_gbuffer(
            batch_t, bt, torch.tensor(np.asarray(dj)),
            torch.tensor(np.asarray(wj)), atlas=at, with_dissolve=True)
        assert len(only_diss) == 2 and torch.equal(only_diss[1], out_t[3])
    else:
        gt, gj = out_t, out_j
    np.testing.assert_array_equal(gt.material.numpy(), np.asarray(gj.material))
    np.testing.assert_array_equal(gt.tri_id.numpy(), np.asarray(gj.tri_id))
    np.testing.assert_allclose(gt.position.numpy(), np.asarray(gj.position),
                               rtol=0, atol=1e-4)
    for name in ("normal", "albedo", "depth"):
        np.testing.assert_allclose(getattr(gt, name).numpy(),
                                   np.asarray(getattr(gj, name)), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    # render_gbuffer is the raster then the resolve
    rg = RJT.render_gbuffer(batch_t, bt, H, WIDTH, RJT.RasterConfig(**RASTER),
                            ~batch_t.transparent, atlas=at)
    assert (rg.tri_id >= 0).sum() > 50


def test_sample_atlas_matches_reference():
    def atlas(tx):
        ab = tx.TextureAtlasBuilder(layer_size=32)
        rng = np.random.default_rng(8)
        for shape in ((32, 32), (16, 24), (8, 8)):
            ab.add_image(rng.uniform(0, 1, shape + (3,)).astype(np.float32))
        return ab.finalize()

    aj, at = atlas(TXJ), atlas(TXT)
    rng = np.random.default_rng(9)
    tex = rng.integers(-1, 4, (17, 23)).astype(np.int32)
    uv = rng.uniform(-1.5, 2.5, (17, 23, 2)).astype(np.float32)
    want = np.asarray(TXJ.sample_atlas(aj, jnp.asarray(tex), jnp.asarray(uv)))
    got = TXT.sample_atlas(at, torch.tensor(tex), torch.tensor(uv)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_shadow_factor_callback_matches_reference():
    wj, bj, cj = light_and_blocker(JAX)
    sh_j = SHJ.create_shadow_state(resolution=64, budget=3, pcf_scale=2)
    sh_j = SHJ.render_shadow_map(sh_j, wj, cj, bj, max_tris=256)
    sh_t = convert.shadow_state_from_numpy(
        np.asarray(sh_j.maps), np.asarray(sh_j.light_mats),
        np.asarray(sh_j.slot_entity), np.asarray(sh_j.slot_face),
        sh_j.cursor, sh_j.tick, sh_j.resolution, sh_j.pcf_scale)
    assert int((sh_t.slot_entity >= 0).sum()) == 1
    rng = np.random.default_rng(12)
    # positions under the light, around the blocker's shadow on the ground
    pos = (np.array([64.0, 2.0, 64.0])
           + rng.uniform(-6, 6, (21, 31, 3)) * np.array([1.0, 0.3, 1.0])
           ).astype(np.float32)
    want = np.asarray(SHJ.slot_factors(sh_j, jnp.asarray(pos)))
    got = SHT.slot_factors(sh_t, torch.tensor(pos)).numpy()
    assert got.shape == want.shape == (3, 21, 31)
    assert (np.abs(got - want) > 1e-6).mean() <= 5e-3
    assert got.min() < 0.5 and got.max() == 1.0  # some shadow, some light
    np.testing.assert_array_equal(got[1:], 1.0)  # unmapped slots are lit

    owner = int(sh_t.slot_entity[0])
    ents = {"spot": np.array([owner, -1], np.int32),
            "point": np.array([owner + 1], np.int32)}
    fj = SHJ.make_shadow_factor(sh_j, wj,
                                {k: jnp.asarray(v) for k, v in ents.items()})
    ft = SHT.make_shadow_factor(sh_t, None,
                                {k: torch.tensor(v) for k, v in ents.items()})
    pj, pt = jnp.asarray(pos), torch.tensor(pos)
    for kind, i in (("spot", 0), ("spot", 1), ("point", 0)):
        a, b = ft(kind, i, pt).numpy(), np.asarray(fj(kind, i, pj))
        assert a.shape == b.shape == (21, 31, 1)
        assert (np.abs(a - b) > 1e-6).mean() <= 5e-3, (kind, i)
    assert ft("spot", 0, pt).min() < 0.5  # the owner is shadowed
    assert float(ft("spot", 1, pt).min()) == 1.0  # an empty light row
    assert float(ft("point", 0, pt).min()) == 1.0  # owns no slot
    assert ft("dir", 0, pt) == 1.0  # a kind with no entity map


def _settings(pk, backend, **kw):
    if pk is FJ:
        return FJ.RenderSettings(
            width=WIDTH, height=H, max_tris=256, backend=backend,
            raster=RJJ.RasterConfig(chunk=4, **RASTER), max_point_lights=4,
            **kw)
    return FT.RenderSettings(width=WIDTH, height=H, max_tris=256,
                             backend=backend, fused_shading=True,
                             raster=RJT.RasterConfig(**RASTER),
                             max_point_lights=4, **kw)


@pytest.mark.parametrize("textured", [False, True])
def test_golden_frame_matches_fused_frame(textured):
    """Mirrors test_frame_tiled.py::test_matches_jnp_path inside the port:
    the fused tiled frame against the golden one."""
    w, bank, cam, atlas = build(TORCH_PK, textured)
    stars = SBT.make_starfield(128, seed=5)
    fused = FT.render_frame(w, cam, bank, _settings(FT, "auto"),
                            cubemap=stars, atlas=atlas)
    golden = FT.render_frame(w, cam, bank, _settings(FT, "jnp"),
                             cubemap=stars, atlas=atlas)
    assert golden.shape == fused.shape == (H, WIDTH, 3)
    diff = (golden - fused).abs().amax(dim=-1)
    assert float((diff < 2e-2).double().mean()) > 0.98, float(diff.max())
    assert float(diff.median()) <= 1e-5
    with pytest.raises(ValueError, match="backend"):
        FT.render_frame(w, cam, bank, _settings(FT, "opengl"))


def _shadowed(pk_name):
    from test_torch_shadows import TORCH

    pk, frame = (JAX, FJ) if pk_name == "jax" else (TORCH, FT)
    w, bank, cam, _ = build(JAX_PK if pk_name == "jax" else TORCH_PK, False)
    sh = pk.SH.create_shadow_state(resolution=64, budget=4, pcf_scale=1)
    for _ in range(6):  # the point light comes to own several cube faces
        sh = pk.render(sh, w, cam, bank, max_tris=256,
                       raster_cfg=_settings(frame, "jnp").raster)
    return w, bank, cam, sh


def test_golden_frame_with_shadows_matches_fused_frame():
    """Mirrors test_fused_shading_with_shadows_matches_tall_path: K3's slot
    factors against ``make_shadow_factor`` through ``lighting.shade``; and
    a custom ``shadow_factor`` takes the non-fused tiled path."""
    w, bank, cam, sh = _shadowed("torch")
    assert int((sh.slot_entity >= 0).sum()) >= 1
    fused = FT.render_frame(w, cam, bank, _settings(FT, "auto"),
                            shadow_state=sh)
    golden = FT.render_frame(w, cam, bank, _settings(FT, "jnp"),
                             shadow_state=sh)
    assert float((golden - fused).abs().max()) < 0.05
    unshadowed = FT.render_frame(w, cam, bank, _settings(FT, "jnp"))
    assert (golden <= unshadowed + 1e-5).all()
    assert not torch.equal(golden, unshadowed)
    # a callback that shadows nothing, on the default backend: the
    # non-fused tiled frame, the fused frame without shadows but for the
    # rounding of the two paths
    lit = FT.render_frame(w, cam, bank, _settings(FT, "auto"),
                          shadow_state=sh,
                          shadow_factor=lambda kind, i, p: 1.0)
    torch.testing.assert_close(
        lit, FT.render_frame(w, cam, bank, _settings(FT, "auto")), rtol=0,
        atol=1e-6)


@pytest.mark.parametrize("case", ["plain", "textured", "shadows"])
def test_golden_frame_matches_reference_golden_frame(case):
    if case == "shadows":
        wj, bj, cj, sj = _shadowed("jax")
        wt, bt, ct, st = _shadowed("torch")
        aj = at = None
    else:
        wj, bj, cj, aj = build(JAX_PK, case == "textured")
        wt, bt, ct, at = build(TORCH_PK, case == "textured")
        sj = st = None
    img_j = np.asarray(FJ.render_frame(
        wj, cj, bj, _settings(FJ, "jnp"), atlas=aj, shadow_state=sj,
        cubemap=SBJ.make_starfield(128, seed=5)))
    img_t = FT.render_frame(wt, ct, bt, _settings(FT, "jnp"), atlas=at,
                            shadow_state=st,
                            cubemap=SBT.make_starfield(128, seed=5))
    assert torch.isfinite(img_t).all()
    diff = np.abs(img_t.numpy() - img_j).max(axis=-1)
    a = FT.to_srgb_u8(img_t).numpy()
    b = FT.to_srgb_u8(torch.tensor(img_j)).numpy()
    assert (a != b).mean() <= 5e-3, (a != b).sum()
    assert np.median(diff) <= 1e-6
    assert (diff > 2.0 / 255.0).mean() <= 5e-3, diff.max()
    assert img_t.max() > 0.9  # the emissive star


def test_cubemap_sampling_matches_reference():
    rng = np.random.default_rng(21)
    faces = rng.uniform(0, 1, (6, 16, 16, 3)).astype(np.float32)
    dirs = rng.normal(size=(33, 47, 3))
    # axis-aligned and diagonal directions sit on face boundaries
    dirs[0, :6] = [[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0], [0, 0, 1],
                   [0, 0, -1]]
    dirs[1, :3] = [[1, 1, 0], [0, 1, 1], [1, 1, 1]]
    dirs = (dirs / np.linalg.norm(dirs, axis=-1, keepdims=True)).astype(
        np.float32)
    cm_t = convert.cubemap_from_numpy(faces)
    want = np.asarray(SBJ.sample_cubemap(jnp.asarray(faces),
                                         jnp.asarray(dirs)))
    got = SBT.sample_cubemap(cm_t, torch.tensor(dirs)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    rows_j, rows_t = SBJ.cubemap_rows(faces), SBT.cubemap_rows(cm_t)
    assert rows_t.size == rows_j.size == 16
    np.testing.assert_array_equal(rows_t.rows.numpy(),
                                  np.asarray(rows_j.rows))
    got_rows = SBT.sample_cubemap_rows(rows_t, torch.tensor(dirs)).numpy()
    np.testing.assert_allclose(
        got_rows, np.asarray(SBJ.sample_cubemap_rows(rows_j,
                                                     jnp.asarray(dirs))),
        rtol=0, atol=1e-6)
    np.testing.assert_allclose(got_rows, got, rtol=0, atol=1e-6)


def test_cubemap_background_matches_reference():
    _, _, cj, _ = build(JAX_PK, False)
    _, _, ct, _ = build(TORCH_PK, False)
    faces_j = SBJ.starfield_cubemap(64)
    faces_t = SBT.starfield_cubemap(64)
    np.testing.assert_array_equal(faces_t.numpy(), np.asarray(faces_j))
    np.testing.assert_allclose(
        SBT.pixel_ray_directions(ct, H, WIDTH).numpy(),
        np.asarray(SBJ.pixel_ray_directions(cj, H, WIDTH)), rtol=0,
        atol=1e-6)
    # nearest-texel stars: a last-bit difference in a ray can move a
    # sample across a texel, so compare through the smooth row sampler's
    # tolerance on all but a few pixels
    for kind_j, kind_t in ((faces_j, faces_t),
                           (SBJ.cubemap_rows(faces_j),
                            SBT.cubemap_rows(faces_t))):
        want = np.asarray(SBJ.background_for(cj, kind_j, H, WIDTH))
        got = SBT.background_for(ct, kind_t, H, WIDTH).numpy()
        assert got.shape == (H, WIDTH, 3)
        assert (np.abs(got - want).max(axis=-1) > 1e-5).mean() <= 2e-3
    assert got.max() > 0.2  # a star is in view


def test_frame_over_a_cubemap_background():
    """The fused and the golden frame take a cubemap skybox: background
    pixels are the sampled cubemap."""
    w, bank, cam, _ = build(TORCH_PK, False)
    faces = SBT.starfield_cubemap(64)
    bg = SBT.background_for(cam, faces, H, WIDTH)
    for backend in ("auto", "jnp"):
        img = FT.render_frame(w, cam, bank, _settings(FT, backend),
                              cubemap=faces)
        assert torch.equal(img[0, :8], bg[0, :8].clamp(0, 1))
        rows = FT.render_frame(w, cam, bank, _settings(FT, backend),
                               cubemap=SBT.cubemap_rows(faces))
        torch.testing.assert_close(rows, img, rtol=0, atol=1e-6)
