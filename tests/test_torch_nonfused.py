"""The non-fused tiled path, the route of a custom ``shadow_factor`` on the
tiled backends: K1, the G-buffers of both layers in the tall tile layout
(``tall_gbuffer``: K2 over every tile and its chain on the CPU) and
``lighting.shade``, held to the JAX package's
``backend="pallas", fused_shading=False`` frame (interpret mode, CPU) and
to the port's own fused frame. The port reaches the path with a callback
that shadows nothing (``unshadowed``) or with the callback its golden path
builds from a ``ShadowState`` (``shadows_of``).

Scenes: the frame scene of tests/test_torch_frame.py, plain and "featured"
(every texture role: a checker albedo, spec, emissive and tilted normal
maps on the cubes, a dissolve map on the glass pane, two shininess
values, so the rows carry the packed (spec, Ns) channel); with a point
light's shadow maps (tests/test_torch_shadow_frame.py); with a system that
shades its own pixels (tests/test_torch_render_systems.py); the frame
scene at 200 pixels wide, whose last tile column is partial
(tests/test_torch_partial_tiles.py).

Tolerances:
* ``render_gbuffers_pallas`` against JAX's on the same triangle batch:
  winners, materials and depths exact, except that the winner may differ
  where two candidates tie on depth exactly; every float
  plane within 1e-5 (positions also relative 1e-5: they are near 64);
* frames against JAX: max abs diff <= 2/255 and at most 0.1% of the u8
  values differing, as tests/test_torch_frame.py holds the fused frame;
* the port's non-fused frame against its fused frame: the JAX package's
  own limits (tests/test_frame_tiled.py:103-110): 99.5% of pixels within
  1e-2, max < 0.05, median 0; with shadows max < 0.05 at
  ``shadow_tile_budget=1.0``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import geometry as GJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.render import render_system as RSJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu_torch import convert
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import lighting as LT
from render_engine_tpu_torch.render import raster_pallas as RPT
from render_engine_tpu_torch.render import render_system as RST
from render_engine_tpu_torch.render import shade_pallas as SPT
from render_engine_tpu_torch.render import shadows as SHT
from render_engine_tpu_torch.render import tall_gbuffer as TG
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

import test_torch_partial_tiles as TPT
from deferred_scenes import featured
import test_torch_render_systems as TRS
from test_torch_frame import H, JAX_PK, RASTER, TORCH_PK, WIDTH, build
from test_torch_shadow_frame import frame_scene
from test_torch_shadows import JAX, TORCH
from torch_threads import one_torch_thread  # noqa: F401

SCENES = ["plain", "featured"]


@pytest.fixture(autouse=True)
def pallas_shadows(monkeypatch):
    monkeypatch.setattr(FJ, "pick_rasterizer",
                        lambda backend="auto":
                        RPJ.rasterize_depth_winner_pallas)


def scene(pk, name):
    return featured(pk) if name == "featured" else build(pk, False)


def settings(**kw):
    """JAX's non-fused settings and the port's fused ones (a
    ``shadow_factor`` takes them to the non-fused path)."""
    sj = FJ.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           backend="pallas", fused_shading=False,
                           raster=RCJ(chunk=4, **RASTER), max_point_lights=4,
                           **kw)
    st = FT.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           fused_shading=True, raster=RCT(**RASTER),
                           max_point_lights=4, **kw)
    return sj, st


def unshadowed(kind, i, pos):
    """A ``shadow_factor`` that shadows nothing: the port's non-fused frame
    without shadows."""
    return 1.0


def shadows_of(sh, world, s):
    """The ``shadow_factor`` the golden path builds from ``sh`` for the
    lights a frame of ``s`` extracts: the port's non-fused frame with the
    shadow maps."""
    lights = LT.extract_lights(world, max_dir=s.max_dir_lights,
                               max_point=s.max_point_lights,
                               max_spot=s.max_spot_lights)
    return SHT.make_shadow_factor(sh, world, {"dir": lights.dir_entity,
                                              "spot": lights.sp_entity,
                                              "point": lights.pt_entity})


def assert_images_close(img_t, img_j):
    img_j = np.asarray(img_j)
    assert tuple(img_t.shape) == img_j.shape
    assert torch.isfinite(img_t).all()
    diff = np.abs(img_t.numpy() - img_j)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = FT.to_srgb_u8(img_t).numpy()
    b = FT.to_srgb_u8(torch.tensor(img_j)).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()


def assert_jax_limits(a, b, shadows=False):
    """The JAX package's fused-against-non-fused limits."""
    diff = (a - b).abs().amax(dim=-1)
    assert float(diff.max()) < 0.05, float(diff.max())
    if not shadows:
        assert float((diff < 1e-2).double().mean()) > 0.995
        assert float(diff.median()) <= 1e-5


@pytest.mark.parametrize("name", SCENES)
def test_render_gbuffers_matches_reference(name):
    wj, bj, cj, _ = scene(JAX_PK, name)
    _, bt, ct, _ = scene(TORCH_PK, name)
    batch = GJ.to_screen(GJ.build_triangle_batch(wj, bj, cj, max_tris=256),
                         WIDTH, H)
    tbatch = convert.triangle_batch_from_numpy(
        {f.name: np.asarray(getattr(batch, f.name))
         for f in dataclasses.fields(batch)})
    out_j = RPJ.render_gbuffers_pallas(batch, bj, H, WIDTH, RCJ(**RASTER),
                                       interpret=True,
                                       proj_view=cj.proj_view())
    out_t = RPT.render_gbuffers_pallas(tbatch, bt, H, WIDTH, RCT(**RASTER),
                                       proj_view=ct.proj_view())
    for layer in (0, 2):
        gj, exj = out_j[layer], out_j[layer + 1]
        gt, ext = out_t[layer], out_t[layer + 1]
        np.testing.assert_array_equal(gt.depth.numpy(), np.asarray(gj.depth))
        tri_t, tri_j = gt.tri_id.numpy(), np.asarray(gj.tri_id)
        same = tri_t == tri_j
        # the one allowed difference: an exact depth tie (equal depths are
        # asserted above)
        assert same.mean() > 0.99, (~same).sum()
        assert (tri_t >= 0).any()
        np.testing.assert_array_equal(gt.material.numpy()[same],
                                      np.asarray(gj.material)[same])
        for f in ("position", "normal", "albedo"):
            np.testing.assert_allclose(getattr(gt, f).numpy()[same],
                                       np.asarray(getattr(gj, f))[same],
                                       rtol=1e-5, atol=1e-5, err_msg=f)
        assert set(ext) >= set(exj) - {"tangent", "tangent_w"}
        for k in exj:
            if k in ext:
                np.testing.assert_allclose(ext[k].numpy()[same],
                                           np.asarray(exj[k])[same],
                                           rtol=1e-5, atol=1e-5, err_msg=k)
    # the packed (spec, Ns) channel gives a shininess plane
    assert ("shininess" in out_t[1]) == (name == "featured")
    assert (out_t[3]["alpha"] < 1.0).any()  # the glass pane's layer


@pytest.mark.parametrize("name", SCENES)
def test_nonfused_frame_matches_reference(name):
    wj, bj, cj, aj = scene(JAX_PK, name)
    wt, bt, ct, at = scene(TORCH_PK, name)
    sj, st = settings()
    img_j = FJ.render_frame(wj, cj, bj, sj, atlas=aj)
    img_t = FT.render_frame(wt, ct, bt, st, atlas=at,
                            shadow_factor=unshadowed)
    assert_images_close(img_t, img_j)
    assert float(img_t.max()) > 0.9
    if name == "featured":
        assert (bt.has_specular_maps() and bt.has_emissive_maps()
                and bt.has_normal_maps() and bt.has_dissolve_maps()
                and bt.uniform_shininess() is None)


@pytest.fixture(scope="module")
def shadowed():
    """The shadow-frame scene in both packages with a point light's
    cube-face maps, each rendered by its own package (six updates)."""
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
    finally:
        mp.undo()
    return out


def test_shadowed_nonfused_frame_matches_reference(shadowed):
    wt, bt, ct, sht = shadowed["t"]
    wj, bj, cj, shj = shadowed["j"]
    sj, st = settings()
    img_j = FJ.render_frame(wj, cj, bj, sj, shadow_state=shj)
    img_t = FT.render_frame(wt, ct, bt, st,
                            shadow_factor=shadows_of(sht, wt, st))
    assert_images_close(img_t, img_j)
    plain = FT.render_frame(wt, ct, bt, st, shadow_factor=unshadowed)
    assert (img_t <= plain + 1e-5).all()
    assert (img_t < plain - 1e-3).any()


def test_custom_shading_nonfused_frame_matches_reference():
    (wj, bj, cj), (wt, bt, ct), cube, star = TRS._both_scenes(TRS.scene)

    def systems(rs, bank, shade):
        return rs.compile_systems((
            rs.RenderSystemBuilder("n").with_models(cube)
            .write_uniform("tone", 0.8).with_fragment_shading(shade).build(),
            rs.RenderSystemBuilder("s").with_models(star).build()), bank)

    sj = dataclasses.replace(TRS.jax_settings("pallas"), fused_shading=False)
    st = TRS.settings()
    sys_t = systems(RST, bt, TRS.fancy)
    img_j = FJ.render_frame(wj, cj, bj, sj,
                            systems=systems(RSJ, bj, TRS.fancy_jnp))
    img_t = FT.render_frame(wt, ct, bt, st, systems=sys_t,
                            shadow_factor=unshadowed)
    assert_images_close(img_t, img_j)
    # the function shades the cube's pixels and no others
    plain = FT.render_frame(wt, ct, bt, st, systems=RST.compile_systems((
        RST.RenderSystemBuilder("n").with_models(cube).build(),
        RST.RenderSystemBuilder("s").with_models(star).build()), bt),
        shadow_factor=unshadowed)
    changed = (img_t != plain).any(dim=-1)
    assert changed[:, TRS.LEFT].any() and not changed[:, TRS.RIGHT].any()
    # and agrees with the fused path's hook
    fused = FT.render_frame(wt, ct, bt, st, systems=sys_t)
    assert_jax_limits(img_t, fused)


@pytest.mark.parametrize("name", SCENES)
def test_nonfused_frame_matches_fused_frame(name):
    w, bank, cam, atlas = scene(TORCH_PK, name)
    _, st = settings()
    a = FT.render_frame(w, cam, bank, st, atlas=atlas,
                        shadow_factor=unshadowed)
    b = FT.render_frame(w, cam, bank, st, atlas=atlas)
    assert_jax_limits(a, b)


def test_shadowed_nonfused_frame_matches_fused_frame(shadowed):
    w, bank, cam, sh = shadowed["t"]
    assert int((sh.slot_entity >= 0).sum()) >= 1
    _, st = settings(shadow_tile_budget=1.0)
    a = FT.render_frame(w, cam, bank, st,
                        shadow_factor=shadows_of(sh, w, st))
    b = FT.render_frame(w, cam, bank, st, shadow_state=sh)
    assert_jax_limits(a, b, shadows=True)
    assert not torch.equal(a, FT.render_frame(w, cam, bank, st,
                                              shadow_factor=unshadowed))


def test_custom_shadow_factor_takes_the_nonfused_path(shadowed, monkeypatch):
    """On the default backend a ``shadow_factor`` callback renders through
    K1, the tall G-buffers of both layers over every tile
    (``tall_gbuffer``) and ``lighting.shade``: K3 never runs, and the frame
    is JAX's non-fused frame with the same callback."""
    import jax.numpy as jnp

    w, bank, cam, _ = shadowed["t"]
    wj, bj, cj, _ = shadowed["j"]
    sj, st = settings()

    def factor(kind, i, pos):  # shade the left half
        return torch.where(pos[..., 0:1] < 64.0, 0.5, 1.0)

    def factor_jnp(kind, i, pos):
        return jnp.where(pos[..., 0:1] < 64.0, 0.5, 1.0)

    resolved = []
    real = TG.tall_gbuffer

    def spy(layers, *a, **kw):
        resolved.extend(slot.shape[0] for slot, _, _ in layers)
        return real(layers, *a, **kw)

    def no_k3(*a, **kw):
        raise AssertionError("K3 ran on the non-fused path")

    monkeypatch.setattr(TG, "tall_gbuffer", spy)
    monkeypatch.setattr(SPT, "shade_tiles", no_k3)
    got = FT.render_frame(w, cam, bank, st, shadow_factor=factor)
    nt = -(-WIDTH // 128) * -(-H // 8)
    assert resolved == [nt, nt]
    assert_images_close(got, FJ.render_frame(wj, cj, bj, sj,
                                             shadow_factor=factor_jnp))
    assert not torch.equal(got, FT.render_frame(w, cam, bank, st,
                                                shadow_factor=unshadowed))


@pytest.mark.parametrize("height", [48, 44])
def test_nonfused_frame_on_a_partial_tile(height):
    """200 pixels wide: the tall layout's pixel centers and the untile
    cover the last tile column, 72 pixels wide (and at 44 rows the last
    tile row, 4 high), textured, against JAX's non-fused frame."""
    width = 200
    wj, bj, cj, aj = build(JAX_PK, True)
    wt, bt, ct, at = build(TORCH_PK, True)
    cj = TPT.with_aspect(cj, width, height)
    ct = TPT.with_aspect(ct, width, height)
    sj, st = TPT.settings(width, height)
    sj = dataclasses.replace(sj, fused_shading=False)
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, sj, atlas=aj))
    img_t = FT.render_frame(wt, ct, bt, st, atlas=at,
                            shadow_factor=unshadowed)
    TPT.assert_images_close(img_t, img_j, width, height)
    assert (img_t[:, 128:] > 0.05).any()
