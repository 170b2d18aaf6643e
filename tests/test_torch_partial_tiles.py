"""Frames whose width (or height) is not a multiple of the raster tile: the
last tile column (row) is partly outside the image. The port's fused tiled
frame against the JAX package's forced Pallas route (interpret mode), CPU.

Sizes: 200x48 (2 tile columns, the last 72 pixels wide), 328x40 (3 columns,
the last 72 wide) and 200x44 (the last tile row 4 pixels high), on the
scene of tests/test_frame_tiled.py, plain, textured with a starved texture
tile budget (the tile selection carries tile ids), and with a point light's
shadow maps (the per-slot factor tiles and K3's ``pixel_origin`` grids).

Tolerances: K1's depth and winner images on the same triangle batch exact
(both layers); images as tests/test_torch_frame.py holds them: max abs
diff <= 2/255 and at most 0.1% of the u8 values differing. The JAX shadow
raster is patched to its Pallas path, as in tests/test_torch_shadows.py.
"""

import dataclasses

import numpy as np
import pytest
import torch

from render_engine_tpu.render import frame as FJ
from render_engine_tpu.render import geometry as GJ
from render_engine_tpu.render import raster_pallas as RPJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu_torch import convert
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import raster_pallas as RPT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

from test_torch_frame import JAX_PK, RASTER, TORCH_PK, build
from test_torch_shadow_frame import frame_scene
from test_torch_shadows import JAX, TORCH
from torch_threads import one_torch_thread  # noqa: F401

SIZES = [(200, 48), (328, 40), (200, 44)]


@pytest.fixture(autouse=True)
def pallas_shadows(monkeypatch):
    monkeypatch.setattr(FJ, "pick_rasterizer",
                        lambda backend="auto":
                        RPJ.rasterize_depth_winner_pallas)


def settings(width, height, **kw):
    sj = FJ.RenderSettings(width=width, height=height, max_tris=256,
                           backend="pallas", fused_shading=True,
                           raster=RCJ(chunk=4, **RASTER), max_point_lights=4,
                           **kw)
    st = FT.RenderSettings(width=width, height=height, max_tris=256,
                           raster=RCT(**RASTER), max_point_lights=4, **kw)
    return sj, st


def with_aspect(cam, width, height):
    """The scene's camera at this frame's aspect, moved left so that the
    cluster (6 units ahead at x = 64) lands in the middle of the last,
    partial tile column."""
    last = (width // 128) * 128
    f = 0.5 * (last + width) / width
    tan_h = (2.0 * f - 1.0) * (width / height) * np.tan(np.pi / 6)
    shift = np.array([-6.0 * tan_h, 0.0, 0.0], np.float32)
    if isinstance(cam.position, torch.Tensor):
        pos = cam.position + torch.from_numpy(shift)
    else:
        pos = cam.position + shift
    return dataclasses.replace(cam, aspect=width / height, position=pos)


def assert_images_close(img_t, img_j, width, height):
    assert tuple(img_t.shape) == img_j.shape == (height, width, 3)
    assert torch.isfinite(img_t).all()
    diff = np.abs(img_t.numpy() - img_j)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = FT.to_srgb_u8(img_t).numpy()
    b = FT.to_srgb_u8(torch.tensor(img_j)).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()


@pytest.mark.parametrize("width,height", SIZES)
def test_k1_winners_exact_on_a_partial_tile(width, height):
    """Both packages rasterize the JAX package's triangle batch: depth and
    winner of the opaque and the transparent layer, cropped to the image,
    agree bit for bit, and the last tile column holds winners."""
    w, bank, cam = frame_scene(JAX)
    cam = with_aspect(cam, width, height)
    batch = GJ.to_screen(GJ.build_triangle_batch(w, bank, cam, max_tris=256),
                         width, height)
    tbatch = convert.triangle_batch_from_numpy(
        {f.name: np.asarray(getattr(batch, f.name))
         for f in dataclasses.fields(batch)})
    outs_j = RPJ.rasterize_two_pass_pallas(batch, height, width,
                                           RCJ(**RASTER), interpret=True)
    outs_t = RPT.rasterize_two_pass_pallas(tbatch, height, width,
                                           RCT(**RASTER))
    for t, j in zip(outs_t, outs_j):
        assert tuple(t.shape) == (height, width)
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
    winner, t_winner = outs_t[1], outs_t[3]
    last = (width // 128) * 128
    assert (winner[:, last:] >= 0).any()
    if width == 200:  # at 328x40 the pane lies outside the frame
        assert (t_winner >= 0).any()


@pytest.mark.parametrize("width,height", SIZES)
@pytest.mark.parametrize("textured,tex_budget", [(False, 1.0), (True, 0.5)])
def test_frame_matches_on_a_partial_tile(width, height, textured,
                                         tex_budget):
    wj, bj, cj, aj = build(JAX_PK, textured)
    wt, bt, ct, at = build(TORCH_PK, textured)
    cj, ct = with_aspect(cj, width, height), with_aspect(ct, width, height)
    sj, st = settings(width, height, texture_tile_budget=tex_budget)
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, sj, atlas=aj))
    img_t = FT.render_frame(wt, ct, bt, st, atlas=at)
    assert_images_close(img_t, img_j, width, height)
    # geometry reaches into the last, partial tile column
    last = (width // 128) * 128
    assert float(img_t[:, last:].max()) > 0.2
    assert float(img_t.max()) > 0.9


@pytest.fixture(scope="module")
def shadowed():
    """The frame scene in both packages with a point light's cube-face
    maps, each rendered by its own package (six updates)."""
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


@pytest.mark.parametrize("width,height", SIZES[:2])
@pytest.mark.parametrize("budget", [1.0, 0.5])
def test_shadowed_frame_matches_on_a_partial_tile(shadowed, width, height,
                                                  budget):
    wt, bt, ct, sht = shadowed["t"]
    wj, bj, cj, shj = shadowed["j"]
    cj, ct = with_aspect(cj, width, height), with_aspect(ct, width, height)
    sj, st = settings(width, height, shadow_tile_budget=budget)
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, sj, shadow_state=shj))
    img_t = FT.render_frame(wt, ct, bt, st, shadow_state=sht)
    assert_images_close(img_t, img_j, width, height)
    plain = FT.render_frame(wt, ct, bt, st)
    assert (img_t <= plain + 1e-5).all()
    if budget == 1.0:
        assert (img_t < plain - 1e-3).any()
