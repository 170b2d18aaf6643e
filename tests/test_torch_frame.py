"""The port's ``render_frame`` (tiled fused path: binning, K1, K2 on the
texture-budgeted tiles, K3, compose) against the JAX package's on the
scene of ``tests/test_frame_tiled.py`` (CPU; the JAX side runs its Pallas
kernels in interpret mode with ``backend="pallas", fused_shading=True``).

The port builds the same scene with its own builders from the same numpy
inputs, so the test also holds the port's model bank, atlas, world columns
and starfield to the reference's. Images: max abs diff <= 2/255 and at
most 0.1% of the u8 values differing (a last-bit difference in a
triangle's screen position can move a pixel centre across an edge).
"""

import dataclasses

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
from render_engine_tpu.render import skybox as SBJ
from render_engine_tpu.render import textures as TXJ
from render_engine_tpu.render.raster_jnp import RasterConfig as RCJ
from render_engine_tpu_torch import convert
from render_engine_tpu_torch.ecs import registry as RT
from render_engine_tpu_torch.ecs import world as WT
from render_engine_tpu_torch.logic import kinematics as KT
from render_engine_tpu_torch.math.camera import CameraBuilder as CBT
from render_engine_tpu_torch.models import primitives as PT
from render_engine_tpu_torch.models.bank import ModelBankBuilder as MBT
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import skybox as SBT
from render_engine_tpu_torch.render import textures as TXT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

H, WIDTH = 32, 128
RASTER = dict(tile_budget=32, max_tiles_per_tri=8, global_budget=16)


def build(pk, textured, capacity=16):
    """The test_frame_tiled scene (cube, emissive star with a point light,
    glass pane) in package ``pk``; ``textured`` gives the cubes a
    checkerboard."""
    P, MB, W, R, K, CB, TX = pk
    atlas = None
    bb = MB()
    tex = -1
    if textured:
        ab = TX.TextureAtlasBuilder(layer_size=64)
        tex = ab.add_checkerboard(a=(1.0, 0.8, 0.2), b=(0.1, 0.2, 0.9),
                                  cells=4)
        atlas = ab.finalize()
    red = bb.add_material(albedo=(1.0, 0.1, 0.1), texture=tex)
    glow = bb.add_material(albedo=(1.0, 0.9, 0.6), emissive=4.0)
    glass = bb.add_material(albedo=(0.2, 0.9, 0.4), alpha=0.4)
    cube = bb.add_model("cube", P.cube(1.5), material=red)
    star = bb.add_model("star", P.uv_sphere(0.7, 6, 8), material=glow)
    pane = bb.add_model("pane", P.quad(2.0), material=glass)
    bank = bb.finalize()
    w = W.create_world(W.WorldConfig(capacity=capacity, world_length=128.0,
                                     section_length=16.0))
    w, _ = W.spawn_host(
        w, 4,
        position=np.array([[62.0, 64.0, 58.0], [66.0, 64.0, 58.0],
                           [64.0, 65.5, 57.0], [64.0, 64.0, 60.5]],
                          np.float32),
        model_id=np.array([cube, star, cube, pane], np.int32),
        sortable=np.array([0, R.SORTABLE_POINT, 0, 0], np.int32),
        light_diffuse=np.array([[0, 0, 0], [1.0, 0.9, 0.8], [0, 0, 0],
                                [0, 0, 0]], np.float32),
        light_atten=np.array([[0, 0], [0.05, 0.01], [0, 0], [0, 0]],
                             np.float32))
    w = K.refresh_transforms(w, bank.aabb_min, bank.aabb_max, w.alive)
    cam = (CB().with_position(64.0, 64.0, 64.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(WIDTH / H).with_near_far(0.1, 100.0)
           .with_draw_distance(100.0).build())
    return w, bank, cam, atlas


JAX_PK = (PJ, MBJ, WJ, RJ, KJ, CBJ, TXJ)
TORCH_PK = (PT, MBT, WT, RT, KT, CBT, TXT)


@pytest.mark.parametrize("textured,tex_budget", [(False, 1.0), (True, 1.0),
                                                 (True, 0.5)])
def test_render_frame_matches_reference(textured, tex_budget):
    wj, bj, cj, aj = build(JAX_PK, textured)
    wt, bt, ct, at = build(TORCH_PK, textured)

    # the port's builders reproduce the reference's scene state
    for f in convert.BANK_FIELDS:
        np.testing.assert_array_equal(getattr(bt, f).numpy(),
                                      np.asarray(getattr(bj, f)), err_msg=f)
    np.testing.assert_array_equal(wt.alive.numpy(), np.asarray(wj.alive))
    for name, col in wj.comps.items():
        np.testing.assert_allclose(
            wt.comps[name].numpy(),
            np.asarray(col).view(np.int32) if col.dtype == jnp.uint32
            else np.asarray(col), rtol=1e-6, atol=1e-6, err_msg=name)
    np.testing.assert_allclose(ct.serialize().numpy(),
                               np.asarray(cj.serialize()), rtol=0, atol=0)
    if textured:
        np.testing.assert_array_equal(at.layers.numpy(),
                                      np.asarray(aj.layers))
        np.testing.assert_array_equal(at.uv_rect.numpy(),
                                      np.asarray(aj.uv_rect))

    stars_j = SBJ.make_starfield(128, seed=5)
    stars_t = SBT.make_starfield(128, seed=5)
    np.testing.assert_array_equal(stars_t.dirs.numpy(),
                                  np.asarray(stars_j.dirs))
    sj = FJ.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           backend="pallas", fused_shading=True,
                           raster=RCJ(chunk=4, **RASTER), max_point_lights=4,
                           texture_tile_budget=tex_budget)
    st = FT.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           fused_shading=True, raster=RCT(**RASTER),
                           max_point_lights=4,
                           texture_tile_budget=tex_budget)
    img_j = np.asarray(FJ.render_frame(wj, cj, bj, sj, cubemap=stars_j,
                                       atlas=aj))
    img_t = FT.render_frame(wt, ct, bt, st, cubemap=stars_t, atlas=at)
    assert img_t.shape == img_j.shape == (H, WIDTH, 3)
    assert torch.isfinite(img_t).all()
    diff = np.abs(img_t.numpy() - img_j)
    assert diff.max() <= 2.0 / 255.0, diff.max()
    a = FT.to_srgb_u8(img_t).numpy()
    b = FT.to_srgb_u8(torch.tensor(img_j)).numpy()
    assert (a != b).mean() <= 1e-3, (a != b).sum()
    # the scene is really there: the emissive star saturates and the
    # pane tints what it covers
    assert img_t.max() > 0.9
    assert (img_t[..., 1] > img_t[..., 2]).any()


def test_converted_state_renders_like_native():
    """convert.py carries the JAX scene across: the port renders the
    converted world/bank/camera/starfield exactly like its own build."""
    wj, bj, cj, _ = build(JAX_PK, False)
    wt, bt, ct, _ = build(TORCH_PK, False)
    wc = convert.world_from_numpy(
        wt.config, np.asarray(wj.alive), np.asarray(wj.comp_mask),
        {k: np.asarray(v) for k, v in wj.comps.items()})
    bc = convert.bank_from_numpy(
        {f: np.asarray(getattr(bj, f)) for f in convert.BANK_FIELDS},
        bj.names)
    cc = convert.camera_from_serialized(np.asarray(cj.serialize()), ct)
    stars_j = SBJ.make_starfield(64, seed=2)
    sc = convert.starfield_from_numpy(np.asarray(stars_j.dirs),
                                      np.asarray(stars_j.colors))
    st = FT.RenderSettings(width=WIDTH, height=H, max_tris=256,
                           raster=RCT(**RASTER), max_point_lights=4)
    a = FT.render_frame(wc, cc, bc, st, cubemap=sc)
    b = FT.render_frame(wt, ct, bt, st, cubemap=SBT.make_starfield(64,
                                                                   seed=2))
    torch.testing.assert_close(a, b, rtol=0, atol=2e-7)
    assert dataclasses.is_dataclass(wc)
