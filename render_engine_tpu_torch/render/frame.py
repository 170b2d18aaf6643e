"""Frame composition: world -> final (H, W, 3) linear image.

Port of ``render_engine_tpu/render/frame.py``. ``render_frame`` first runs
the render systems' draw callbacks (instance gate, this frame's uniform
rows, skybox toggle), then takes one of three paths, as the JAX package's
``render_frame`` routes them:

* the fused tiled path (a tiled backend, ``"auto"`` or ``"pallas"``, with
  ``fused_shading=True`` and no ``shadow_factor``):
  ``tiled_fused_core`` runs binning, the packed candidate rows, K1 (tile
  raster, two layers), K2 (resolve of the texture-budgeted tiles) with the
  texture override, the per-slot PCF factor tiles of the shadow maps, the
  per-tile light lists (``light_tile_budget`` > 0), K3 (fused shade), then,
  for systems with a fragment-shading function, ``_fused_custom_shading``
  (both layers' G-buffers on the pixels those systems own, in one
  ``custom_gbuffer`` kernel, then the user function per layer), and the
  compose over the background;
* the non-fused tiled path (every other call on a tiled backend: the
  default ``fused_shading=False``, or a custom ``shadow_factor``, which
  cannot run inside a kernel's light loop): ``_render_frame_tiled`` runs
  K1 and K2 over every tile of both layers (``raster_pallas.gbuffers_tall``),
  then ``deferred_shade`` (the atlas, the shadow maps' PCF factor and
  Blinn-Phong of both layers in one kernel; with a callback, its plain
  version: ``shadows.make_shadow_factor``'s place taken by the callback,
  ``lighting.shade`` per layer) and the compose;
* the golden path (``backend="jnp"``): the image-layout raster and G-buffer
  resolve of ``raster_jnp.py`` and ``lighting.shade`` per layer, with the
  same systems semantics.

In a traced program (``profiling.mark``) a frame's stages are spans:
``render.geometry`` (``frame_inputs``), ``render.raster`` (binning, the
candidate rows, K1), ``render.resolve`` (K2 with the texture override),
``render.shade`` (the PCF factor tiles, light lists and K3; on the
non-fused path ``deferred_shade``), ``render.custom`` (custom shading,
only where a system has a shading function) and ``render.compose``; and
the frame keeps two of its counters, ``triangle_budget_dropped`` and
``tile_candidate_dropped`` (``profiling.count``), and on the fused path
with custom shading the three of ``CUSTOM_COUNTERS``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.render import custom_gbuffer as CG
from render_engine_tpu_torch.render import deferred_shade as DS
from render_engine_tpu_torch.render import lighting as L
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render import shadows as SHD
from render_engine_tpu_torch.render import skybox as SB
from render_engine_tpu_torch.render.geometry import (build_triangle_batch,
                                                     perturb_normal,
                                                     to_screen)
from render_engine_tpu_torch.render.raster_jnp import (
    RasterConfig, rasterize_depth_winner, resolve_gbuffer)
from render_engine_tpu_torch.render.shade_pallas import (fused_shade,
                                                         pack_lights,
                                                         select_tile_lights)
from render_engine_tpu_torch.render.textures import sample_atlas_rows
from render_engine_tpu_torch.runtime import profiling as P
from render_engine_tpu_torch.utils import consts

# "auto" and "pallas": the tiled path through the kernels (their plain
# versions on CPU tensors); "jnp": the golden image-layout path
BACKENDS = ("auto", "pallas", "jnp")
# the fused route's custom-shading counters (``_count_custom``)
CUSTOM_COUNTERS = ("custom_tiles_resolved", "custom_tiles_owned",
                   "custom_pixels")


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    width: int = 800
    height: int = 600
    max_tris: int = 16384
    raster: RasterConfig = RasterConfig()
    max_dir_lights: int = 4
    max_point_lights: int = 64
    max_spot_lights: int = 16
    clear_color: tuple = (0.0, 0.0, 0.0)
    # one of BACKENDS
    backend: str = "auto"
    # the tiled path's shading: K3 (True) or K2 over every tile and
    # lighting.shade (False, the JAX package's default)
    fused_shading: bool = False
    # atlas sampling of the transparent layer (each layer costs a resolve)
    texture_transparent: bool = False
    # fractions of screen tiles whose PCF factors (per shadow slot, among
    # the tiles inside the slot's light frustum) and textured winners are
    # computed, densest tiles first; overflow tiles stay lit / untextured
    shadow_tile_budget: float = 1.0
    texture_tile_budget: float = 1.0
    # per-tile light lists on the fused path: each tile's light loop covers
    # only the lights whose influence sphere meets its view pyramid,
    # bit-identical to the loop over every live light until a tile holds
    # more than this many (counted in light_tile_overflow). 0 = off.
    light_tile_budget: int = 0


def _gate_skybox(background, skybox_on, settings):
    """A draw callback's skybox toggle (None = as configured): off replaces
    the sampled background with the clear color."""
    if skybox_on is None:
        return background
    from render_engine_tpu_torch.render.render_system import _bool, _f32

    dev = background.device
    return torch.where(_bool(skybox_on, dev), background,
                       _f32(settings.clear_color, dev))


def render_frame(world, camera, bank, settings: RenderSettings, *,
                 cubemap=None, atlas=None, shadow_state=None,
                 shadow_factor=None, systems=None,
                 inputs=None) -> torch.Tensor:
    """Deferred-render one frame; float32 (H, W, 3) linear color.

    ``shadow_state``: a ``shadows.ShadowState`` whose maps PCF-attenuate
    the lights that own its slots (opaque layer). ``shadow_factor``: a
    custom callback (kind, index, world_pos) -> factor in its place; it
    cannot run inside K3's light loop, so the frame takes the non-fused
    tiled path whatever ``fused_shading`` says.
    ``systems``: ``render_system.CompiledSystems``, folded into the pass as
    per-triangle data, with their draw and shading callbacks. ``inputs``:
    the frame's ``InputState`` (tensors), which draw callbacks read."""
    from render_engine_tpu_torch.render import render_system as RS

    if settings.backend not in BACKENDS:
        raise ValueError(f"backend {settings.backend!r} is none of "
                         f"{BACKENDS}")
    h, w = settings.height, settings.width
    P.mark("render.geometry")
    f = frame_inputs(world, camera, bank, settings, cubemap=cubemap,
                     systems=systems, inputs=inputs)
    P.count("triangle_budget_dropped", f["batch"].total_requested,
            settings.max_tris)
    if settings.backend == "jnp":
        return _render_frame_golden(world, camera, bank, settings, **f,
                                    atlas=atlas, shadow_state=shadow_state,
                                    shadow_factor=shadow_factor,
                                    systems=systems)
    if not settings.fused_shading or shadow_factor is not None:
        return _render_frame_tiled(world, camera, bank, settings, **f,
                                   atlas=atlas, shadow_state=shadow_state,
                                   shadow_factor=shadow_factor,
                                   systems=systems)
    tri_sys = None
    if systems is not None and systems.has_shade_callbacks():
        tri_sys = RS.triangle_system_ids(f["batch"], world, systems)
    return tiled_fused_core(f["batch"], f["lights"], bank, settings, camera,
                            width=w, h_total=h, h_local=h, y_off=0.0,
                            background=f["background"],
                            ent_attrs=f["ent_attrs"], atlas=atlas,
                            shadow_state=shadow_state, systems=systems,
                            draw_ctx=f["draw_ctx"], tri_sys=tri_sys)


def frame_inputs(world, camera, bank, settings: RenderSettings, *,
                 cubemap=None, systems=None, inputs=None) -> dict:
    """What every path of a frame starts from, for the whole image: the
    draw callbacks' context (``draw_ctx``, None without callbacks), the
    screen-space triangle ``batch``, the systems' per-entity ``ent_attrs``,
    the ``lights`` and the ``background``, skybox toggle applied."""
    from render_engine_tpu_torch.render import render_system as RS

    h, w = settings.height, settings.width
    draw_ctx = None
    if systems is not None and systems.has_draw_callbacks():
        draw_ctx = RS.run_draw_callbacks(systems, world, camera, inputs, bank)
    batch = to_screen(build_triangle_batch(
        world, bank, camera, max_tris=settings.max_tris, systems=systems,
        instance_mask=None if draw_ctx is None else draw_ctx.allowed), w, h)
    ent_attrs = None
    if systems is not None:
        ent_attrs = RS.entity_shade_attrs(
            world, systems,
            sys_table=None if draw_ctx is None else draw_ctx.sys_table)
    lights = L.extract_lights(world, max_dir=settings.max_dir_lights,
                              max_point=settings.max_point_lights,
                              max_spot=settings.max_spot_lights)
    background = _gate_skybox(
        SB.background_for(camera, cubemap, h, w, settings.clear_color),
        None if draw_ctx is None else draw_ctx.skybox_on, settings)
    return dict(draw_ctx=draw_ctx, batch=batch, ent_attrs=ent_attrs,
                lights=lights, background=background)


def _render_frame_golden(world, camera, bank, settings, *, batch, lights,
                         background, ent_attrs, atlas, shadow_state,
                         shadow_factor, systems, draw_ctx) -> torch.Tensor:
    """The golden path: image-layout raster and G-buffer per layer,
    ``lighting.shade``, custom shading, then the transparent layer blended
    over the lit image (no shadow lookups on it)."""
    from render_engine_tpu_torch.render import render_system as RS

    h, w = settings.height, settings.width
    P.mark("render.raster")
    depth, winner = rasterize_depth_winner(batch, h, w, settings.raster,
                                           ~batch.transparent)
    t_depth, t_winner = rasterize_depth_winner(batch, h, w, settings.raster,
                                               batch.transparent)
    with_spec = atlas is not None and bank.has_specular_maps()
    with_emis = atlas is not None and bank.has_emissive_maps()
    # dissolve maps only matter on the transparent layer (per-pixel alpha)
    with_diss = atlas is not None and bank.has_dissolve_maps()

    def resolve(d_, wn_, dissolve):
        out = resolve_gbuffer(batch, bank, d_, wn_, atlas=atlas,
                              with_specular=with_spec,
                              with_emissive=with_emis,
                              with_dissolve=dissolve)
        if not (with_spec or with_emis or dissolve):
            return out, None, None, None
        out = list(out)
        g = out.pop(0)
        spec = out.pop(0) if (with_spec or with_emis) else None
        emis = out.pop(0) if with_emis else None
        diss = out.pop(0) if dissolve else None
        return g, spec, emis, diss

    def material(g, table):
        return table[g.material.clamp(0, table.shape[0] - 1).long()]

    gbuf, spec_img, emis_mul, _ = resolve(depth, winner, False)
    t_gbuf, t_spec_img, t_emis_mul, t_diss_mul = resolve(t_depth, t_winner,
                                                         with_diss)
    em_img = t_em_img = t_alpha = None
    if with_emis:
        em_img = material(gbuf, bank.mat_emissive) * emis_mul
        t_em_img = material(t_gbuf, bank.mat_emissive) * t_emis_mul
        t_alpha = material(t_gbuf, bank.mat_alpha).clamp(0.0, 1.0)
    if ent_attrs is not None:
        # per-pixel tint / emissive / alpha from the winner triangle's
        # entity's system row
        sa = ent_attrs[batch.entity.clamp(0, world.capacity - 1).long()]
        tri_mat_em = bank.mat_emissive[batch.material.clamp(
            0, bank.mat_emissive.shape[0] - 1).long()]
        tri_em = torch.where(sa[:, 0] > 0.5,
                             tri_mat_em.clamp(min=1.0) * sa[:, 1], tri_mat_em)

        def apply_sys(g):
            tri = g.tri_id.clamp(0, batch.budget - 1).long()
            cm = g.covered()
            alb = g.albedo * torch.where(cm[..., None], sa[tri, 2:5], 1.0)
            return (dataclasses.replace(g, albedo=alb),
                    torch.where(cm, tri_em[tri], 0.0),
                    torch.where(cm, sa[tri, 5], 1.0))

        gbuf, em_img, _ = apply_sys(gbuf)
        t_gbuf, t_em_img, t_asc = apply_sys(t_gbuf)
        if emis_mul is not None:
            em_img = em_img * emis_mul
            t_em_img = t_em_img * t_emis_mul
        t_alpha = (material(t_gbuf, bank.mat_alpha) * t_asc).clamp(0.0, 1.0)

    P.mark("render.shade")
    if shadow_factor is None and shadow_state is not None:
        shadow_factor = SHD.make_shadow_factor(
            shadow_state, world,
            {"dir": lights.dir_entity, "spot": lights.sp_entity,
             "point": lights.pt_entity})
    color = L.shade(gbuf, lights, bank, camera.position,
                    background=background, shadow_factor=shadow_factor,
                    emissive_image=em_img, specular_image=spec_img)
    shades = systems is not None and systems.has_shade_callbacks()
    if shades:
        color = RS.apply_custom_shading(color, gbuf, winner, batch, world,
                                        camera, lights, systems, draw_ctx)
    t_lit = L.shade(t_gbuf, lights, bank, camera.position, background=color,
                    emissive_image=t_em_img, specular_image=t_spec_img)
    if shades:
        t_lit = RS.apply_custom_shading(t_lit, t_gbuf, t_winner, batch,
                                        world, camera, lights, systems,
                                        draw_ctx)
    P.mark("render.compose")
    if t_alpha is None:
        t_alpha = material(t_gbuf, bank.mat_alpha)
    alpha = t_alpha[..., None]
    if t_diss_mul is not None:
        alpha = alpha * t_diss_mul[..., None]
    in_front = t_gbuf.covered() & (t_gbuf.depth <= gbuf.depth)
    color = torch.where(in_front[..., None],
                        alpha * t_lit + (1.0 - alpha) * color, color)
    return color.clamp(0.0, 1.0)


def _render_frame_tiled(world, camera, bank, settings, *, batch, lights,
                        background, ent_attrs, atlas, shadow_state,
                        shadow_factor, systems, draw_ctx) -> torch.Tensor:
    """The non-fused tiled path: the G-buffers and shading planes of both
    layers in the tall tile layout (``raster_pallas.gbuffers_tall``), the
    atlas, the shadow factor and Blinn-Phong of both layers packed for the
    compose (``deferred_shade``: the kernel, with the PCF factor of
    ``shadow_state``'s maps; with a ``shadow_factor`` callback given, the
    plain version with it), custom shading, then one untile of what the
    compose needs. The tile budgets of the fused path (shadow, texture,
    light lists) do not apply: every tile is shaded, textured and
    shadowed."""
    from render_engine_tpu_torch.render import render_system as RS

    cfg = settings.raster
    h, w = settings.height, settings.width
    th, twd = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-w // twd), -(-h // th)
    P.mark("render.raster")
    gbuf, extras, t_gbuf, t_extras = RP.gbuffers_tall(
        batch, bank, h, w, cfg, T.inv44(camera.proj_view()),
        ent_attrs=ent_attrs)
    P.mark("render.shade")
    shades = systems is not None and systems.has_shade_callbacks()
    args = (gbuf, extras, t_gbuf, t_extras, lights, bank, camera.position)
    if shadow_factor is None:
        packed, textured = DS.deferred_shade(
            *args, atlas=atlas, batch=batch, shadow_state=shadow_state,
            gbuffer_planes=shades)
    else:
        packed, textured = DS.deferred_shade_reference(
            *args, atlas=atlas, batch=batch, shadow_factor=shadow_factor,
            gbuffer_planes=shades)
    if shades:
        P.mark("render.custom")
        # the shading functions read the textured G-buffers
        gbuf, t_gbuf = textured
        color = RS.apply_custom_shading(packed[..., 0:3], gbuf, gbuf.tri_id,
                                        batch, world, camera, lights,
                                        systems, draw_ctx)
        t_lit = RS.apply_custom_shading(packed[..., 3:6], t_gbuf,
                                        t_gbuf.tri_id, batch, world, camera,
                                        lights, systems, draw_ctx)
        packed = torch.cat([color, t_lit, packed[..., 6:]], dim=-1)
    P.mark("render.compose")
    return compose(RP._untile_tall(packed, tiles_y, tiles_x, th, twd, h, w),
                   background)


def _texture_override(res, atlas, tiles_x, th, twd, tids=None,
                      with_spec=False, with_emis=False, with_norm=False,
                      with_diss=False):
    """Per-pixel texture overrides from resolved channels ``res`` (A, NT,
    th, tw): [rgb | flag] (+ spec / emissive / dissolve deltas, + the
    normal-mapped normal and flag), channels leading."""
    a, nt = res.shape[0], res.shape[1]
    ch = res.reshape(a, nt * th, twd)
    if tids is None:
        tids = torch.arange(nt, device=res.device)
    px, py = RP._tall_pixel_centers(tids, tiles_x, th, twd)

    x0, y0, x1, y1, x2, y2 = ch[0], ch[1], ch[2], ch[3], ch[4], ch[5]
    l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = l0 + l1 + l2
    one = torch.ones_like(area)
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, one)
    w0 = l0 * inv_area * ch[25]
    w1 = l1 * inv_area * ch[26]
    w2 = l2 * inv_area * ch[27]
    denom = w0 + w1 + w2
    inv_d = 1.0 / torch.where(denom.abs() > 1e-12, denom, one)
    p0, p1, p2 = w0 * inv_d, w1 * inv_d, w2 * inv_d
    u = p0 * ch[19] + p1 * ch[21] + p2 * ch[23]
    v = p0 * ch[20] + p1 * ch[22] + p2 * ch[24]
    uv = torch.stack([u, v], dim=-1)

    def sample(layer_c, rect_c):
        return sample_atlas_rows(atlas, ch[layer_c], uv,
                                 ch[rect_c:rect_c + 4].permute(1, 2, 0))

    def delta(layer_c):
        smul = sample(layer_c, layer_c + 1)[..., 0]
        return torch.where(ch[layer_c] >= 0.0, smul - 1.0,
                           torch.zeros_like(smul))[..., None]

    parts = [sample(35, 36), (ch[35] >= 0.0).to(torch.float32)[..., None]]
    if with_spec or with_emis or with_diss:
        parts.append(delta(40))
    if with_emis or with_diss:
        parts.append(delta(45))
    if with_diss:
        parts.append(delta(59))
    if with_norm:
        nrm = torch.stack([p0 * ch[10] + p1 * ch[13] + p2 * ch[16],
                           p0 * ch[11] + p1 * ch[14] + p2 * ch[17],
                           p0 * ch[12] + p1 * ch[15] + p2 * ch[18]], dim=-1)
        nlen = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
        nrm = nrm / torch.where(nlen > 1e-12, nlen, torch.ones_like(nlen))
        nsamp = sample(50, 51)
        tan = ch[55:58].permute(1, 2, 0)
        pert = perturb_normal(nrm, tan, ch[58], nsamp)
        nflag = (ch[50] >= 0.0).to(torch.float32)[..., None]
        parts.append(torch.where(nflag > 0.0, pert, torch.zeros_like(pert)))
        parts.append(nflag)
    out = torch.cat(parts, dim=-1)
    c = out.shape[-1]
    return out.permute(2, 0, 1).reshape(c, nt, th, twd)


def _tile_origins(nt, tiles_x, th, twd, y_off):
    """Each tile's top-left pixel (oy + y_off, ox) as float32 (NT,)."""
    tids = np.arange(nt)
    oy = (tids // tiles_x * th).astype(np.float32) + np.float32(y_off)
    return oy, (tids % tiles_x * twd).astype(np.float32)


# The tiling's NDC constants are computed on the host in numpy, which rounds
# each division like the JAX package's device code (CUDA turns a division
# by a host scalar into a multiply by its reciprocal), and cached on the
# device per tiling.
@consts.cached(maxsize=8)
def _tile_corner_xy(nt, tiles_x, th, twd, width, h_total, y_off, device):
    """(NT, 8, 2) float32 camera-NDC (x, y) of each tile's 8 frustum
    corners: the screen rect, twice (near and far depth)."""
    f32 = np.float32
    oy, ox = _tile_origins(nt, tiles_x, th, twd, y_off)
    x0 = ox / f32(width) * f32(2.0) - f32(1.0)
    x1 = (ox + f32(twd)) / f32(width) * f32(2.0) - f32(1.0)
    y0 = f32(1.0) - oy / f32(h_total) * f32(2.0)
    y1 = f32(1.0) - (oy + f32(th)) / f32(h_total) * f32(2.0)
    return torch.tensor(np.stack([np.stack([x0, x1, x0, x1] * 2, axis=1),
                                  np.stack([y0, y0, y1, y1] * 2, axis=1)],
                                 axis=-1), device=device)


@consts.cached(maxsize=8)
def _pixel_ndc(nt, tiles_x, th, twd, width, h_total, y_off, k, device):
    """(2, NT, ceil(th/k), ceil(tw/k)) float32 camera-NDC (x, y) of every
    k-th pixel center of each tile."""
    f32 = np.float32
    oy, ox = _tile_origins(nt, tiles_x, th, twd, y_off)
    py = oy[:, None, None] + np.arange(0, th, k, dtype=f32)[None, :, None] \
        + f32(0.5)
    px = ox[:, None, None] + np.arange(0, twd, k, dtype=f32)[None, None, :] \
        + f32(0.5)
    shape = (nt, py.shape[1], px.shape[2])
    return torch.tensor(np.stack([
        np.broadcast_to(px, shape) / f32(width) * f32(2.0) - f32(1.0),
        f32(1.0) - np.broadcast_to(py, shape) / f32(h_total) * f32(2.0)]),
        device=device)


def _tile_frustum_inputs(d, wn, tiles_x, th, twd, width, h_total, y_off):
    """Per-tile covered-pixel counts (NT,) and conservative corners (NT, 8,
    4): the tile's screen rect x its covered depth range, in camera NDC
    homogeneous coordinates."""
    nt = d.shape[0]
    cov = wn >= 0
    ncov = cov.sum(dim=(1, 2), dtype=torch.int32)
    dmin = torch.where(cov, d, 1e9).amin(dim=(1, 2))
    dmax = torch.where(cov, d, -1e9).amax(dim=(1, 2))
    cxy = _tile_corner_xy(nt, tiles_x, th, twd, width, h_total,
                          float(y_off), d.device)
    cz = torch.stack([dmin] * 4 + [dmax] * 4, dim=1)
    corners = torch.cat([cxy, cz[..., None], torch.ones_like(cz)[..., None]],
                        dim=-1)
    return ncov, corners


def _frustum_need(m, corners, ncov):
    """Tiles that may hold a pixel inside the light frustum ``m`` =
    light_mat @ inv_pv, (NT,), or (S, NT) for a stack of (S, 4, 4): a tile
    is culled only when all 8 corners fail one clip plane (a linear test on
    the homogeneous corners, so it bounds the projective hull), and culled
    tiles are exactly lit."""
    clip = torch.matmul(corners, m.transpose(-1, -2).unsqueeze(-3))
    x, y, z, w = clip.unbind(-1)
    culled = (((x + w) < 0).all(-1) | ((x - w) > 0).all(-1)
              | ((y + w) < 0).all(-1) | ((y - w) > 0).all(-1)
              | ((z - w) > 0).all(-1) | (w <= 0).all(-1))
    return ~culled & (ncov > 0)


def shadow_tile_overflow(shadow, d, wn, tiles_x, th, twd, width, h_total,
                         inv_pv, y_off, frac) -> torch.Tensor:
    """Max over mapped slots of (frustum-needed tiles - the per-slot tile
    budget): the exact count of tiles whose PCF degraded to lit."""
    nt = d.shape[0]
    tb = max(1, int(round(nt * frac)))
    ncov, corners = _tile_frustum_inputs(d, wn, tiles_x, th, twd, width,
                                         h_total, y_off)
    need = _frustum_need(T.mm44(shadow.light_mats, inv_pv), corners,
                         ncov).sum(dim=1, dtype=torch.int32)
    over = torch.where(shadow.slot_entity >= 0, (need - tb).clamp(min=0), 0)
    return over.amax().to(torch.int32)


def _per_slot_factor_tiles(shadow, d, wn, tiles_x, th, twd, width, h_total,
                           inv_pv, y_off, frac):
    """Compact per-slot PCF factor tiles (S, TB, th, tw) and the (S, NT)
    int32 inverse map (tile -> its row in the slot's buffer, -1 = lit).

    Per slot, only tiles that conservatively intersect the slot's light
    frustum are candidates (tiles outside it are exactly lit); the densest
    of them fill a budget of round(NT * frac) rows, and the overflow stays
    lit (``shadow_tile_overflow``). Factors are computed every
    ``pcf_scale``-th pixel straight from light-clip coordinates (camera NDC
    through light_mat @ inv_pv) and upsampled in k x k blocks. Unmapped
    slots give all-lit rows and an empty map. All slots run batched, so
    nothing here waits on the device."""
    nt = d.shape[0]
    n_slots = shadow.slots
    tb = max(1, int(round(nt * frac)))
    ncov, corners = _tile_frustum_inputs(d, wn, tiles_x, th, twd, width,
                                         h_total, y_off)
    k = shadow.pcf_scale
    ds = d[:, ::k, ::k] if k > 1 else d
    ndc = _pixel_ndc(nt, tiles_x, th, twd, width, h_total, float(y_off), k,
                     d.device)

    m_all = T.mm44(shadow.light_mats, inv_pv)  # camera NDC -> light clip
    need_all = _frustum_need(m_all, corners, ncov)  # (S, NT)
    key_all = torch.where(need_all, ncov[None, :], -1)
    sel = torch.argsort(-key_all, dim=1, stable=True)[:, :tb]  # (S, TB)
    dsub = ds[sel][:, None]  # (S, 1, TB, sh, sw)
    nx, ny = ndc[0][sel][:, None], ndc[1][sel][:, None]
    # the four clip rows at once, in the fused multiply-adds that XLA
    # contracts m0*nx + m1*ny + m2*d + m3 into
    mm = m_all[:, :, :, None, None, None]  # (S, 4, 4, 1, 1, 1)
    clip = RP._fma(mm[:, :, 2], dsub,
                   RP._fma(mm[:, :, 0], nx, mm[:, :, 1] * ny)) + mm[:, :, 3]
    f = SHD.pcf_factor_from_clip(shadow, None, *clip.unbind(1))
    if k > 1:
        f = f.repeat_interleave(k, dim=-2).repeat_interleave(k, dim=-1)
        f = f[..., :th, :twd]
    # rows past the needed tiles are unmapped (their factors are never
    # read)
    rows = torch.where(need_all.gather(1, sel),
                       torch.arange(tb, dtype=torch.int32, device=d.device),
                       -1)
    inv = torch.full((n_slots, nt), -1, dtype=torch.int32,
                     device=d.device).scatter_(1, sel, rows)
    active = shadow.slot_entity >= 0
    f = torch.where(active[:, None, None, None], f, 1.0)
    inv = torch.where(active[:, None], inv, -1)
    return f.contiguous(), inv.contiguous()


def _fused_custom_shading(shaded, layers, rows, tri_sys, camera, lights,
                          systems, uniform_writes, bank, atlas, inv_pv, *,
                          tiles_x, width, h_total, h_local, y_off):
    """Custom fragment shading on the fused path, a hook after K3.

    K3 resolves winner attributes in place and never forms a G-buffer, but
    shading functions read one (``ShadeParam``). So, only when a system has
    a shading function, ``custom_gbuffer`` builds both layers' G-buffers on
    the pixels those systems own (fixed values elsewhere, where the
    functions' output is discarded), and each layer's color (channels 0 to
    3 of ``shaded`` opaque, 3 to 6 transparent) is rewritten on those
    pixels. ``base_color`` is K3's own result, so shadows, tile light lists
    and texture overrides are in it. ``layers``: ``(slot, depth, winner,
    textured)`` of the opaque and the transparent layer, ``textured``
    whether K3 textured the layer, so that ``ShadeParam.albedo`` is what
    the lighting consumed."""
    from render_engine_tpu_torch.render.render_system import (
        shade_systems_color)

    nt, th, twd = layers[0][0].shape
    planes = CG.custom_gbuffer(layers, rows, tri_sys, systems.sys_shaded,
                               inv_pv, bank, atlas, tiles_x=tiles_x,
                               width=width, h_total=h_total, h_local=h_local,
                               y_off=y_off)
    inside = None
    if P.armed():
        inside = CG.inside_image(nt, tiles_x, th, twd, width, h_local,
                                 rows.device)
    for (gbuf, px_sys), out_base in zip(planes, (0, 3)):
        covered = gbuf.tri_id >= 0
        if inside is not None:
            _count_custom(CG.owned_pixels(px_sys, gbuf.tri_id,
                                          systems.sys_shaded, inside), nt,
                          kernel_route=rows.device.type == "cuda")
        color = shaded[out_base:out_base + 3].permute(1, 2, 3, 0).reshape(
            nt * th, twd, 3)
        color = shade_systems_color(color, gbuf, px_sys, covered, camera,
                                    lights, systems, uniform_writes)
        shaded[out_base:out_base + 3] = color.reshape(nt, th, twd,
                                                      3).permute(3, 0, 1, 2)
    return shaded


def _count_custom(owned, nt, kernel_route):
    """The custom-shading counters of one layer (``CUSTOM_COUNTERS``) from
    its ``owned`` pixels (``custom_gbuffer.owned_pixels``) in ``nt`` tiles:
    the tiles resolved for the hook (on the kernel route those in which the
    kernel read a candidate row, the tiles holding an owned pixel; on the
    plain route all ``nt``, K2 over every tile), the tiles holding an owned
    pixel, and those pixels. A traced program adds the two layers'
    counts."""
    tiles = owned.reshape(nt, -1).any(dim=1).sum(dtype=torch.int64)
    P.count("custom_tiles_resolved", tiles if kernel_route else torch.full(
        (), nt, dtype=torch.int64, device=owned.device))
    P.count("custom_tiles_owned", tiles)
    P.count("custom_pixels", owned.sum(dtype=torch.int64))


def tiled_fused_core(batch, lights, bank, settings: RenderSettings, camera, *,
                     width, h_total, h_local, y_off, background, ent_attrs,
                     atlas=None, shadow_state=None, systems=None,
                     draw_ctx=None, tri_sys=None) -> torch.Tensor:
    """Raster + resolve + fused shading over the tiles covering image rows
    [y_off, y_off + h_local); ``background`` is the matching
    (h_local, width, 3) rows. Returns the clipped (h_local, width, 3).
    ``tri_sys``: per-triangle system ids, given when a system of
    ``systems`` has a fragment-shading function."""
    cfg = settings.raster
    th, twd = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-width // twd), -(-h_local // th)
    dev = batch.xy.device

    P.mark("render.raster")
    tri_class = RP._tri_class(batch)
    cand, counts, *dropped = RP._candidate_table(
        batch, cfg, tiles_x, tiles_y, tri_class, with_dropped=P.armed())
    if dropped:
        P.count("tile_candidate_dropped", dropped[0])
    packed = RP._packed_tri_table(batch, bank, tri_class,
                                  ent_attrs=ent_attrs, atlas=atlas)
    rows = RP._gather_candidate_rows(packed, cand)  # (NT, K, A)
    d, wn, s, td, twn, ts = RP._launch(batch, h_local, width, cfg, tri_class,
                                       two_pass=True, cand=cand,
                                       counts=counts)

    P.mark("render.resolve")
    albedo_override = None
    if atlas is not None:
        ntt = s.shape[0]
        ttb = max(1, int(round(ntt * settings.texture_tile_budget)))
        with_spec = bank.has_specular_maps()
        with_emis = bank.has_emissive_maps()
        with_norm = bank.has_normal_maps()
        with_diss = bank.has_dissolve_maps()
        n_base = 7 if with_diss else 6 if with_emis else 5 if with_spec \
            else 4
        n_ovr = n_base + (4 if with_norm else 0)
        tex_ch = [35] + [c for c, on in ((40, with_spec), (45, with_emis),
                                         (50, with_norm), (59, with_diss))
                         if on]
        # tiles with any textured candidate: a superset of textured winners
        tex_tri = rows.index_select(-1, consts.const(
            tuple(tex_ch), torch.int64, dev)).amax(dim=-1) >= 0.0
        tex_cand = ((cand >= 0) & tex_tri).any(dim=1)
        flags = dict(with_spec=with_spec, with_emis=with_emis,
                     with_norm=with_norm, with_diss=with_diss)

        def textured(slot):
            if ttb >= ntt:
                res = RP.resolve_attributes_pallas(slot, rows)
                return _texture_override(res, atlas, tiles_x, th, twd,
                                         **flags)
            order = torch.argsort((~tex_cand).to(torch.int32), stable=True)
            sel = order[:ttb]
            res_sel = RP.resolve_attributes_pallas(
                slot[sel].contiguous(), rows[sel].contiguous())
            ovr_sel = _texture_override(res_sel, atlas, tiles_x, th, twd,
                                        tids=sel, **flags)
            out = torch.zeros((n_ovr, ntt, th, twd), device=dev)
            out[:, sel] = ovr_sel
            return out

        ovr_o = textured(s)
        if settings.texture_transparent or with_diss:
            ovr_t = textured(ts)
        else:
            ovr_t = torch.zeros_like(ovr_o)
        albedo_override = torch.cat([ovr_o, ovr_t]).contiguous()

    P.mark("render.shade")
    inv_pv = T.inv44(camera.proj_view())
    sft = sfi = sent = None
    if shadow_state is not None:
        sft, sfi = _per_slot_factor_tiles(
            shadow_state, d, wn, tiles_x, th, twd, width, h_total, inv_pv,
            y_off, settings.shadow_tile_budget)
        sent = shadow_state.slot_entity
    tile_lights = None
    if settings.light_tile_budget > 0:
        ltab_sel, n_live = pack_lights(
            lights, settings.max_dir_lights + settings.max_point_lights
            + settings.max_spot_lights)
        tlist, tcount, _ = select_tile_lights(
            ltab_sel, n_live, camera.position, inv_pv, tiles_x, tiles_y, th,
            twd, width, h_total, y_off, settings.light_tile_budget)
        tile_lights = (tlist, tcount)
    uni_shin = bank.uniform_shininess()
    shaded = fused_shade(
        rows, s, ts, d, td, lights, camera.position, inv_pv, tiles_x, width,
        h_total, slot_factor_tiles=sft, slot_factor_inv=sfi,
        slot_entity=sent, pixel_origin=(0.0, y_off),
        albedo_override=albedo_override, tile_lights=tile_lights,
        with_norm=atlas is not None and bank.has_normal_maps(),
        with_diss=atlas is not None and bank.has_dissolve_maps(),
        spec_packed=uni_shin is None,
        shin_const=uni_shin if uni_shin is not None else 64.0)

    if (systems is not None and systems.has_shade_callbacks()
            and tri_sys is not None):
        P.mark("render.custom")
        # the shading functions shade the transparent layer too
        t_textured = settings.texture_transparent or (
            atlas is not None and bank.has_dissolve_maps())
        shaded = _fused_custom_shading(
            shaded, ((s, d, wn, True), (ts, td, twn, t_textured)), rows,
            tri_sys, camera, lights, systems,
            None if draw_ctx is None else draw_ctx.uniform_writes, bank,
            atlas, inv_pv, tiles_x=tiles_x, width=width, h_total=h_total,
            h_local=h_local, y_off=y_off)

    P.mark("render.compose")
    img = shaded.reshape(8, tiles_y, tiles_x, th, twd).permute(
        1, 3, 2, 4, 0).reshape(tiles_y * th, tiles_x * twd, 8)[
        :h_local, :width]
    return compose(img, background)


def compose(img: torch.Tensor, background: torch.Tensor) -> torch.Tensor:
    """Untiled (H, W, 8) shade output over the background: opaque color
    where covered, the transparent layer alpha-blended where in front."""
    color_i, t_lit_i = img[..., 0:3], img[..., 3:6]
    alpha_i = img[..., 6:7]
    flags_i = img[..., 7]
    covered_i = (torch.remainder(flags_i, 2.0) >= 1.0)[..., None]
    t_front_i = (flags_i >= 2.0)[..., None]
    base = torch.where(covered_i, color_i, background)
    out = torch.where(t_front_i, alpha_i * t_lit_i + (1.0 - alpha_i) * base,
                      base)
    return out.clamp(0.0, 1.0)


def to_srgb_u8(color: torch.Tensor) -> torch.Tensor:
    """Linear -> sRGB 8-bit."""
    c = color.clamp(0.0, 1.0)
    srgb = torch.where(c <= 0.0031308, 12.92 * c,
                       1.055 * torch.pow(c, 1.0 / 2.4) - 0.055)
    return (srgb * 255.0 + 0.5).to(torch.uint8)
