"""Shadow maps: light cameras, the depth-only raster, PCF, the slot schedule.

Port of ``render_engine_tpu/render/shadows.py``: a budget of slots, each
holding one light's depth map (a point light takes six, one per cube
face); at most one map renders per update, new nearby lights first, else
the round-robin slot refreshes; slots whose light left the neighborhood
are evicted. The depth map is kernel K1 in its one-pass mode
(``rasterize_depth_winner_pallas``); the lighting pass reads a 3x3
percentage-closer filter from it.

Differences from the JAX package, none of which changes a value:

* ``cursor`` and ``tick`` are host integers. The schedule is a pure
  function of (state, tick), so the interval gate is decided on the host
  and no update reads the device; a program's ``cursor`` is the slot as a
  device tensor, so one program serves every slot. ``slot``, ``light``,
  ``face`` and ``do_render`` stay device tensors, and the slot update is a
  ``torch.where`` over the slots.
* The JAX package keeps a (slots, R*R, 16) table of each texel's edge-
  clamped 3x3 neighborhood (a TPU gather workaround); here the PCF reads
  the nine edge-clamped taps straight from ``maps``, which gives the same
  values.

``pack_shadow_state`` / ``unpack_shadow_state`` (the JAX Engine's packed
program boundary) have no counterpart: the port's Engine keeps the four
tables as static buffers that its captured programs read and write
(``runtime/engine.py``), and the schedule's two integers on the host.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.render.geometry import (build_triangle_batch,
                                                     to_screen)
from render_engine_tpu_torch.render.raster_jnp import RasterConfig
from render_engine_tpu_torch.render.raster_pallas import (
    rasterize_depth_winner_pallas)
from render_engine_tpu_torch.runtime import profiling as P
from render_engine_tpu_torch.utils.consts import const
from render_engine_tpu_torch.utils.indexing import gather_row
from render_engine_tpu_torch.world import culling

SHADOW_BUDGET = 6
SHADOW_RES = 1024
PCF_BIAS = 2e-3
NEIGHBORHOOD = 800.0  # lights farther from the camera get no map

# cube face directions and ups, GL order +X -X +Y -Y +Z -Z
_FACE_DIRS = ((1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1),
              (0, 0, -1))
_FACE_UPS = ((0, -1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1), (0, -1, 0),
             (0, -1, 0))
# the 3x3 PCF neighborhood, row-major
_TAP_DY = (-1, -1, -1, 0, 0, 0, 1, 1, 1)
_TAP_DX = (-1, 0, 1, -1, 0, 1, -1, 0, 1)


@dataclasses.dataclass(frozen=True)
class ShadowState:
    maps: torch.Tensor  # (S, R, R) NDC depth from the light camera
    light_mats: torch.Tensor  # (S, 4, 4) each slot's light proj_view
    slot_entity: torch.Tensor  # (S,) int32 light entity, -1 free
    slot_face: torch.Tensor  # (S,) int32 cube face 0-5 (point lights)
    cursor: int  # round-robin cursor (host; a device tensor in a program)
    tick: int  # updates seen, for the interval gate (host)
    resolution: int
    # PCF factors are computed every pcf_scale-th pixel and upsampled
    pcf_scale: int

    @property
    def slots(self) -> int:
        return self.slot_entity.shape[0]

    def clone(self) -> "ShadowState":
        return dataclasses.replace(
            self, maps=self.maps.clone(), light_mats=self.light_mats.clone(),
            slot_entity=self.slot_entity.clone(),
            slot_face=self.slot_face.clone())


def create_shadow_state(resolution: int = SHADOW_RES,
                        budget: int = SHADOW_BUDGET, pcf_scale: int = 1,
                        device="cpu") -> ShadowState:
    return ShadowState(
        maps=torch.ones((budget, resolution, resolution), device=device),
        light_mats=torch.eye(4, device=device).expand(budget, 4, 4).clone(),
        slot_entity=torch.full((budget,), -1, dtype=torch.int32,
                               device=device),
        slot_face=torch.zeros(budget, dtype=torch.int32, device=device),
        cursor=0, tick=0, resolution=resolution, pcf_scale=pcf_scale)


# ---------------------------------------------------------------------------
# light cameras
# ---------------------------------------------------------------------------
def _device_index(i, device) -> torch.Tensor:
    """An int64 index tensor on ``device`` (a tensor passes through, so a
    frame's indices stay on the device)."""
    if isinstance(i, torch.Tensor):
        return i.to(device=device, dtype=torch.long)
    return torch.as_tensor(i, device=device).long()


def light_proj_view(world, entity, ortho_extent: float | None = None,
                    near: float = 1.0, far: float | None = None,
                    face=0) -> torch.Tensor:
    """proj_view of a light entity (0-d tensor), chosen by its sortable
    bucket: directional -> an orthographic box along light_direction;
    spot -> a perspective along light_direction, widened to the outer
    cutoff cone (+5%); point -> the 90-degree cube ``face``. With
    ``ortho_extent``/``far`` left None the volume fits the light: radius r
    > 0 gives ortho half-extent r and far 2r, perspective far r; lights
    without a radius keep a 200/600 box."""
    dev = world.device
    e = _device_index(entity, dev).clamp(0, world.capacity - 1)
    pos = gather_row(world["position"], e)
    sortable = gather_row(world["sortable"], e)
    is_dir = sortable == R.SORTABLE_DIRECTIONAL
    is_point = sortable == R.SORTABLE_POINT
    f32 = dict(dtype=torch.float32, device=dev)

    radius = gather_row(world["light_radius"], e)
    has_r = radius > 0.0
    if ortho_extent is None:
        ortho_extent = torch.where(has_r, radius, 200.0)
    if far is None:
        ortho_far = torch.where(has_r, 2.0 * radius, 600.0)
        persp_far = torch.where(has_r, radius, 600.0)
    else:
        ortho_far = persp_far = torch.tensor(far, **f32)
    # guard far > near
    ortho_far = torch.clamp(ortho_far, min=near + 1.0)
    persp_far = torch.clamp(persp_far, min=near + 1.0)

    direction = gather_row(world["light_direction"], e)
    dlen = torch.linalg.vector_norm(direction)
    direction = torch.where(dlen > 1e-6, direction / dlen.clamp(min=1e-6),
                            const((0.0, -1.0, 0.0), device=dev))
    face = _device_index(face, dev)
    direction = torch.where(
        is_point, gather_row(const(_FACE_DIRS, device=dev), face),
        direction)
    up = torch.where(direction[1].abs() > 0.99,
                     const((1.0, 0.0, 0.0), device=dev),
                     const((0.0, 1.0, 0.0), device=dev))
    up = torch.where(is_point,
                     gather_row(const(_FACE_UPS, device=dev), face), up)
    view = T.look_at(pos, pos + direction, up)

    fov = torch.clamp(gather_row(world["light_fov"], e), 0.2, 3.0)
    # spot cameras widen to the outer cutoff cone, so everything the cone
    # lights can be shadowed; a cutoff of 0 (unset) keeps light_fov
    cos_outer = gather_row(world["light_cutoff"], e)[1]
    cone_fov = 2.0 * torch.arccos(torch.clamp(cos_outer, -0.999, 0.999)) \
        * 1.05
    fov = torch.where((cos_outer > 1e-3) & ~is_dir & ~is_point,
                      torch.clamp(torch.maximum(fov, cone_fov), 0.2, 3.0),
                      fov)
    fov = torch.where(is_point, math.pi / 2, fov)
    persp = T.perspective(fov, 1.0, near, persp_far)
    if not isinstance(ortho_extent, torch.Tensor):
        ortho_extent = torch.tensor(ortho_extent, **f32)
    ortho = T.orthographic(-ortho_extent, ortho_extent, -ortho_extent,
                           ortho_extent, near, ortho_far)
    return T.mm44(torch.where(is_dir, ortho, persp), view)


def casters_outside_volume(world, light_entity, proj_view) -> torch.Tensor:
    """int32 count of the light's relevant casters its camera cannot see:
    alive, with a model, not the light itself, within light_radius (200
    without one), inside the outer cone for spot lights; point lights
    count zero (their six faces cover the sphere)."""
    cap = world.capacity
    dev = world.device
    e = _device_index(light_entity, dev).clamp(0, cap - 1)
    pos = world["position"][e]
    radius = world["light_radius"][e]
    radius = torch.where(radius > 0.0, radius, 200.0)
    sortable = world["sortable"][e]
    mn, mx = world["aabb_min"], world["aabb_max"]
    caster = (world.alive & (world["model_id"] >= 0)
              & (torch.arange(cap, device=dev) != e))
    relevant = caster & culling.within_distance(pos, mn, mx, radius)

    is_spot = sortable == R.SORTABLE_SPOT
    is_point = sortable == R.SORTABLE_POINT
    direction = world["light_direction"][e]
    direction = direction / torch.linalg.vector_norm(direction).clamp(
        min=1e-6)
    cos_outer = world["light_cutoff"][e][1]
    to_c = 0.5 * (mn + mx) - pos[None]
    dist = torch.linalg.vector_norm(to_c, dim=-1).clamp(min=1e-6)
    in_cone = (to_c * direction[None]).sum(dim=-1) / dist >= cos_outer
    relevant = relevant & (in_cone | ~(is_spot & (cos_outer > 1e-3)))
    relevant = relevant & ~is_point
    in_vol = culling.aabb_in_frustum(T.frustum_planes(proj_view), mn, mx)
    return (relevant & ~in_vol).sum(dtype=torch.int32)


# ---------------------------------------------------------------------------
# the schedule: at most one new map per update, nearby lights first
# ---------------------------------------------------------------------------
def choose_light(shadow: ShadowState, world, camera_position):
    """Pick (state with evictions and the cursor advanced, slot, light,
    face, do_render) for this update's single map. Nearby lights that
    still lack a slot (point lights need six) take the first free slot;
    otherwise the round-robin slot ``cursor % S`` refreshes its light."""
    cap = world.capacity
    dev = world.device
    sortable = world["sortable"]
    is_light = world.alive & (sortable != R.SORTABLE_DEFAULT)
    near = (((world["position"] - camera_position[None]) ** 2).sum(dim=-1)
            <= NEIGHBORHOOD * NEIGHBORHOOD)
    candidate = is_light & near

    slot_ent = shadow.slot_entity
    ents = torch.arange(cap, dtype=torch.int32, device=dev)
    owned = ((ents[:, None] == slot_ent[None, :])
             & (slot_ent[None, :] >= 0)).sum(dim=1, dtype=torch.int32)
    needed = torch.where(sortable == R.SORTABLE_POINT, 6, 1)
    unmapped = candidate & (owned < needed)
    any_unmapped = unmapped.any()
    pick_new = unmapped.to(torch.int8).argmax()  # first unmapped light
    pick_face = gather_row(owned, pick_new)  # next cube face of a point light

    # eviction: slots whose light left the neighborhood free up
    slot_ok = candidate[slot_ent.clamp(0, cap - 1).long()] & (slot_ent >= 0)
    slot_ent = torch.where(slot_ok, slot_ent, -1)
    free = slot_ent < 0
    first_free = free.to(torch.int8).argmax()
    rr_slot = _device_index(shadow.cursor, dev).reshape(()) % shadow.slots
    rr_ent = gather_row(slot_ent, rr_slot)
    new = any_unmapped & free.any()
    slot = torch.where(new, first_free, rr_slot)
    light = torch.where(new, pick_new, rr_ent.clamp(0, cap - 1).long())
    face = torch.where(new, pick_face, gather_row(shadow.slot_face, rr_slot))
    do_render = new | (rr_ent >= 0)
    shadow = dataclasses.replace(shadow, slot_entity=slot_ent,
                                 cursor=shadow.cursor + 1)
    return shadow, slot, light, face, do_render


def shadow_raster_cfg(max_tris: int) -> RasterConfig:
    """The shadow depth pass's binning budgets (shared with the engine's
    drop counters, so both count the budgets the pass runs with)."""
    return RasterConfig(tile_budget=160, global_budget=16,
                        pair_budget=4 * max_tris)


def shadow_batch(world, camera, bank, proj_view, *, max_tris: int,
                 lov_bias: int = 0, caster_mask=None):
    """The depth-only triangles a light camera sees: the shadow pass's own
    coarser LoV (``lov_bias`` bands) over the casters ``caster_mask``
    allows (a bool[CAP] tensor, a callable ``fn(world)``, or None for
    every model-bearing entity)."""
    if callable(caster_mask):
        caster_mask = caster_mask(world)
    return build_triangle_batch(world, bank, camera, max_tris=max_tris,
                                apply_lov=True, proj_view=proj_view,
                                depth_only=True, lov_bias=lov_bias,
                                instance_mask=caster_mask)


def render_shadow_map(shadow: ShadowState, world, camera, bank, *,
                      max_tris: int = 16384,
                      raster_cfg: RasterConfig | None = None,
                      interval: int = 1, lov_bias: int = 0,
                      caster_mask=None) -> ShadowState:
    """One update: bump the tick and, on every ``interval``-th tick, choose
    a light and depth-raster its view into its slot. The gate reads the
    host tick, so a skipped update launches nothing."""
    bumped = dataclasses.replace(shadow, tick=shadow.tick + 1)
    if interval > 1 and shadow.tick % interval != 0:
        return bumped
    return _render_shadow_map_now(bumped, world, camera, bank,
                                  max_tris=max_tris, raster_cfg=raster_cfg,
                                  lov_bias=lov_bias, caster_mask=caster_mask)


def _render_shadow_map_now(shadow: ShadowState, world, camera, bank, *,
                           max_tris: int,
                           raster_cfg: RasterConfig | None = None,
                           lov_bias: int = 0,
                           caster_mask=None) -> ShadowState:
    P.mark("shadows.geometry")
    cfg = raster_cfg or shadow_raster_cfg(max_tris)
    res = shadow.resolution
    shadow, slot, light, face, do_render = choose_light(shadow, world,
                                                        camera.position)
    pv = light_proj_view(world, light, face=face)
    batch = to_screen(shadow_batch(world, camera, bank, pv,
                                   max_tris=max_tris, lov_bias=lov_bias,
                                   caster_mask=caster_mask), res, res)
    P.mark("shadows.raster")
    depth, _ = rasterize_depth_winner_pallas(batch, res, res, cfg)

    sel = (torch.arange(shadow.slots, device=depth.device) == slot) \
        & do_render
    return dataclasses.replace(
        shadow,
        maps=torch.where(sel[:, None, None], depth[None], shadow.maps),
        light_mats=torch.where(sel[:, None, None], pv[None],
                               shadow.light_mats),
        slot_entity=torch.where(sel, light.to(torch.int32),
                                shadow.slot_entity),
        slot_face=torch.where(sel, face.to(torch.int32), shadow.slot_face))


# ---------------------------------------------------------------------------
# PCF lookup for the lighting pass
# ---------------------------------------------------------------------------
def _pcf(maps, res: int, nx, ny, z, inside):
    """3x3 PCF with edge-clamped taps around the texel covering light-NDC
    (nx, ny): the share of taps at least as far as ``z - PCF_BIAS``, and
    1 outside the light frustum. ``maps`` is one (R, R) map, or (S, R, R)
    when the coordinates carry a leading slot axis."""
    dev = z.device
    # the shadow raster samples pixel centers at +0.5: offset by -0.5 so
    # round() lands on the covering texel
    u = (nx * 0.5 + 0.5) * res - 0.5
    v = (0.5 - ny * 0.5) * res - 0.5
    # bound the float before the int cast (pixels outside the frustum
    # read a clamped texel and are masked to lit below)
    ui = torch.round(u).clamp(-1.0, float(res)).to(torch.int32)
    vi = torch.round(v).clamp(-1.0, float(res)).to(torch.int32)
    dy = const(_TAP_DY, torch.int32, dev)
    dx = const(_TAP_DX, torch.int32, dev)
    ty = (vi.clamp(0, res - 1)[..., None] + dy).clamp(0, res - 1)
    tx = (ui.clamp(0, res - 1)[..., None] + dx).clamp(0, res - 1)
    flat = ty * res + tx
    if maps.dim() == 3:
        base = torch.arange(maps.shape[0], dtype=torch.int32,
                            device=dev) * (res * res)
        flat = flat + base.reshape((-1,) + (1,) * (flat.dim() - 1))
    taps = maps.reshape(-1)[flat.long()]
    lit = ((z - PCF_BIAS)[..., None] <= taps).to(torch.float32).sum(
        dim=-1) / 9.0
    return torch.where(inside, lit, torch.ones_like(lit))


def pcf_factor(shadow: ShadowState, slot, world_pos) -> torch.Tensor:
    """3x3 PCF shadow term in [0, 1], (..., 1), of world positions
    (..., 3) against one slot's map; outside the light frustum -> lit."""
    mat = shadow.light_mats[slot]
    homo = torch.cat([world_pos, torch.ones_like(world_pos[..., :1])],
                     dim=-1)
    clip = torch.einsum("ij,...j->...i", mat, homo)
    w = clip[..., 3]
    ndc = clip[..., :3] / torch.where(w.abs() > 1e-9, w,
                                      torch.ones_like(w))[..., None]
    z = ndc[..., 2]
    inside = ((ndc[..., 0].abs() <= 1.0) & (ndc[..., 1].abs() <= 1.0)
              & (z <= 1.0) & (w > 0.0))
    return _pcf(shadow.maps[slot], shadow.resolution, ndc[..., 0],
                ndc[..., 1], z, inside)[..., None]


def pcf_factor_from_clip(shadow: ShadowState, slot, cx, cy, cz,
                         cw) -> torch.Tensor:
    """PCF term from light-clip coordinates (the fused path's entry: the
    camera NDC goes through light_mat @ inv_proj_view and world positions
    are never formed). ``slot=None``: the coordinates carry a leading axis
    over every slot, each row read against its own slot's map."""
    inv = 1.0 / torch.where(cw.abs() > 1e-9, cw, torch.ones_like(cw))
    nx, ny, z = cx * inv, cy * inv, cz * inv
    inside = ((nx.abs() <= 1.0) & (ny.abs() <= 1.0) & (z <= 1.0)
              & (cw > 0.0))
    maps = shadow.maps if slot is None else shadow.maps[slot]
    return _pcf(maps, shadow.resolution, nx, ny, z, inside)


def slot_factors(shadow: ShadowState, world_pos) -> torch.Tensor:
    """(S, *spatial) PCF factors of every slot at world positions
    (..., h, w, 3); slots without an owning light are all lit. With
    ``shadow.pcf_scale`` > 1 the factors are computed at every k-th pixel
    and repeated in k x k blocks."""
    k = shadow.pcf_scale
    wp = world_pos[..., ::k, ::k, :] if k > 1 else world_pos
    f = torch.stack([pcf_factor(shadow, s, wp)[..., 0]
                     for s in range(shadow.slots)])
    active = (shadow.slot_entity >= 0).reshape((-1,) + (1,) * (f.dim() - 1))
    f = torch.where(active, f, torch.ones_like(f))
    if k > 1:
        f = f.repeat_interleave(k, dim=-2).repeat_interleave(k, dim=-1)
        f = f[..., :world_pos.shape[-3], :world_pos.shape[-2]]
    return f


def make_shadow_factor(shadow: ShadowState, world, lights_entity_map):
    """The ``shadow_factor`` callback of ``lighting.shade``:
    ``factor(kind, i, world_pos) -> (..., 1)``, the product of the factors
    of every slot that light i of ``kind`` owns (a cube-mapped light owns
    several; faces whose frustum misses a pixel give 1).
    ``lights_entity_map``: kind -> (N,) entity ids as uploaded into the
    ``LightArrays``. The slot factors are computed once per ``world_pos``
    tensor and shared by the lights."""
    cache: dict = {}

    def factor(kind: str, i: int, world_pos):
        ents = lights_entity_map.get(kind)
        if ents is None:
            return 1.0
        key = id(world_pos)
        if key not in cache:
            cache[key] = (world_pos, slot_factors(shadow, world_pos))
        slots = cache[key][1]
        ent = ents[i]
        hit = (shadow.slot_entity == ent) & (ent >= 0)  # (S,)
        hit = hit.reshape((-1,) + (1,) * (slots.dim() - 1))
        return torch.where(hit, slots, torch.ones_like(slots)).prod(
            dim=0)[..., None]

    return factor
