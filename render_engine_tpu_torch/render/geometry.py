"""Geometry stage: world + model bank -> the frame's screen-space triangles.

Port of ``render_engine_tpu/render/geometry.py``: frustum-cull entities,
pick each entity's level-of-view model by camera distance, expand entities
into a fixed budget of ``max_tris`` triangle rows (scatter + cumsum ragged
expansion), transform to clip space, clip against the near plane, and emit
per-triangle attributes. Triangles beyond the budget are dropped and
counted in ``total_requested``.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.models.bank import ModelBank
from render_engine_tpu_torch.world import culling


@dataclasses.dataclass(frozen=True)
class TriangleBatch:
    xy: torch.Tensor  # (T, 3, 2) pixel coords (x right, y down) or NDC
    z: torch.Tensor  # (T, 3) NDC depth
    inv_w: torch.Tensor  # (T, 3)
    world_pos: torch.Tensor  # (T, 3, 3)
    normal: torch.Tensor  # (T, 3, 3)
    uv: torch.Tensor  # (T, 3, 2)
    material: torch.Tensor  # (T,) int32
    entity: torch.Tensor  # (T,) int32
    valid: torch.Tensor  # (T,) bool
    transparent: torch.Tensor  # (T,) bool
    total_requested: torch.Tensor  # () int32 pre-budget triangle count

    @property
    def budget(self) -> int:
        return self.xy.shape[0]


def _scatter_set(size: int, index: torch.Tensor, values: torch.Tensor
                 ) -> torch.Tensor:
    """out[index] = values into a (size + 1) buffer whose last row absorbs
    the dropped writes (index == size); returns the first ``size`` rows.
    Kept indices are unique, so the result is deterministic."""
    out = torch.zeros((size + 1,) + values.shape[1:], dtype=values.dtype,
                      device=values.device)
    out[index] = values
    return out[:size]


def build_triangle_batch(world: World, bank: ModelBank, camera, *,
                         max_tris: int, systems=None, instance_mask=None,
                         apply_lov: bool = True, proj_view=None,
                         depth_only: bool = False,
                         lov_bias: int = 0) -> TriangleBatch:
    """Cull, LoV-select and expand the visible instances into triangles.
    ``systems``: compiled render systems (routing, LoV gating, alpha-scale
    transparency). ``instance_mask``: bool[CAP] restricting the entities
    drawn. ``proj_view`` replaces the camera's matrix (a light camera);
    LoV bands still follow the camera's distance, shifted ``lov_bias``
    bands coarser. ``depth_only``: positions only (the shadow raster):
    normals, uvs, materials and transparency are zeros, and the near clip
    carries only the clip coordinates."""
    cap = world.capacity
    dev = world.device
    pv = camera.proj_view() if proj_view is None else proj_view
    planes = T.frustum_planes(pv)

    vis = world.alive & (world["model_id"] >= 0)
    if instance_mask is not None:
        vis = vis & instance_mask
    msys = None
    if systems is not None:
        nm = systems.model_system.shape[0]
        msys = systems.model_system[world["model_id"].clamp(0, nm - 1).long()]
        vis = vis & (msys >= 0)
    vis = vis & culling.aabb_in_frustum(planes, world["aabb_min"],
                                        world["aabb_max"])

    mid = world["model_id"]
    if apply_lov:
        dist = torch.linalg.vector_norm(
            world["position"] - camera.position[None], dim=-1)
        lov_mid = bank.lov_model_id(mid, dist, camera.draw_distance,
                                    band_bias=lov_bias)
        if msys is None:
            mid = lov_mid
        else:
            ns = systems.sys_lov.shape[0]
            lov_on = systems.sys_lov[msys.clamp(0, ns - 1).long()] > 0.5
            mid = torch.where(lov_on & (msys >= 0), lov_mid, mid)
    mid_safe = mid.clamp(0, bank.num_models - 1).long()

    counts = torch.where(vis, bank.tri_count[mid_safe],
                         torch.zeros_like(bank.tri_count[mid_safe]))
    offsets = torch.cumsum(counts, 0, dtype=torch.int32)
    starts = offsets - counts
    total = offsets[cap - 1]

    t_ids = torch.arange(max_tris, dtype=torch.int32, device=dev)
    bump_at = torch.where(vis & (starts < max_tris), starts,
                          torch.full_like(starts, max_tris)).long()
    bumps = torch.zeros(max_tris + 1, dtype=torch.int32, device=dev)
    bumps.index_add_(0, bump_at, torch.ones_like(bump_at,
                                                 dtype=torch.int32))
    rank = torch.cumsum(bumps[:max_tris], 0, dtype=torch.int32) - 1
    vis_rank = torch.cumsum(vis.to(torch.int32), 0, dtype=torch.int32) - 1
    ent_of_rank = _scatter_set(
        cap, torch.where(vis, vis_rank, torch.full_like(vis_rank, cap)).long(),
        torch.arange(cap, dtype=torch.int32, device=dev))
    ent = ent_of_rank[rank.clamp(0, cap - 1).long()]
    valid = t_ids < total

    # per-entity attributes as one packed f32 row gather; every id and
    # consumed start offset is below 2^24, so the f32 round trip is exact
    ent_table = torch.cat([
        world["orientation"], world["scale"], world["position"],
        world["flags"].to(torch.float32)[:, None],
        starts.to(torch.float32)[:, None],
        bank.tri_offset[mid_safe].to(torch.float32)[:, None]], dim=1)
    erow = ent_table[ent.long()]
    quat, scale, pos_e = erow[:, 0:4], erow[:, 4:7], erow[:, 7:10]
    ent_flags = erow[:, 10].to(torch.int32)
    tri_within = t_ids - erow[:, 11].to(torch.int32)
    tri_idx = (erow[:, 12].to(torch.int32) + tri_within).clamp(
        0, bank.num_triangles - 1).long()

    trow = bank.tri_packed[tri_idx]
    tv = trow[:, 0:3].to(torch.int64)
    if depth_only:
        v_obj = bank.vertices[tv]  # (T, 3, 3)
    else:
        vrow = bank.vert_packed[tv]  # (T, 3, 8)
        v_obj = vrow[..., 0:3]
    w_pos = T.quat_rotate(quat[:, None, :], v_obj * scale[:, None, :]) \
        + pos_e[:, None, :]
    if depth_only:
        material = torch.zeros(max_tris, dtype=torch.int32, device=dev)
        w_nrm = torch.zeros((max_tris, 3, 3), device=dev)
        uv = torch.zeros((max_tris, 3, 2), device=dev)
        transparent = torch.zeros(max_tris, dtype=torch.bool, device=dev)
    else:
        n_obj = vrow[..., 3:6]
        uv = vrow[..., 6:8]
        material = trow[:, 3].to(torch.int32)
        safe_scale = torch.where(scale.abs() > 1e-12, scale,
                                 torch.ones_like(scale))
        w_nrm = T.quat_rotate(quat[:, None, :],
                              n_obj / safe_scale[:, None, :])

    homo = torch.cat([w_pos, torch.ones_like(w_pos[..., :1])], dim=-1)
    clip = torch.einsum("ij,tnj->tni", pv, homo)

    if not depth_only:
        transparent = (trow[:, 4] > 0.5) \
            | ((ent_flags & R.FLAG_TRANSPARENT) != 0)
        if msys is not None:
            ns = systems.sys_table.shape[0]
            ascale = systems.sys_table[msys.clamp(0, ns - 1).long(), 5]
            ent_l = ent.long()
            transparent = transparent | ((ascale[ent_l] < 1.0)
                                         & (msys[ent_l] >= 0))

    (clip, w_pos, w_nrm, uv, material, ent, transparent,
     valid) = _near_clip(clip, w_pos, w_nrm, uv, material, ent, transparent,
                         valid, depth_only=depth_only)

    w = clip[..., 3]
    valid = valid & (w > 1e-6).all(dim=-1)
    inv_w = 1.0 / torch.where(w.abs() > 1e-9, w, torch.ones_like(w))
    ndc = clip[..., :3] * inv_w[..., None]
    xy_ndc = ndc[..., :2]
    valid = valid & torch.isfinite(xy_ndc).all(dim=-1).all(dim=-1)
    return TriangleBatch(xy=xy_ndc, z=ndc[..., 2], inv_w=inv_w,
                         world_pos=w_pos, normal=w_nrm, uv=uv,
                         material=material, entity=ent, valid=valid,
                         transparent=transparent, total_requested=total)


def _near_clip(clip, w_pos, w_nrm, uv, material, ent, transparent, valid,
               depth_only: bool = False):
    """Near-plane clipping (z_clip >= -w). A triangle with one vertex
    outside becomes a quad: its second triangle goes to an unused budget
    row (dropped when none is free); two outside -> one clipped triangle;
    all outside -> dropped. ``depth_only`` clips the clip coordinates alone
    and passes positions, normals and uvs through unclipped."""
    big = clip if depth_only else torch.cat([clip, w_pos, w_nrm, uv],
                                            dim=-1)  # (T, 3, 4 or 12)
    nch = big.shape[-1]
    s = clip[..., 2] + clip[..., 3]
    inside = s > 0.0
    n_in = inside.sum(dim=-1)
    ins8 = inside.to(torch.int8)
    odd = torch.where(n_in == 2, ins8.argmin(dim=-1), ins8.argmax(dim=-1))

    def rot(a):
        o = odd.reshape((-1,) + (1,) * (a.ndim - 1))
        return torch.where(o == 1, torch.roll(a, -1, dims=1),
                           torch.where(o == 2, torch.roll(a, -2, dims=1), a))

    big_r = rot(big)
    s_r = rot(s[..., None])[..., 0]
    eps = 1e-12
    d1 = s_r[:, 0] - s_r[:, 1]
    d2 = s_r[:, 0] - s_r[:, 2]
    t1 = s_r[:, 0] / torch.where(d1.abs() > eps, d1, torch.ones_like(d1))
    t2 = s_r[:, 0] / torch.where(d2.abs() > eps, d2, torch.ones_like(d2))
    a_v1 = big_r[:, 0] + t1[:, None] * (big_r[:, 1] - big_r[:, 0])
    a_v2 = big_r[:, 0] + t2[:, None] * (big_r[:, 2] - big_r[:, 0])
    tri_a2 = torch.stack([a_v1, big_r[:, 1], big_r[:, 2]], dim=1)
    tri_b2 = torch.stack([a_v1, big_r[:, 2], a_v2], dim=1)
    tri_a1 = torch.stack([big_r[:, 0], a_v1, a_v2], dim=1)

    crosses2 = valid & (n_in == 2)
    crosses1 = valid & (n_in == 1)
    keep = valid & (n_in == 3)
    new_valid = keep | crosses2 | crosses1
    big_o = torch.where(crosses2[:, None, None], tri_a2,
                        torch.where(crosses1[:, None, None], tri_a1, big_r))

    t_budget = clip.shape[0]
    free = ~valid
    n_free = free.sum()
    extra_rank = torch.cumsum(crosses2.to(torch.int64), 0) - 1
    dest_ok = crosses2 & (extra_rank < n_free)
    # index of the e-th free row, by scatter (no host-side nonzero)
    free_rank = torch.cumsum(free.to(torch.int64), 0) - 1
    rows = torch.arange(t_budget, device=clip.device)
    free_slots = torch.full((t_budget + 1,), t_budget, dtype=torch.int64,
                            device=clip.device)
    free_slots[torch.where(free, free_rank,
                           torch.full_like(free_rank, t_budget))] = rows
    dest = torch.where(dest_ok,
                       free_slots[extra_rank.clamp(0, t_budget - 1)],
                       torch.full_like(rows, t_budget))

    flat = big_o.reshape(t_budget, 3 * nch)
    flat_buf = torch.cat([flat, flat.new_zeros(1, 3 * nch)])
    flat_buf[dest] = tri_b2.reshape(t_budget, 3 * nch)
    big_o = flat_buf[:t_budget].reshape(t_budget, 3, nch)

    meta = torch.stack([material.to(torch.float32), ent.to(torch.float32),
                        transparent.to(torch.float32),
                        dest_ok.to(torch.float32)], dim=-1)
    meta0 = meta.clone()
    meta0[:, 3] = new_valid.to(torch.float32)
    meta_buf = torch.cat([meta0, meta0.new_zeros(1, 4)])
    meta_buf[dest] = meta
    meta_o = meta_buf[:t_budget]
    if depth_only:
        parts = (big_o, w_pos, w_nrm, uv)
    else:
        parts = (big_o[..., 0:4], big_o[..., 4:7], big_o[..., 7:10],
                 big_o[..., 10:12])
    return (*parts, meta_o[:, 0].to(torch.int32),
            meta_o[:, 1].to(torch.int32), meta_o[:, 2] > 0.5,
            meta_o[:, 3] > 0.5)


def to_screen(batch: TriangleBatch, width: int, height: int
              ) -> TriangleBatch:
    """NDC xy -> pixel coordinates for a (height, width) target."""
    x = (batch.xy[..., 0] * 0.5 + 0.5) * float(width)
    y = (0.5 - batch.xy[..., 1] * 0.5) * float(height)
    return dataclasses.replace(batch, xy=torch.stack([x, y], dim=-1))


def triangle_tangents(batch: TriangleBatch):
    """Per-triangle (tangent (T, 3), handedness (T,)) from world edges and
    UV deltas; degenerate UV mappings give a zero tangent."""
    p = batch.world_pos
    uv = batch.uv
    e1 = p[:, 1] - p[:, 0]
    e2 = p[:, 2] - p[:, 0]
    du1 = uv[:, 1, 0] - uv[:, 0, 0]
    dv1 = uv[:, 1, 1] - uv[:, 0, 1]
    du2 = uv[:, 2, 0] - uv[:, 0, 0]
    dv2 = uv[:, 2, 1] - uv[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    ok = det.abs() > 1e-12
    r = torch.where(ok, 1.0 / torch.where(ok, det, torch.ones_like(det)),
                    torch.zeros_like(det))
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    bit = (e2 * du1[:, None] - e1 * du2[:, None]) * r[:, None]
    n_geo = T.cross(e1, e2)
    handed = torch.where((T.cross(n_geo, tan) * bit).sum(dim=-1) < 0.0,
                         -1.0, 1.0).to(torch.float32)
    return tan, handed


def perturb_normal(n, tan, handed, sample):
    """Tangent-space normal-map application over any pixel layout: ``n``
    (..., 3) unit normal, ``tan`` (..., 3) face tangent (zero = no-op),
    ``handed`` (...,), ``sample`` (..., 3) texel in [0, 1]."""
    t = tan - n * (n * tan).sum(dim=-1, keepdim=True)
    tl = torch.linalg.vector_norm(t, dim=-1, keepdim=True)
    ok = tl[..., 0] > 1e-8
    t = t / torch.where(tl > 1e-8, tl, torch.ones_like(tl))
    b = T.cross(n, t) * handed[..., None]
    m = sample * 2.0 - 1.0
    p = m[..., 0:1] * t + m[..., 1:2] * b + m[..., 2:3] * n
    pl_ = torch.linalg.vector_norm(p, dim=-1, keepdim=True)
    p = p / torch.where(pl_ > 1e-12, pl_, torch.ones_like(pl_))
    return torch.where(ok[..., None], p, n)
