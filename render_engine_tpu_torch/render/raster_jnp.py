"""Tile binning, and the golden rasterizer and G-buffer resolve.

Port of ``render_engine_tpu/render/raster_jnp.py`` (the module keeps the
JAX package's name so the two line up; nothing here is jnp):
``RasterConfig``, ``_bin_triangles``, and the golden path's
``rasterize_depth_winner``, ``resolve_gbuffer`` and ``render_gbuffer``,
plain tensor code in image layout that the tiled kernels are held to
(``RenderSettings(backend="jnp")`` renders through it).

Binning: each valid
triangle's screen bbox expands into (tile, triangle) pairs, or, when it
covers more than ``max_tiles_per_tri`` tiles, into the global list tested by
every tile. One stable sort on ``((tile * 2 + class) << 8) | depth_bucket``
orders every (tile, class) window near-first, so an overflowing window
drops its farthest triangles; the drops are counted.

The JAX package fills the windows with a 128-lane one-hot scatter-max, a
TPU layout workaround; here each live pair writes its triangle id straight
into ``(NT, B)`` at (tile, rank), which gives the same table.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch.render.gbuffer import (MATERIAL_BACKGROUND,
                                                    GBuffer)
from render_engine_tpu_torch.render.geometry import (TriangleBatch,
                                                     perturb_normal,
                                                     triangle_tangents)
from render_engine_tpu_torch.render.textures import sample_atlas


@dataclasses.dataclass(frozen=True)
class RasterConfig:
    tile_h: int = 8
    tile_w: int = 128
    tile_budget: int = 128  # opaque candidates per tile
    trans_tile_budget: int = 16  # transparent candidates per tile
    max_tiles_per_tri: int = 8  # larger triangles go to the global list
    global_budget: int = 64
    cull_backfaces: bool = False
    pair_budget: int | None = None  # cap on live (tile, tri) pairs


def _edge(ax, ay, bx, by, px, py):
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _bin_triangles(batch: TriangleBatch, cfg: RasterConfig, tiles_x: int,
                   tiles_y: int, tri_class=None):
    """Returns ``(tile_cand (NT, B) int32, global_list (GB,) int32,
    tri_valid (T,), cand_dropped)``; with ``tri_class`` (T,) f32 in {0, 1,
    2} also the transparent windows: ``(tile_cand, global_list, valid,
    trans_cand (NT, BT), cand_dropped)``."""
    t = batch.budget
    nt = tiles_x * tiles_y
    dev = batch.xy.device
    x, y = batch.xy[..., 0], batch.xy[..., 1]

    area = _edge(x[:, 0], y[:, 0], x[:, 1], y[:, 1], x[:, 2], y[:, 2])
    valid = batch.valid & (area.abs() > 1e-9)
    if cfg.cull_backfaces:
        valid = valid & (area < 0)
    xmin, xmax = x.amin(dim=-1), x.amax(dim=-1)
    ymin, ymax = y.amin(dim=-1), y.amax(dim=-1)
    valid = valid & (xmax >= 0) & (xmin < float(tiles_x * cfg.tile_w)) \
        & (ymax >= 0) & (ymin < float(tiles_y * cfg.tile_h))

    def tile_of(v, size, n):
        # bound the float before the int cast (garbage rows of invalid
        # triangles must not hit an undefined out-of-range conversion)
        q = (v / float(size)).clamp(-1.0, float(n))
        return q.to(torch.int32).clamp(0, n - 1)

    tx0, tx1 = tile_of(xmin, cfg.tile_w, tiles_x), tile_of(xmax, cfg.tile_w,
                                                           tiles_x)
    ty0, ty1 = tile_of(ymin, cfg.tile_h, tiles_y), tile_of(ymax, cfg.tile_h,
                                                           tiles_y)
    wx = tx1 - tx0 + 1
    wy = ty1 - ty0 + 1
    ncover = wx * wy
    mt = cfg.max_tiles_per_tri
    overflow = valid & (ncover > mt)
    binned = valid & ~overflow

    m = torch.arange(mt, dtype=torch.int32, device=dev)
    wx1 = wx.clamp(min=1)[:, None]
    dy = torch.div(m[None, :], wx1, rounding_mode="floor")
    dx = m[None, :] - dy * wx1
    pair_ok = binned[:, None] & (m[None, :] < ncover[:, None])
    tile = (ty0[:, None] + dy) * tiles_x + (tx0[:, None] + dx)

    zc = (batch.z[:, 0] + batch.z[:, 1] + batch.z[:, 2]) / 3.0
    bucket = ((zc * 0.5 + 0.5) * 255.0).clamp(-1.0, 256.0).to(
        torch.int32).clamp(0, 255)
    classed = tri_class is not None
    if classed:
        cls_bit = (tri_class >= 1.5).to(torch.int32)
        base = tile * 2 + cls_bit[:, None]
        sentinel = (nt * 2) << 8
    else:
        base = tile
        sentinel = nt << 8
    key = (base << 8) | bucket[:, None]
    pair_key = torch.where(pair_ok, key,
                           torch.full_like(key, sentinel)).reshape(-1)
    pair_tri = torch.arange(t, dtype=torch.int32, device=dev)[:, None] \
        .expand(t, mt).reshape(-1)
    sorted_key, order = torch.sort(pair_key, stable=True)
    sorted_tri = pair_tri[order]

    # live pairs are a sorted prefix (sentinel keys are largest)
    pair_sliced = torch.zeros((), dtype=torch.int64, device=dev)
    if cfg.pair_budget is not None and cfg.pair_budget < pair_key.shape[0]:
        pb = cfg.pair_budget
        pair_sliced = (sorted_key[pb:] < sentinel).sum()
        sorted_key = sorted_key[:pb]
        sorted_tri = sorted_tri[:pb]

    # rank of each pair within its (tile, class) run
    length = sorted_key.shape[0]
    pos = torch.arange(length, dtype=torch.int64, device=dev)
    sbase = sorted_key >> 8
    newrun = torch.ones(length, dtype=torch.bool, device=dev)
    newrun[1:] = sbase[1:] != sbase[:-1]
    run_start = torch.cummax(torch.where(newrun, pos, torch.zeros_like(pos)),
                             dim=0).values
    rank = pos - run_start
    live = sorted_key < sentinel
    bt, btr = cfg.tile_budget, cfg.trans_tile_budget
    if classed:
        tile_id = (sbase >> 1).long()
        is_trans = (sbase & 1) == 1
        ok = live & (rank < torch.where(is_trans, btr, bt))
    else:
        tile_id = sbase.long()
        is_trans = torch.zeros_like(live)
        ok = live & (rank < bt)

    def fill(sel, width):
        # one (tile, rank) cell per selected pair; dropped pairs land in
        # the spare row nt
        row = torch.where(sel, tile_id, torch.full_like(tile_id, nt))
        col = torch.where(sel, rank, torch.zeros_like(rank))
        win = torch.full((nt + 1, max(width, 1)), -1, dtype=torch.int32,
                         device=dev)
        win[row, col] = sorted_tri
        return win[:nt, :width]

    tile_cand = fill(ok & ~is_trans, bt)
    trans_cand = fill(ok & is_trans, btr) if classed else None
    cand_dropped = ((live & ~ok).sum() + pair_sliced).to(torch.int32)

    gb = cfg.global_budget
    grank = torch.cumsum(overflow.to(torch.int64), 0) - 1
    dest = torch.where(overflow & (grank < gb), grank,
                       torch.full_like(grank, gb))
    global_list = torch.full((gb + 1,), -1, dtype=torch.int32, device=dev)
    global_list[dest] = torch.arange(t, dtype=torch.int32, device=dev)
    global_list = global_list[:gb]
    if classed:
        return tile_cand, global_list, valid, trans_cand, cand_dropped
    return tile_cand, global_list, valid, cand_dropped


def rasterize_depth_winner(batch: TriangleBatch, height: int, width: int,
                           cfg: RasterConfig = RasterConfig(), tri_mask=None,
                           chunk: int = 8):
    """Golden raster: (depth (H, W) NDC, winner (H, W) int32 triangle id or
    -1). ``tri_mask`` restricts which triangles draw (the opaque and the
    transparent pass share one batch). Every tile marches its window and
    the global list ``chunk`` candidates at a time; the nearest depth wins
    and the first candidate seen wins a tie, as in K1. The edge functions
    and the depth sum are K1's fused forms (``raster_pallas._edge_test``),
    so both agree on edges and ties."""
    from render_engine_tpu_torch.render.raster_pallas import (_edge_test,
                                                              _fma)

    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-width // tw), -(-height // th)
    nt = tiles_x * tiles_y
    dev = batch.xy.device
    if tri_mask is not None:
        batch = dataclasses.replace(batch, valid=batch.valid & tri_mask)
    tile_cand, global_list, _, _ = _bin_triangles(batch, cfg, tiles_x,
                                                  tiles_y)
    cand = torch.cat([tile_cand,
                      global_list[None].expand(nt, cfg.global_budget)], dim=1)
    k = cand.shape[1]
    n_chunks = -(-k // chunk)
    if n_chunks * chunk > k:
        cand = torch.cat([cand, cand.new_full((nt, n_chunks * chunk - k),
                                              -1)], dim=1)
    tids = torch.arange(nt, device=dev)
    oy = (torch.div(tids, tiles_x, rounding_mode="floor") * th).to(
        torch.float32)
    ox = ((tids % tiles_x) * tw).to(torch.float32)
    py = (oy[:, None, None, None] + torch.arange(
        th, dtype=torch.float32, device=dev)[None, None, :, None]) + 0.5
    px = (ox[:, None, None, None] + torch.arange(
        tw, dtype=torch.float32, device=dev)[None, None, None, :]) + 0.5
    x, y, z = batch.xy[..., 0], batch.xy[..., 1], batch.z
    inf = float("inf")
    best_d = torch.full((nt, th, tw), inf, device=dev)
    best_t = torch.full((nt, th, tw), -1, dtype=torch.int32, device=dev)
    order = torch.arange(chunk, device=dev)[None, :, None, None]
    for i in range(n_chunks):
        c = cand[:, i * chunk:(i + 1) * chunk]  # (NT, C)
        cs = c.clamp(0, batch.budget - 1).long()
        v = lambda a, j: a[cs][..., j, None, None]  # noqa: E731
        l0, l1, l2, area, inside = _edge_test(
            v(x, 0), v(y, 0), v(x, 1), v(y, 1), v(x, 2), v(y, 2), px, py)
        inside = inside & (c >= 0)[..., None, None]
        inv_area = 1.0 / torch.where(area.abs() > 1e-9, area,
                                     torch.ones_like(area))
        d = _fma(l2, v(z, 2), _fma(l0, v(z, 0), l1 * v(z, 1))) * inv_area
        inside = inside & (d >= -1.0) & (d <= 1.0)
        d = torch.where(inside, d, inf)
        dmin = d.amin(dim=1)
        first = torch.where(d == dmin[:, None], order, chunk).amin(dim=1)
        tmin = torch.gather(c, 1, first.clamp(max=chunk - 1).reshape(
            nt, th * tw)).reshape(nt, th, tw)
        closer = dmin < best_d
        best_d = torch.where(closer, dmin, best_d)
        best_t = torch.where(closer, tmin, best_t)

    def untile(a):
        a = a.reshape(tiles_y, tiles_x, th, tw).permute(0, 2, 1, 3)
        return a.reshape(tiles_y * th, tiles_x * tw)[:height, :width]

    depth, winner = untile(best_d), untile(best_t)
    return torch.where(winner >= 0, depth, torch.ones_like(depth)), winner


def resolve_gbuffer(batch: TriangleBatch, bank, depth, winner, atlas=None,
                    with_specular: bool = False, with_emissive: bool = False,
                    with_dissolve: bool = False):
    """Per-pixel attribute interpolation for the winning triangles: world
    position, normal, albedo (textured with an atlas), material id.

    Returns the ``GBuffer``; with flags (and an atlas) a tuple that appends,
    in this order, the specular-strength image (``with_specular`` or
    ``with_emissive``), the emissive-map multiplier (``with_emissive``) and
    the dissolve-map alpha multiplier (``with_dissolve``, last)."""
    h, w = depth.shape
    dev = depth.device
    tri = winner.clamp(0, batch.budget - 1).long()
    covered = winner >= 0
    vx = batch.xy[tri][..., 0]  # (H, W, 3)
    vy = batch.xy[tri][..., 1]
    px = torch.arange(w, dtype=torch.float32, device=dev)[None, :] + 0.5
    py = torch.arange(h, dtype=torch.float32, device=dev)[:, None] + 0.5

    def e(a, b):
        return ((vx[..., b] - vx[..., a]) * (py - vy[..., a])
                - (vy[..., b] - vy[..., a]) * (px - vx[..., a]))

    l0, l1, l2 = e(1, 2), e(2, 0), e(0, 1)
    area = l0 + l1 + l2
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area,
                                 torch.ones_like(area))
    bary = torch.stack([l0, l1, l2], dim=-1) * inv_area[..., None]
    wi = bary * batch.inv_w[tri]
    denom = wi.sum(dim=-1, keepdim=True)
    pl = wi / torch.where(denom.abs() > 1e-12, denom, torch.ones_like(denom))

    pos = (batch.world_pos[tri] * pl[..., None]).sum(dim=-2)
    nrm = (batch.normal[tri] * pl[..., None]).sum(dim=-2)
    nlen = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.where(nlen > 1e-12, nlen, torch.ones_like(nlen))
    mat = batch.material[tri]
    mat_safe = mat.clamp(0, bank.mat_albedo.shape[0] - 1).long()
    albedo = bank.mat_albedo[mat_safe]
    spec_img = emis_mul = uv = None
    if atlas is not None:
        uv = (batch.uv[tri] * pl[..., None]).sum(dim=-2)  # (H, W, 2)

        def mapped(layer_ids, default=1.0):
            # a map's red channel where the material carries one
            layer = layer_ids[mat_safe]
            smp = sample_atlas(atlas, layer, uv)[..., 0]
            return torch.where(layer >= 0, smp,
                               torch.full_like(smp, default))

        layer = bank.mat_texture[mat_safe]
        tex = sample_atlas(atlas, layer, uv)
        albedo = torch.where((layer >= 0)[..., None], tex, albedo)
        if with_specular:
            spec_img = bank.mat_specular_eff[mat_safe] * mapped(
                bank.mat_texture_spec)
        if with_emissive:
            emis_mul = mapped(bank.mat_texture_emis)
        if bank.has_normal_maps():
            nlayer = bank.mat_texture_norm[mat_safe]
            nsamp = sample_atlas(atlas, nlayer, uv)
            tan, handed = triangle_tangents(batch)
            pert = perturb_normal(nrm, tan[tri], handed[tri], nsamp)
            nrm = torch.where((nlayer >= 0)[..., None], pert, nrm)

    cm = covered[..., None]
    zero3 = torch.zeros_like(pos)
    gbuf = GBuffer(
        depth=depth, position=torch.where(cm, pos, zero3),
        normal=torch.where(cm, nrm, zero3),
        albedo=torch.where(cm, albedo, zero3),
        material=torch.where(covered, mat,
                             torch.full_like(mat, MATERIAL_BACKGROUND)),
        tri_id=winner)
    out = [gbuf]
    if with_specular or with_emissive:
        out.append(spec_img)
    if with_emissive:
        out.append(emis_mul)
    if with_dissolve:
        out.append(mapped(bank.mat_texture_diss) if atlas is not None
                   else torch.ones_like(depth))
    return gbuf if len(out) == 1 else tuple(out)


def render_gbuffer(batch: TriangleBatch, bank, height: int, width: int,
                   cfg: RasterConfig = RasterConfig(), tri_mask=None,
                   atlas=None, rasterizer=rasterize_depth_winner) -> GBuffer:
    depth, winner = rasterizer(batch, height, width, cfg, tri_mask)
    return resolve_gbuffer(batch, bank, depth, winner, atlas=atlas)
