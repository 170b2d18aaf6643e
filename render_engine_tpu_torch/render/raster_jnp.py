"""Tile binning for the rasterizer.

Port of ``RasterConfig`` and ``_bin_triangles`` from
``render_engine_tpu/render/raster_jnp.py`` (the module keeps the JAX
package's name so the two line up; nothing here is jnp). Each valid
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

from render_engine_tpu_torch.render.geometry import TriangleBatch


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
