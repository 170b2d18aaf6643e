"""Tile rasterizer (kernel K1) and attribute resolve (kernel K2).

Port of ``render_engine_tpu/render/raster_pallas.py`` (the module keeps
the JAX package's name so the two line up). On the GPU both kernels are
the hand-written CUDA in ``csrc/tile_raster.cu`` and ``csrc/resolve.cu``;
for CPU tensors each wrapper runs its plain PyTorch version, which loops
over candidates exactly like the Pallas kernel's ``fori_loop``.

Kernel contracts (unchanged from the JAX package):

* K1 ``tile_raster(data (NT,10,K) f32, ids (NT,1,K) i32, counts (NT,1,3)
  i32)``: per 8x128 screen tile, march the candidate segments [0, B)
  opaque, [B, B+BT) transparent, [B+BT, ...) global with trip counts from
  ``counts``; per pixel center, three edge functions (either winding),
  |area| > 1e-9, class > 0, NDC depth in [-1, 1]; nearest wins with a
  strict ``<`` so the first candidate seen wins a tie. Outputs depth
  (1.0 where empty), winner triangle id (-1) and winner slot, for one
  layer or (``two_pass``) opaque and transparent layers.
* K2 ``resolve_attributes(slot (TB,th,tw) i32, rows (TB,K,A) f32)``:
  ``out[a, t, y, x] = rows[t, slot[t, y, x], a]``, 0 where slot < 0.

``gbuffers_tall`` builds the non-fused frame's G-buffers in the tall tile
layout (one binning, one K1 launch, then ``tall_gbuffer``: on a card one
kernel, csrc/tall_gbuffer.cu, reads each covered pixel's winner row in
place for both layers; its plain version is K2 over every tile of each
layer with ``_gbuffer_from_channels`` and ``_shading_planes``), with the
shading planes that path hands ``deferred_shade``;
``render_gbuffers_pallas`` untiles them to the image.
"""

from __future__ import annotations

import dataclasses

import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.render.gbuffer import (MATERIAL_BACKGROUND,
                                                    GBuffer)
from render_engine_tpu_torch.render.geometry import (TriangleBatch,
                                                     triangle_tangents)
from render_engine_tpu_torch.render.raster_jnp import (RasterConfig,
                                                       _bin_triangles)
from render_engine_tpu_torch.runtime import profiling as P

# packed per-candidate attribute channels (A axis), as in the JAX package:
#   0:10 x0 y0 x1 y1 x2 y2 z0 z1 z2 cls | 10:19 normals | 19:25 uvs |
#   25:28 inv_w | 28 material | 29:32 albedo | 32 emissive | 33 alpha |
#   34 specular (or the packed spec/Ns) | 35 texture layer | 36:40 rect |
#   40 spec-map layer | 41:45 rect | 45 emissive-map layer | 46:50 rect |
#   50 normal-map layer | 51:55 rect | 55:58 tangent | 58 handedness |
#   59 dissolve-map layer | 60:64 rect
N_ATTR_BASE = 48
N_ATTR = 56
N_ATTR_NORM = 64

K1_THREADS = 256


def _candidate_table(batch, cfg, tiles_x, tiles_y, tri_class=None,
                     with_dropped=False):
    """Bin once: (NT, K) candidate ids (-1 invalid) = [opaque window |
    transparent window | global list], and (NT, 1, 3) int32 counts; with
    ``with_dropped`` also the binning's dropped-candidate count."""
    nt = tiles_x * tiles_y
    if tri_class is not None:
        tile_cand, global_list, _, trans_cand, dropped = _bin_triangles(
            batch, cfg, tiles_x, tiles_y, tri_class)
    else:
        tile_cand, global_list, _, dropped = _bin_triangles(
            batch, cfg, tiles_x, tiles_y)
        trans_cand = torch.full((nt, cfg.trans_tile_budget), -1,
                                dtype=torch.int32, device=tile_cand.device)
    cand = torch.cat([tile_cand, trans_cand,
                      global_list[None].expand(nt, cfg.global_budget)], dim=1)
    n_tile = (tile_cand >= 0).sum(dim=1, dtype=torch.int32)
    n_trans = (trans_cand >= 0).sum(dim=1, dtype=torch.int32)
    n_glob = (global_list >= 0).sum(dtype=torch.int32)
    counts = torch.stack([n_tile, n_trans, n_glob.expand(nt)],
                         dim=-1)[:, None, :]
    if with_dropped:
        return cand, counts, dropped
    return cand, counts


def _prepare_candidates(batch, cfg, tiles_x, tiles_y, tri_class, cand=None,
                        counts=None, classed=False):
    """The raster's per-candidate scalars, channel-leading (NT, 10, K),
    the candidate triangle ids (NT, 1, K) and the counts."""
    if cand is None:
        cand, counts = _candidate_table(batch, cfg, tiles_x, tiles_y,
                                        tri_class if classed else None)
    t = batch.budget
    x, y = batch.xy[..., 0], batch.xy[..., 1]
    packed = torch.cat([x[:, 0:1], y[:, 0:1], x[:, 1:2], y[:, 1:2],
                        x[:, 2:3], y[:, 2:3], batch.z, tri_class[:, None]],
                       dim=1)  # (T, 10)
    rows = packed[cand.clamp(0, t - 1).long()]  # (NT, K, 10)
    data = rows.transpose(1, 2).contiguous()
    ids = torch.where(cand >= 0, cand, torch.full_like(cand, -1))[:, None, :]
    return data, ids.contiguous(), counts.contiguous()


def _packed_tri_table(batch, bank, tri_class, ent_attrs=None, atlas=None):
    """One (T, A) f32 per-triangle channel table (layout above), A = 48,
    56 or 64 depending on which texture roles the scene carries."""
    t = batch.budget
    dev = batch.xy.device
    x, y = batch.xy[..., 0], batch.xy[..., 1]
    mat_safe = batch.material.clamp(0, bank.mat_albedo.shape[0] - 1).long()
    albedo = bank.mat_albedo[mat_safe]
    emissive = bank.mat_emissive[mat_safe]
    alpha = bank.mat_alpha[mat_safe]
    if bank.uniform_shininess() is not None:
        specular = bank.mat_specular[mat_safe]
    else:
        specular = bank.mat_spec_shin_packed[mat_safe]

    def none_cols():
        return (torch.full((t,), -1.0, device=dev),
                torch.zeros((t, 4), device=dev))

    with_emis = with_norm = with_diss = False
    if atlas is not None:
        def tex_cols(tex_ids):
            ts = tex_ids.clamp(0, atlas.num_textures - 1).long()
            lay = torch.where(tex_ids >= 0,
                              atlas.tex_layer[ts].to(torch.float32),
                              torch.full((t,), -1.0, device=dev))
            return lay, atlas.uv_rect[ts]

        layer, uvs = tex_cols(bank.mat_texture[mat_safe])
        slayer, suvs = tex_cols(bank.mat_texture_spec[mat_safe])
        with_emis = bank.has_emissive_maps()
        with_norm = bank.has_normal_maps()
        with_diss = bank.has_dissolve_maps()
        elayer, euvs = (tex_cols(bank.mat_texture_emis[mat_safe])
                        if with_emis else none_cols())
        nlayer, nuvs = (tex_cols(bank.mat_texture_norm[mat_safe])
                        if with_norm else none_cols())
        dlayer, duvs = (tex_cols(bank.mat_texture_diss[mat_safe])
                        if with_diss else none_cols())
    else:
        uvs = suvs = torch.ones((t, 4), device=dev)
        layer = slayer = torch.full((t,), -1.0, device=dev)
        elayer, euvs = none_cols()
        nlayer, nuvs = none_cols()
        dlayer, duvs = none_cols()
    if with_norm:
        tangent, handed = triangle_tangents(batch)
    else:
        tangent = torch.zeros((t, 3), device=dev)
        handed = torch.ones((t,), device=dev)
    if ent_attrs is not None:
        sa = ent_attrs[batch.entity.clamp(0, ent_attrs.shape[0] - 1).long()]
        unlit, boost, ascale = sa[:, 0] > 0.5, sa[:, 1], sa[:, 5]
        albedo = albedo * sa[:, 2:5]
        emissive = torch.where(unlit, torch.clamp(emissive, min=1.0) * boost,
                               emissive)
        alpha = torch.clamp(alpha * ascale, 0.0, 1.0)
    width = (N_ATTR_NORM if (with_norm or with_diss)
             else (N_ATTR if with_emis else N_ATTR_BASE))
    return torch.cat([
        x[:, 0:1], y[:, 0:1], x[:, 1:2], y[:, 1:2], x[:, 2:3], y[:, 2:3],
        batch.z, tri_class[:, None], batch.normal.reshape(t, 9),
        batch.uv.reshape(t, 6), batch.inv_w,
        batch.material.to(torch.float32)[:, None], albedo,
        emissive[:, None], alpha[:, None], specular[:, None],
        layer[:, None], uvs, slayer[:, None], suvs, elayer[:, None], euvs,
        nlayer[:, None], nuvs, tangent, handed[:, None], dlayer[:, None],
        duvs], dim=1)[:, :width].contiguous()


def _gather_candidate_rows(packed, cand):
    """(T, A) table + (NT, K) ids -> (NT, K, A); empty slots read row 0
    (never consumed: trip counts and winner slots stay in the prefix)."""
    return packed[cand.clamp(0, packed.shape[0] - 1).long()].contiguous()


# ---------------------------------------------------------------------------
# K1: tile raster
# ---------------------------------------------------------------------------
# The JAX reference's compiled arithmetic contracts the edge functions and
# the depth sum into fused multiply-adds:
#   l = fma(bx - ax, py - ay, -((by - ay) * (px - ax)))
#   d = fma(l2, z2, fma(l0, z0, l1 * z1)) / area
# K1 computes exactly these fused forms (fmaf in the kernel, nothing else
# contracted), so winners, slots and depths match it bit for bit. The plain
# version forms each fma in float64: the product of two floats is exact
# there; the sum is rounded to float64 and then to float32, and the one
# case where that double rounding differs from the fma's single rounding
# (the float64 sum lands exactly halfway between two floats) is corrected
# with the sum's exact error term.
def _fma(a, b, c):
    p = a.double() * b.double()
    c = c.double()
    s = p + c
    r = s.float()
    bp = s - p
    err = (p - (s - bp)) + (c - bp)  # exact: s + err == p + c (TwoSum)
    rd = r.double()
    other = torch.nextafter(r, torch.where(s > rd, float("inf"),
                                           float("-inf")).float())
    od = other.double()
    halfway = (s - rd) == (od - s)
    toward = halfway & (err != 0) & ((err > 0) == (od > rd))
    return torch.where(toward, other, r)


def _edge_fma(ax, ay, bx, by, px, py):
    return _fma(bx - ax, py - ay, -((by - ay) * (px - ax)))


def _edge_test(x0, y0, x1, y1, x2, y2, px, py):
    """K1's fused edge functions at (px, py), their sum, and the edge test:
    all three >= 0 or all <= 0, and |area| > 1e-9."""
    l0 = _edge_fma(x1, y1, x2, y2, px, py)
    l1 = _edge_fma(x2, y2, x0, y0, px, py)
    l2 = _edge_fma(x0, y0, x1, y1, px, py)
    area = (l0 + l1) + l2
    inside = (((l0 >= 0.0) & (l1 >= 0.0) & (l2 >= 0.0))
              | ((l0 <= 0.0) & (l1 <= 0.0) & (l2 <= 0.0)))
    return l0, l1, l2, area, inside & (area.abs() > 1e-9)


# K1 skips, per warp, a candidate whose conservative screen box misses the
# warp's pixel centres (csrc/tile_raster.cu, skip_box). k1_skip_boxes
# computes the same boxes for the CPU tests; the plain version above does
# not cull. A box is the vertex box grown by (width, height) * 2E/|A|,
# where A is the triangle's doubled area and E bounds the rounding errors of
# the three fused edge functions over the tile: an accepted centre has
# barycentrics >= -E/|A|. Slivers (|A| <= 2E), coordinates beyond 2^24 and
# NaN get an unbounded box.
_K1_MAX_COORD = 2.0 ** 24


def _f32_outward(x, up):
    """float64 -> float32, rounded toward +inf (``up``) or -inf."""
    r = x.float()
    step = (r.double() < x) if up else (r.double() > x)
    toward = torch.full_like(r, float("inf") if up else float("-inf"))
    return torch.where(step, torch.nextafter(r, toward), r)


def k1_skip_boxes(data, *, tiles_x, tile_h, tile_w):
    """(NT, 4, K) f32 boxes [xlo, xhi, ylo, yhi]: no pixel centre of tile t
    outside box (t, :, k) passes candidate k's rounded edge test."""
    nt = data.shape[0]
    v = data[:, :6].double()
    x, y = v[:, 0::2], v[:, 1::2]  # (NT, 3, K)
    tids = torch.arange(nt, device=data.device)
    ox = ((tids % tiles_x) * tile_w).double()[:, None]
    oy = (torch.div(tids, tiles_x, rounding_mode="floor")
          * tile_h).double()[:, None]
    pxlo, pxhi = ox + 0.5, ox + (tile_w - 0.5)
    pylo, pyhi = oy + 0.5, oy + (tile_h - 0.5)
    ok = ((x.abs() <= _K1_MAX_COORD) & (y.abs() <= _K1_MAX_COORD)).all(1)
    eb = torch.zeros_like(x[:, 0])
    for a, b in ((1, 2), (2, 0), (0, 1)):
        eb = eb + ((x[:, b] - x[:, a]).abs()
                   * torch.maximum((pylo - y[:, a]).abs(),
                                   (pyhi - y[:, a]).abs())
                   + (y[:, b] - y[:, a]).abs()
                   * torch.maximum((pxlo - x[:, a]).abs(),
                                   (pxhi - x[:, a]).abs()))
    eb = eb * (4.0 * 2.0 ** -24) + 2.0 ** -100
    p1 = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0])
    p2 = (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    area = (p1 - p2).abs() - 2.0 ** -48 * (p1.abs() + p2.abs())
    ok = ok & (area > 2.0 * eb)
    s = (2.0 * eb) / area
    xmin, xmax = x.amin(1), x.amax(1)
    ymin, ymax = y.amin(1), y.amax(1)
    mx = (xmax - xmin) * s + 2.0 ** -20
    my = (ymax - ymin) * s + 2.0 ** -20
    box = torch.stack([_f32_outward(xmin - mx, False),
                       _f32_outward(xmax + mx, True),
                       _f32_outward(ymin - my, False),
                       _f32_outward(ymax + my, True)], dim=1)
    inf = float("inf")
    unbounded = torch.tensor([-inf, inf, -inf, inf],
                             device=data.device)[None, :, None]
    return torch.where(ok[:, None], box, unbounded)


def k1_outside(box, px, py):
    """Pixel centres (px, py) that K1 skips for a box [xlo, xhi, ylo,
    yhi] (broadcasting; a NaN centre is never skipped)."""
    return (px < box[0]) | (px > box[1]) | (py < box[2]) | (py > box[3])


def tile_raster_reference(data, ids, counts, *, tiles_x, tile_h, tile_w,
                          tile_budget, trans_budget, two_pass):
    """Plain PyTorch K1: the kernel's candidate loop over (NT, th, tw)."""
    nt, _, k = data.shape
    dev = data.device
    tids = torch.arange(nt, device=dev)
    oy = (torch.div(tids, tiles_x, rounding_mode="floor") * tile_h).to(
        torch.float32)
    ox = ((tids % tiles_x) * tile_w).to(torch.float32)
    py = (torch.arange(tile_h, device=dev, dtype=torch.float32)[None, :, None]
          + oy[:, None, None]) + 0.5
    px = (torch.arange(tile_w, device=dev, dtype=torch.float32)[None, None, :]
          + ox[:, None, None]) + 0.5
    shape = (nt, tile_h, tile_w)
    inf = torch.full(shape, float("inf"), device=dev)
    neg = torch.full(shape, -1, dtype=torch.int32, device=dev)
    best = [inf, neg, neg] + ([inf, neg, neg] if two_pass else [])
    cnt = counts[:, 0, :].long()
    starts = (0, tile_budget, tile_budget + trans_budget)
    for seg in range(3):
        n_seg = cnt[:, seg]
        for j in range(int(n_seg.max()) if nt else 0):
            kk = starts[seg] + j
            run = (j < n_seg)[:, None, None]
            c = [data[:, i, kk][:, None, None] for i in range(10)]
            x0, y0, x1, y1, x2, y2, z0, z1, z2, cls = c
            tid = ids[:, 0, kk][:, None, None]
            l0, l1, l2, area, inside = _edge_test(x0, y0, x1, y1, x2, y2,
                                                  px, py)
            inside = inside & (cls > 0.0) & run
            nz = area.abs() > 1e-9
            inv_area = 1.0 / torch.where(nz, area, torch.ones_like(area))
            d = _fma(l2, z2, _fma(l0, z0, l1 * z1)) * inv_area
            inside = inside & (d >= -1.0) & (d <= 1.0)
            layers = ([(inside & (cls < 1.5), 0), (inside & (cls > 1.5), 3)]
                      if two_pass else [(inside, 0)])
            for m, o in layers:
                dm = torch.where(m, d, inf)
                upd = dm < best[o]
                best[o] = torch.where(upd, dm, best[o])
                best[o + 1] = torch.where(upd, tid, best[o + 1])
                best[o + 2] = torch.where(upd, torch.full_like(neg, kk),
                                          best[o + 2])
    outs = []
    for o in range(0, len(best), 3):
        outs += [torch.where(best[o + 1] >= 0, best[o],
                             torch.ones_like(best[o])),
                 best[o + 1], best[o + 2]]
    return outs


def tile_raster(data, ids, counts, *, tiles_x, tile_h, tile_w, tile_budget,
                trans_budget, two_pass):
    """K1. CPU tensors run the plain version; CUDA tensors launch the
    kernel (csrc/tile_raster.cu)."""
    kw = dict(tiles_x=tiles_x, tile_h=tile_h, tile_w=tile_w,
              tile_budget=tile_budget, trans_budget=trans_budget,
              two_pass=two_pass)
    if data.device.type == "cpu":
        return tile_raster_reference(data, ids, counts, **kw)
    nt, _, k = data.shape
    dev = data.device
    # a thread owns one column and up to 4 rows of the tile
    if tile_w > K1_THREADS or -(-tile_h // (K1_THREADS // tile_w)) > 4:
        raise ValueError(f"K1 takes no {tile_h}x{tile_w} tile: at most "
                         f"{K1_THREADS} columns and 4 rows a thread")
    kernels.check(data, "data", torch.float32, (nt, 10, k), dev)
    kernels.check(ids, "ids", torch.int32, (nt, 1, k), dev)
    kernels.check(counts, "counts", torch.int32, (nt, 1, 3), dev)
    n_out = 6 if two_pass else 3
    outs = [torch.empty((nt, tile_h, tile_w),
                        dtype=torch.float32 if i % 3 == 0 else torch.int32,
                        device=dev) for i in range(n_out)]
    p = [kernels.ptr(o) for o in outs] + [None] * (6 - n_out)
    kernels.launch("launch_tile_raster", "tile_raster",
                   kernels.ptr(data), kernels.ptr(ids), kernels.ptr(counts),
                   *p, nt, k, tiles_x, tile_h, tile_w, tile_budget,
                   trans_budget, int(two_pass), kernels.stream_ptr(dev))
    if not two_pass:
        kernels.LAUNCHES["tile_raster_one_pass"] += 1
    return outs


def _launch(batch, height, width, cfg, tri_class, two_pass, cand=None,
            counts=None, classed=False):
    """Prepare the candidate block and run K1; tiled (NT, th, tw) outputs."""
    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x = -(-width // tw)
    tiles_y = -(-height // th)
    data, ids, counts = _prepare_candidates(batch, cfg, tiles_x, tiles_y,
                                            tri_class, cand, counts,
                                            classed=classed)
    return tile_raster(data, ids, counts, tiles_x=tiles_x, tile_h=th,
                       tile_w=tw, tile_budget=cfg.tile_budget,
                       trans_budget=cfg.trans_tile_budget,
                       two_pass=two_pass)


def _untile(a, tiles_y, tiles_x, th, tw, height, width):
    """(NT, th, tw) tiles -> (height, width) image rows."""
    return _untile_tall(a.reshape(-1, tw), tiles_y, tiles_x, th, tw, height,
                        width)


def _untile_tall(a, tiles_y, tiles_x, th, tw, height, width):
    """The tall tile layout (NT * th, tw, ...) -> (height, width, ...)."""
    rest = a.shape[2:]
    a = a.reshape(tiles_y, tiles_x, th, tw, *rest).transpose(1, 2)
    return a.reshape(tiles_y * th, tiles_x * tw, *rest)[:height, :width]


def _tall_pixel_centers(tids, tiles_x, th, twd):
    """Pixel-center (px, py), each (NT * th, tw) float32, of the tiles
    ``tids`` in the tall layout (tile after tile, band-local rows)."""
    nt, dev = tids.shape[0], tids.device
    oy = (torch.div(tids, tiles_x, rounding_mode="floor") * th).to(
        torch.float32)
    ox = ((tids % tiles_x) * twd).to(torch.float32)
    py = (oy[:, None, None] + torch.arange(th, dtype=torch.float32,
                                           device=dev)[None, :, None]) + 0.5
    px = (ox[:, None, None] + torch.arange(twd, dtype=torch.float32,
                                           device=dev)[None, None, :]) + 0.5
    return (px.expand(nt, th, twd).reshape(nt * th, twd),
            py.expand(nt, th, twd).reshape(nt * th, twd))


def rasterize_depth_winner_pallas(batch: TriangleBatch, height: int,
                                  width: int, cfg=RasterConfig(),
                                  tri_mask=None):
    """One-layer raster (the shadow-map mode): (depth, winner) images."""
    if tri_mask is not None:
        batch = dataclasses.replace(batch, valid=batch.valid & tri_mask)
    tri_class = batch.valid.to(torch.float32)
    tiles_x, tiles_y = -(-width // cfg.tile_w), -(-height // cfg.tile_h)
    depth, winner, _ = _launch(batch, height, width, cfg, tri_class,
                               two_pass=False)
    u = lambda a: _untile(a, tiles_y, tiles_x, cfg.tile_h, cfg.tile_w,  # noqa
                          height, width)
    return u(depth), u(winner)


def _tri_class(batch):
    return torch.where(batch.valid,
                       torch.where(batch.transparent, 2.0, 1.0),
                       0.0).to(torch.float32)


def rasterize_two_pass_pallas(batch: TriangleBatch, height: int, width: int,
                              cfg=RasterConfig()):
    """Opaque + transparent layers from one binning and one K1 launch:
    (depth, winner, t_depth, t_winner) images."""
    tiles_x, tiles_y = -(-width // cfg.tile_w), -(-height // cfg.tile_h)
    d, w, _s, td, twi, _ts = _launch(batch, height, width, cfg,
                                     _tri_class(batch), two_pass=True,
                                     classed=True)
    u = lambda a: _untile(a, tiles_y, tiles_x, cfg.tile_h, cfg.tile_w,  # noqa
                          height, width)
    return u(d), u(w), u(td), u(twi)


# ---------------------------------------------------------------------------
# K2: attribute resolve
# ---------------------------------------------------------------------------
def resolve_attributes_reference(slot_tiled, attrs_rows):
    """Plain PyTorch K2: direct indexed gather, channels leading."""
    tb, th, tw = slot_tiled.shape
    _, k, a = attrs_rows.shape
    flat = slot_tiled.reshape(tb, th * tw)
    hit = (flat >= 0) & (flat < k)  # the one-hot matches no row otherwise
    g = torch.gather(attrs_rows, 1,
                     torch.where(hit, flat, 0).long()[..., None].expand(
                         tb, th * tw, a))
    g = torch.where(hit[..., None], g, torch.zeros_like(g))
    return g.permute(2, 0, 1).reshape(a, tb, th, tw)


def resolve_attributes_pallas(slot_tiled, attrs_rows, cfg=None):
    """K2: (A, TB, th, tw) winner attributes, zeros where a pixel is empty.
    CPU tensors run the plain version; CUDA tensors launch
    csrc/resolve.cu."""
    if slot_tiled.device.type == "cpu":
        return resolve_attributes_reference(slot_tiled, attrs_rows)
    tb, th, tw = slot_tiled.shape
    _, k, a = attrs_rows.shape
    dev = slot_tiled.device
    kernels.check(slot_tiled, "slot", torch.int32, (tb, th, tw), dev)
    kernels.check(attrs_rows, "rows", torch.float32, (tb, k, a), dev)
    out = torch.empty((a, tb, th, tw), dtype=torch.float32, device=dev)
    kernels.launch("launch_resolve", "resolve", kernels.ptr(slot_tiled),
                   kernels.ptr(attrs_rows), kernels.ptr(out), tb, th * tw, k,
                   a, kernels.stream_ptr(dev))
    return out


def _gbuffer_from_channels(ch, depth, winner, height, width, inv_proj_view,
                           px=None, py=None, ndc_py=None):
    """The G-buffer from K2's channel images ``ch`` (A, H, W): elementwise
    interpolation, no gathers. World positions unproject ``depth`` through
    ``inv_proj_view`` (4, 4). Returns ``(GBuffer, extras)``; extras holds
    the per-pixel ``uv`` (and ``tangent`` / ``tangent_w`` for 64-channel
    rows), which custom shading samples the atlas with.

    ``px`` / ``py`` replace the pixel-center coordinates (the tiled layout
    passes its own; ``height`` / ``width`` are then the whole image's, for
    the NDC mapping). ``ndc_py`` replaces the y of the unprojection only: a
    band of image rows rasters with band-local triangle y, which the
    barycentrics need, while the unprojection needs the global row."""
    dev = depth.device
    covered = winner >= 0
    if px is None:
        px = torch.arange(width, dtype=torch.float32, device=dev)[None, :] \
            + 0.5
        py = torch.arange(height, dtype=torch.float32, device=dev)[:, None] \
            + 0.5
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

    ndc_x = (px / float(width) * 2.0 - 1.0).expand(depth.shape)
    ndc_y = (1.0 - (py if ndc_py is None else ndc_py) / float(height)
             * 2.0).expand(depth.shape)
    m = inv_proj_view
    wp = [m[r, 0] * ndc_x + m[r, 1] * ndc_y + m[r, 2] * depth + m[r, 3]
          for r in range(4)]
    inv_w = 1.0 / torch.where(wp[3].abs() > 1e-12, wp[3], one)
    pos = torch.stack([wp[0] * inv_w, wp[1] * inv_w, wp[2] * inv_w], dim=-1)

    nrm = torch.stack([p0 * ch[10 + i] + p1 * ch[13 + i] + p2 * ch[16 + i]
                       for i in range(3)], dim=-1)
    nlen = torch.linalg.vector_norm(nrm, dim=-1, keepdim=True)
    nrm = nrm / torch.where(nlen > 1e-12, nlen, torch.ones_like(nlen))
    uv = torch.stack([p0 * ch[19 + i] + p1 * ch[21 + i] + p2 * ch[23 + i]
                      for i in range(2)], dim=-1)
    mat = ch[28].to(torch.int32)
    albedo = torch.stack([ch[29], ch[30], ch[31]], dim=-1)

    cm = covered[..., None]
    zero3 = torch.zeros_like(pos)
    gbuf = GBuffer(
        depth=depth, position=torch.where(cm, pos, zero3),
        normal=torch.where(cm, nrm, zero3),
        albedo=torch.where(cm, albedo, zero3),
        material=torch.where(covered, mat,
                             torch.full_like(mat, MATERIAL_BACKGROUND)),
        tri_id=winner)
    extras = {"uv": uv}
    if ch.shape[0] >= N_ATTR_NORM:
        extras["tangent"] = torch.stack([ch[55], ch[56], ch[57]], dim=-1)
        extras["tangent_w"] = ch[58]
    return gbuf, extras


def _shading_planes(ch, winner, spec_packed=False):
    """The per-pixel planes ``lighting.shade`` takes from K2's channels on
    the non-fused path: ``emissive`` (0 where empty), ``alpha`` (1),
    ``specular`` (1) and, for packed (spec, Ns) rows, ``shininess``
    (``DEFAULT_SHININESS``). Kept apart from ``_gbuffer_from_channels``:
    custom shading on the fused path reads none of them."""
    from render_engine_tpu_torch.models.bank import (DEFAULT_SHININESS,
                                                     unpack_spec_shin)

    covered = winner >= 0
    if spec_packed:
        spec, shin = unpack_spec_shin(ch[34])
    else:
        spec, shin = ch[34], None
    planes = {"emissive": torch.where(covered, ch[32], 0.0),
              "alpha": torch.where(covered, ch[33], 1.0),
              "specular": torch.where(covered, spec, 1.0)}
    if shin is not None:
        planes["shininess"] = torch.where(covered, shin, DEFAULT_SHININESS)
    return planes


def gbuffers_tall(batch: TriangleBatch, bank, height: int, width: int,
                  cfg, inv_proj_view, ent_attrs=None):
    """The non-fused frame's G-buffers in the tall tile layout (NT * th,
    tw): one binning, one two-pass K1 launch, then ``tall_gbuffer`` over
    both layers (csrc/tall_gbuffer.cu on a card: each covered pixel's
    winner row read in place, no K2). ``(gbuf, extras, t_gbuf, t_extras)``,
    each ``extras`` holding ``uv`` and the shading planes
    (``_shading_planes``). Positions unproject through ``inv_proj_view``;
    ``ent_attrs`` are the render systems' per-entity rows, folded into the
    triangles' rows. A traced program keeps ``gbuffer_tiles_resolved``
    (``tall_gbuffer.count_resolved``)."""
    from render_engine_tpu_torch.render import tall_gbuffer as TG

    th, tw = cfg.tile_h, cfg.tile_w
    tiles_x, tiles_y = -(-width // tw), -(-height // th)
    tri_class = _tri_class(batch)
    cand, counts, *dropped = _candidate_table(batch, cfg, tiles_x, tiles_y,
                                              tri_class,
                                              with_dropped=P.armed())
    if dropped:  # a traced program keeps the count
        P.count("tile_candidate_dropped", dropped[0])
    rows = _gather_candidate_rows(
        _packed_tri_table(batch, bank, tri_class, ent_attrs=ent_attrs), cand)
    d, w, s, td, twi, ts = _launch(batch, height, width, cfg, tri_class,
                                   two_pass=True, cand=cand, counts=counts)
    if P.armed():
        TG.count_resolved((w, twi), kernel_route=rows.device.type == "cuda")
    return TG.tall_gbuffer(((s, d, w), (ts, td, twi)), rows, inv_proj_view,
                           tiles_x=tiles_x, width=width, height=height,
                           spec_packed=bank.uniform_shininess() is None)


def render_gbuffers_pallas(batch: TriangleBatch, bank, height: int,
                           width: int, cfg=RasterConfig(), proj_view=None):
    """``gbuffers_tall`` untiled to the image: ``(gbuf, extras, t_gbuf,
    t_extras)`` of (H, W) planes. Positions unproject through
    ``proj_view``'s inverse (the identity when None)."""
    if proj_view is None:
        inv_pv = torch.eye(4, dtype=torch.float32, device=batch.xy.device)
    else:
        from render_engine_tpu_torch.math import transforms as T

        inv_pv = T.inv44(proj_view)
    tiles = (-(-height // cfg.tile_h), -(-width // cfg.tile_w), cfg.tile_h,
             cfg.tile_w, height, width)
    out = []
    for i, part in enumerate(gbuffers_tall(batch, bank, height, width, cfg,
                                           inv_pv)):
        if i % 2:
            out.append({k: _untile_tall(v, *tiles) for k, v in part.items()})
        else:
            out.append(dataclasses.replace(part, **{
                f.name: _untile_tall(getattr(part, f.name), *tiles)
                for f in dataclasses.fields(part)}))
    return tuple(out)
