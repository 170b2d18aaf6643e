"""The frame's image and its shadow maps, written out plainly.

The semantics are the engine's specification (the JAX package's
``render/`` and the tiled route of ``render/frame.py``, not imported);
this file is a straightforward evaluation of them in PyTorch:

* triangles: frustum-culled entities, their level of view by distance to
  the camera, expanded in entity order into a fixed budget of rows,
  turned, scaled and moved, projected, cut at the near plane (a cut
  that leaves a quad puts its second triangle in the first unused row);
* bins: 8x128-pixel tiles; a triangle whose box covers at most 8 tiles
  joins each of their lists (opaque and transparent lists apart, nearest
  depth bucket first, up to a budget each, within a budget of pairs);
  a larger one joins a global list tested by every tile;
* raster: in each tile every candidate's edge functions at the pixel
  centres, both windings, depth interpolated in screen space, the
  nearest inside [-1, 1] winning, the earlier candidate on a tie; one
  layer of opaque triangles and one of transparent ones;
* shading: the winner's perspective-correct normal, texture coordinates
  and material (the stars unlit at six times their albedo), the position
  from the depth, Blinn-Phong over the spot lights with their smooth
  cones and attenuation, each light's shadow slots' 3x3 percentage-closer
  factor (taken at every third pixel and repeated, on the pattern of the
  route), a floor of 0.08 of the albedo; the texture atlas sampled
  bilinearly, a tangent-space normal map; the starfield behind; the
  transparent layer blended over, unshadowed; clipped to [0, 1];
* shadow maps: one slot updated every ``interval`` frames by the
  round-robin over the lights near the camera, the depth of the casters
  (two levels of view coarser) seen by the light's camera.

Where the routes differ (the fused route's shadow and texture tile
budgets and its per-tile pattern of shadow samples; the default route's
pattern over its stacked tiles), ``settings.fused`` selects."""

from __future__ import annotations

import torch

from port_bench.reference import demo as D
from port_bench.reference import xform as X

PCF_BIAS = 2e-3
DIFFUSE_FLOOR = 0.08
SHININESS = 64.0
SPACE_BASE = (0.004, 0.005, 0.012)
CHUNK = 4096  # (tile, candidate) pairs a raster step evaluates


# ---- triangles -----------------------------------------------------------
def triangles(w, sc, pv, eye, max_tris, lov_bias=0, depth_only=False):
    """The frame's triangles under the camera matrix ``pv`` (levels of
    view by distance to the camera at ``eye``): a dict of
    (T, ...) rows ``xy`` (NDC), ``z``, ``inv_w``, ``pos``, ``nrm``, ``uv``,
    ``mat``, ``ent``, ``transparent``, ``valid``."""
    bank, dev = sc.bank, pv.device
    cap = w["alive"].shape[0]
    mid = w["comps.model_id"]
    vis = w["alive"] & (mid >= 0)
    vis = vis & X.aabb_in_frustum(X.frustum_planes(pv), w["comps.aabb_min"],
                                  w["comps.aabb_max"])
    dist = X.norm(w["comps.position"] - eye[None])
    frac = dist / sc.cam["draw_distance"]
    band = (frac[:, None] >= bank["lov_fractions"][None]).sum(-1)
    band = (band + lov_bias).clamp(0, D.LOV_BANDS)
    safe = mid.clamp(0, bank["lov_table"].shape[0] - 1)
    mid = torch.where(mid >= 0, bank["lov_table"][safe, band], mid)
    mid_safe = mid.clamp(0, bank["tri_count"].shape[0] - 1)
    counts = torch.where(vis, bank["tri_count"][mid_safe], 0)
    starts = torch.cumsum(counts, 0) - counts
    total = int(counts.sum())
    ents = torch.repeat_interleave(torch.arange(cap, device=dev),
                                   counts)[:max_tris]
    n = ents.shape[0]
    t = max_tris
    ent = torch.zeros(t, dtype=torch.int64, device=dev)
    ent[:n] = ents
    valid = torch.arange(t, device=dev) < min(total, t)
    within = torch.arange(t, device=dev) - starts[ent]
    tri = (bank["tri_offset"][mid_safe[ent]] + within).clamp(
        0, bank["tri_v"].shape[0] - 1)
    tv = bank["tri_v"][tri]  # (T, 3)
    q = w["comps.orientation"][ent][:, None]
    s = w["comps.scale"][ent][:, None]
    p = w["comps.position"][ent][:, None]
    wpos = X.quat_rotate(q, bank["vertices"][tv] * s) + p
    if depth_only:
        nrm = torch.zeros_like(wpos)
        uv = torch.zeros(t, 3, 2, device=dev)
        mat = torch.zeros(t, dtype=torch.int64, device=dev)
        transparent = torch.zeros(t, dtype=torch.bool, device=dev)
    else:
        safe_s = torch.where(s.abs() > 1e-12, s, 1.0)
        nrm = X.quat_rotate(q, bank["normals"][tv] / safe_s)
        uv = bank["uvs"][tv]
        mat = bank["tri_material"][tri]
        transparent = (bank["alpha"][mat] < 1.0) | (
            (w["comps.flags"][ent] & D.FLAG_TRANSPARENT) != 0)
    homo = torch.cat([wpos, torch.ones_like(wpos[..., :1])], -1)
    clip = torch.einsum("ij,tnj->tni", pv, homo)
    clip, wpos, nrm, uv, mat, ent, transparent, valid = near_clip(
        clip, wpos, nrm, uv, mat, ent, transparent, valid, depth_only)
    cw = clip[..., 3]
    valid = valid & (cw > 1e-6).all(-1)
    inv_w = 1.0 / torch.where(cw.abs() > 1e-9, cw, 1.0)
    ndc = clip[..., :3] * inv_w[..., None]
    valid = valid & torch.isfinite(ndc[..., :2]).all(-1).all(-1)
    return {"xy": ndc[..., :2], "z": ndc[..., 2], "inv_w": inv_w,
            "pos": wpos, "nrm": nrm, "uv": uv, "mat": mat, "ent": ent,
            "transparent": transparent, "valid": valid}


def near_clip(clip, wpos, nrm, uv, mat, ent, transparent, valid,
              depth_only):
    """Triangles crossing the near plane (clip z = -w) cut: one vertex
    behind leaves a quad, whose first half replaces the row and whose
    second half takes the next unused row; two behind leave one triangle;
    three, none. Attributes are linear in the cut's parameter."""
    big = clip if depth_only else torch.cat([clip, wpos, nrm, uv], -1)
    sd = clip[..., 2] + clip[..., 3]
    inside = sd > 0.0
    n_in = inside.sum(-1)
    first_out = (~inside).to(torch.int8).argmax(-1)
    first_in = inside.to(torch.int8).argmax(-1)
    odd = torch.where(n_in == 2, first_out, first_in)
    idx = (odd[:, None] + torch.arange(3, device=clip.device)[None]) % 3
    big_r = torch.gather(big, 1, idx[..., None].expand_as(big))
    s_r = torch.gather(sd, 1, idx)
    e0 = s_r[:, 0] - s_r[:, 1]
    e1 = s_r[:, 0] - s_r[:, 2]
    t1 = s_r[:, 0] / torch.where(e0.abs() > 1e-12, e0, 1.0)
    t2 = s_r[:, 0] / torch.where(e1.abs() > 1e-12, e1, 1.0)
    a1 = big_r[:, 0] + t1[:, None] * (big_r[:, 1] - big_r[:, 0])
    a2 = big_r[:, 0] + t2[:, None] * (big_r[:, 2] - big_r[:, 0])
    quad_a = torch.stack([a1, big_r[:, 1], big_r[:, 2]], 1)
    quad_b = torch.stack([a1, big_r[:, 2], a2], 1)
    one = torch.stack([big_r[:, 0], a1, a2], 1)
    c2 = valid & (n_in == 2)
    c1 = valid & (n_in == 1)
    new_valid = (valid & (n_in == 3)) | c2 | c1
    out = torch.where(c2[:, None, None], quad_a,
                      torch.where(c1[:, None, None], one, big_r))
    free = torch.nonzero(~valid).flatten()
    src = torch.nonzero(c2).flatten()[:free.shape[0]]
    dst = free[:src.shape[0]]
    out[dst] = quad_b[src]
    mat, ent, transparent = mat.clone(), ent.clone(), transparent.clone()
    mat[dst], ent[dst], transparent[dst] = mat[src], ent[src], transparent[src]
    new_valid = new_valid.clone()
    new_valid[dst] = True
    if depth_only:
        return out, wpos, nrm, uv, mat, ent, transparent, new_valid
    return (out[..., 0:4], out[..., 4:7], out[..., 7:10], out[..., 10:12],
            mat, ent, transparent, new_valid)


def to_screen(tris, width, height):
    xy = tris["xy"]
    x = (xy[..., 0] * 0.5 + 0.5) * float(width)
    y = (0.5 - xy[..., 1] * 0.5) * float(height)
    return dict(tris, xy=torch.stack([x, y], -1))


# ---- bins ----------------------------------------------------------------
def bins(tris, cls, width, height, budget, trans_budget, global_budget,
         pair_budget, tile_h=8, tile_w=128, max_tiles=8):
    """Each tile's candidates in the order the tile marches them: the
    (tile, slot, triangle) of every binned triangle (opaque list first,
    ``budget`` of them at most; the transparent list after it,
    ``trans_budget``), then the global list (``global_budget`` triangles,
    lowest row first) at slots after both. ``cls`` (T,) is 0 for no
    triangle, 1 opaque, 2 transparent; ``trans_budget`` None: one list."""
    dev = cls.device
    t = cls.shape[0]
    tx, ty = -(-width // tile_w), -(-height // tile_h)
    nt = tx * ty
    x, y = tris["xy"][..., 0], tris["xy"][..., 1]
    area = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) \
        - (y[:, 1] - y[:, 0]) * (x[:, 2] - x[:, 0])
    ok = (cls > 0) & (area.abs() > 1e-9)
    xmin, xmax = x.min(-1).values, x.max(-1).values
    ymin, ymax = y.min(-1).values, y.max(-1).values
    ok = ok & (xmax >= 0) & (xmin < float(tx * tile_w)) & (ymax >= 0) \
        & (ymin < float(ty * tile_h))
    tx0 = (xmin / tile_w).to(torch.int64).clamp(0, tx - 1)
    tx1 = (xmax / tile_w).to(torch.int64).clamp(0, tx - 1)
    ty0 = (ymin / tile_h).to(torch.int64).clamp(0, ty - 1)
    ty1 = (ymax / tile_h).to(torch.int64).clamp(0, ty - 1)
    wx, wy = tx1 - tx0 + 1, ty1 - ty0 + 1
    big = ok & (wx * wy > max_tiles)
    binned = ok & ~big
    m = torch.arange(max_tiles, device=dev)
    pair_ok = binned[:, None] & (m[None] < (wx * wy)[:, None])
    tile = (ty0[:, None] + m[None] // wx[:, None]) * tx \
        + tx0[:, None] + m[None] % wx[:, None]
    zc = tris["z"].sum(-1) / 3.0
    bucket = ((zc * 0.5 + 0.5) * 255.0).to(torch.int64).clamp(0, 255)
    classed = trans_budget is not None
    if classed:
        base = tile * 2 + (cls >= 2).to(torch.int64)[:, None]
        sentinel = (nt * 2) << 8
    else:
        base, sentinel = tile, nt << 8
    key = torch.where(pair_ok, (base << 8) | bucket[:, None],
                      sentinel).reshape(-1)
    tri_of = torch.arange(t, device=dev)[:, None].expand(t, max_tiles)
    key, order = torch.sort(key, stable=True)
    tri_of = tri_of.reshape(-1)[order]
    if pair_budget is not None and pair_budget < key.shape[0]:
        key, tri_of = key[:pair_budget], tri_of[:pair_budget]
    live = key < sentinel
    key, tri_of = key[live], tri_of[live]
    run = key >> 8
    pos = torch.arange(run.shape[0], device=dev)
    new = torch.ones_like(run, dtype=torch.bool)
    new[1:] = run[1:] != run[:-1]
    start = torch.cummax(torch.where(new, pos, 0), 0).values
    rank = pos - start
    if classed:
        is_t = (run & 1) == 1
        t_of = run >> 1
        keep = rank < torch.where(is_t, trans_budget, budget)
        slot = torch.where(is_t, budget + rank, rank)
    else:
        t_of, keep, slot = run, rank < budget, rank
    first = budget + (trans_budget or 0)
    g = torch.nonzero(big).flatten()[:global_budget]
    # the global list is tested by every tile; tiles its box misses cannot
    # hold a pixel inside it and are skipped
    gx0, gx1, gy0, gy1 = tx0[g], tx1[g], ty0[g], ty1[g]
    tiles = torch.arange(nt, device=dev)
    tcol, trow = tiles % tx, tiles // tx
    hit = ((tcol[:, None] >= gx0[None]) & (tcol[:, None] <= gx1[None])
           & (trow[:, None] >= gy0[None]) & (trow[:, None] <= gy1[None]))
    gt, gk = torch.nonzero(hit, as_tuple=True)
    return (torch.cat([t_of[keep], gt]),
            torch.cat([slot[keep], first + gk]),
            torch.cat([tri_of[keep], g[gk]]))


# ---- raster --------------------------------------------------------------
def _ordered(d):
    """float32 -> int64 keys in the same order (for a min with ties)."""
    b = d.view(torch.int32).to(torch.int64)
    return torch.where(b < 0, -(b & 0x7FFFFFFF) - 1, b)


def raster(tris, cls, cand, width, height, layers=(1,), tile_h=8,
           tile_w=128):
    """Per layer of ``layers`` (1 opaque, 2 transparent; 1 alone takes
    every class), the (H, W) depth (1 where empty) and winning triangle
    (-1 where empty)."""
    dev = cls.device
    tx, ty = -(-width // tile_w), -(-height // tile_h)
    nt = tx * ty
    npx = tile_h * tile_w
    ct, ck, ctri = cand
    x, y, z = tris["xy"][..., 0], tris["xy"][..., 1], tris["z"]
    iy = torch.arange(tile_h, device=dev, dtype=torch.float32)[:, None]
    ix = torch.arange(tile_w, device=dev, dtype=torch.float32)[None, :]
    big = torch.iinfo(torch.int64).max
    best = {c: torch.full((nt * npx,), big, dtype=torch.int64, device=dev)
            for c in layers}
    one_layer = layers == (1,)
    for i in range(0, ct.shape[0], CHUNK):
        tt, kk, tr = ct[i:i + CHUNK], ck[i:i + CHUNK], ctri[i:i + CHUNK]
        py = ((tt // tx) * tile_h).to(torch.float32)[:, None, None] + iy + 0.5
        px = ((tt % tx) * tile_w).to(torch.float32)[:, None, None] + ix + 0.5
        x0, x1, x2 = (x[tr, j][:, None, None] for j in range(3))
        y0, y1, y2 = (y[tr, j][:, None, None] for j in range(3))
        l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
        l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
        l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
        area = l0 + l1 + l2
        nz = area.abs() > 1e-9
        inside = (((l0 >= 0) & (l1 >= 0) & (l2 >= 0))
                  | ((l0 <= 0) & (l1 <= 0) & (l2 <= 0))) & nz
        inv = 1.0 / torch.where(nz, area, 1.0)
        d = (l0 * z[tr, 0][:, None, None] + l1 * z[tr, 1][:, None, None]
             + l2 * z[tr, 2][:, None, None]) * inv
        inside = inside & (d >= -1.0) & (d <= 1.0)
        key = (_ordered(d) << 9) | kk[:, None, None]
        at = (tt[:, None] * npx + torch.arange(npx, device=dev)[None])
        for c in layers:
            mine = (cls[tr] > 0) if one_layer else (cls[tr] == c)
            kc = torch.where(inside & mine[:, None, None], key, big)
            best[c].scatter_reduce_(0, at.reshape(-1), kc.reshape(-1), "amin")
    out = []
    for c in layers:
        b = best[c]
        has = b != big
        k = torch.where(has, b & 0x1FF, 0)
        # the winner's row: look the (tile, slot) pair up
        tile_of = torch.arange(nt * npx, device=dev) // npx
        lut = torch.full((nt, 512), -1, dtype=torch.int64, device=dev)
        lut[ct, ck] = ctri
        win = torch.where(has, lut[tile_of, k], -1)
        bits = b >> 9
        dbits = torch.where(bits < 0, -(bits + 1) | (-(1 << 31)), bits)
        dep = dbits.to(torch.int32).view(torch.float32)
        dep = torch.where(has, dep, torch.ones_like(dep))
        out.append((_untile(dep, tx, ty, tile_h, tile_w, height, width),
                    _untile(win, tx, ty, tile_h, tile_w, height, width)))
    return out


def _untile(a, tx, ty, th, tw, h, w):
    a = a.reshape(ty, tx, th, tw).permute(0, 2, 1, 3)
    return a.reshape(ty * th, tx * tw)[:h, :w]


def _tile(a, tx, ty, th, tw):
    """(H', W', ...) padded image -> (NT, th, tw, ...)."""
    rest = a.shape[2:]
    a = a.reshape((ty, th, tx, tw) + rest).transpose(1, 2)
    return a.reshape((ty * tx, th, tw) + rest)


# ---- shadow maps ---------------------------------------------------------
def new_shadows(sc):
    st, dev = sc.settings, sc.camv.device
    s, r = st.shadow_slots, st.shadow_res
    return {"maps": torch.ones(s, r, r, device=dev),
            "light_mats": torch.eye(4, device=dev).repeat(s, 1, 1),
            "slot_entity": torch.full((s,), -1, dtype=torch.int64,
                                      device=dev),
            "slot_face": torch.zeros(s, dtype=torch.int64, device=dev),
            "cursor": 0, "tick": 0}


def update_shadows(sh, w, sc, eye):
    """The frame's shadow-map update: every ``interval``-th frame the
    round-robin picks a slot and its light (a nearby light without a map
    first, into the first free slot; slots whose light has gone are
    freed) and renders the light's view of the casters into it."""
    st = sc.settings
    tick = sh["tick"]
    sh = dict(sh, tick=tick + 1)
    if tick % st.shadow_interval:
        return sh
    cap = w["alive"].shape[0]
    srt = w["comps.sortable"]
    near = ((w["comps.position"] - eye[None]) ** 2).sum(-1) <= 800.0 ** 2
    cand = w["alive"] & (srt != 0) & near
    ents = sh["slot_entity"].clone()
    owned = torch.zeros(cap, dtype=torch.int64, device=ents.device)
    for e in ents.tolist():
        if e >= 0:
            owned[e] += 1
    needed = torch.where(srt == 2, 6, 1)
    unmapped = cand & (owned < needed)
    for s_, e in enumerate(ents.tolist()):
        if not (e >= 0 and bool(cand[min(max(e, 0), cap - 1)])):
            ents[s_] = -1
    free = torch.nonzero(ents < 0).flatten()
    rr = sh["cursor"] % ents.shape[0]
    sh = dict(sh, cursor=sh["cursor"] + 1, slot_entity=ents)
    if bool(unmapped.any()) and len(free):
        slot, light = int(free[0]), int(torch.nonzero(unmapped)[0])
        face = int(owned[light])
    elif int(ents[rr]) >= 0:
        slot, light, face = rr, int(ents[rr]), int(sh["slot_face"][rr])
    else:
        return sh
    if int(srt[light]) != D.SORTABLE_SPOT:
        raise NotImplementedError("the demo's lights are spot lights")
    pv = X.spot_proj_view(w["comps.position"][light],
                          w["comps.light_direction"][light],
                          w["comps.light_cutoff"][light][1],
                          w["comps.light_fov"][light],
                          w["comps.light_radius"][light])
    res = st.shadow_res
    tris = to_screen(triangles(w, sc, pv, eye, st.shadow_max_tris,
                               lov_bias=st.shadow_lov_bias, depth_only=True),
                     res, res)
    cls = tris["valid"].to(torch.int64)
    cand = bins(tris, cls, res, res, st.shadow_tile_budget_tiles, None,
                st.shadow_global_budget, 4 * st.shadow_max_tris)
    depth, _ = raster(tris, cls, cand, res, res)[0]
    sh = {k: (v.clone() if torch.is_tensor(v) else v) for k, v in sh.items()}
    sh["maps"][slot] = depth
    sh["light_mats"][slot] = pv
    sh["slot_entity"][slot] = light
    sh["slot_face"][slot] = face
    return sh


def pcf(sh, slot, cx, cy, cz, cw):
    """The 3x3 percentage-closer factor of slot ``slot`` at light clip
    coordinates; 1 outside the light's view."""
    res = sh["maps"].shape[-1]
    inv = 1.0 / torch.where(cw.abs() > 1e-9, cw, 1.0)
    nx, ny, z = cx * inv, cy * inv, cz * inv
    u = (nx * 0.5 + 0.5) * res - 0.5
    v = (0.5 - ny * 0.5) * res - 0.5
    inside = (nx.abs() <= 1.0) & (ny.abs() <= 1.0) & (z <= 1.0) & (cw > 0.0)
    ui = torch.round(u).to(torch.int64).clamp(0, res - 1)
    vi = torch.round(v).to(torch.int64).clamp(0, res - 1)
    m = sh["maps"][slot]
    lit = torch.zeros_like(z)
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            tap = m[(vi + dy).clamp(0, res - 1), (ui + dx).clamp(0, res - 1)]
            lit = lit + ((z - PCF_BIAS) <= tap).to(torch.float32)
    return torch.where(inside, lit / 9.0, torch.ones_like(lit))


# ---- shading -------------------------------------------------------------
def spot_lights(w, max_spot):
    ids = torch.nonzero(w["alive"] & (w["comps.sortable"] == D.SORTABLE_SPOT)
                        ).flatten()[:max_spot]
    return ids


def sample(atlas, tex, uv):
    """Bilinear samples of texture ids ``tex`` (-1: none) at ``uv``
    (wrapped) within each texture's rectangle of its layer."""
    s = atlas["layers"].shape[1]
    t = tex.clamp(0, atlas["tex_layer"].shape[0] - 1)
    lay = atlas["tex_layer"][t]
    r = atlas["rect"][t]
    u = r[..., 2] + torch.remainder(uv[..., 0], 1.0) * r[..., 0]
    v = r[..., 3] + (1.0 - torch.remainder(uv[..., 1], 1.0)) * r[..., 1]
    u0 = torch.floor(u).clamp(0, s - 1)
    v0 = torch.floor(v).clamp(0, s - 1)
    fu, fv = (u - u0)[..., None], (v - v0)[..., None]
    u0, v0 = u0.to(torch.int64), v0.to(torch.int64)
    u1, v1 = (u0 + 1).clamp(max=s - 1), (v0 + 1).clamp(max=s - 1)
    L = atlas["layers"]
    return (L[lay, v0, u0] * (1 - fu) * (1 - fv) + L[lay, v0, u1] * fu * (1 - fv)
            + L[lay, v1, u0] * (1 - fu) * fv + L[lay, v1, u1] * fu * fv)


def tangents(tris):
    p, uv = tris["pos"], tris["uv"]
    e1, e2 = p[:, 1] - p[:, 0], p[:, 2] - p[:, 0]
    du1, dv1 = uv[:, 1, 0] - uv[:, 0, 0], uv[:, 1, 1] - uv[:, 0, 1]
    du2, dv2 = uv[:, 2, 0] - uv[:, 0, 0], uv[:, 2, 1] - uv[:, 0, 1]
    det = du1 * dv2 - du2 * dv1
    ok = det.abs() > 1e-12
    r = torch.where(ok, 1.0 / torch.where(ok, det, 1.0), 0.0)
    tan = (e1 * dv2[:, None] - e2 * dv1[:, None]) * r[:, None]
    bit = (e2 * du1[:, None] - e1 * du2[:, None]) * r[:, None]
    hand = torch.where((X.cross(X.cross(e1, e2), tan) * bit).sum(-1) < 0.0,
                       -1.0, 1.0)
    return tan, hand


def perturb(n, tan, hand, smp):
    t = tan - n * (n * tan).sum(-1, keepdim=True)
    tl = X.norm(t, keepdim=True)
    ok = tl[..., 0] > 1e-8
    t = t / torch.where(tl > 1e-8, tl, 1.0)
    b = X.cross(n, t) * hand[..., None]
    m = smp * 2.0 - 1.0
    p = m[..., 0:1] * t + m[..., 1:2] * b + m[..., 2:3] * n
    pl = X.norm(p, keepdim=True)
    p = p / torch.where(pl > 1e-12, pl, 1.0)
    return torch.where(ok[..., None], p, n)


def frame_image(w, camv, sh, sc):
    """The frame's (H, W, 3) image from the world, the camera vector and
    the shadow state after this frame's update."""
    st, bank, cam, dev = sc.settings, sc.bank, sc.cam, camv.device
    W, H, th, tw = st.width, st.height, st.tile_h, st.tile_w
    tx, ty = -(-W // tw), -(-H // th)
    pv = X.proj_view(camv, cam)
    tris = to_screen(triangles(w, sc, pv, camv[0:3], st.max_tris), W, H)
    cls = torch.where(tris["valid"],
                      torch.where(tris["transparent"], 2, 1), 0)
    cand = bins(tris, cls, W, H, st.tile_budget, st.trans_budget,
                st.global_budget, st.pair_budget)
    (d_o, w_o), (d_t, w_t) = raster(tris, cls, cand, W, H, layers=(1, 2))
    ipv = torch.linalg.inv(pv)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None] + 0.5
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :] + 0.5
    ndc_x = (xx / float(W) * 2.0 - 1.0).expand(H, W)
    ndc_y = (1.0 - yy / float(H) * 2.0).expand(H, W)
    lights = spot_lights(w, st.max_spot)
    mat_unlit = bank["unlit"]
    ent_model = w["comps.model_id"]
    tan, hand = tangents(tris)
    # the texture budget of the fused route: tiles holding any textured
    # candidate come first, up to the budget
    textured_tile = None
    ntiles = tx * ty
    if st.fused:
        tex_tri = (bank["texture"][tris["mat"]] >= 0) | (
            bank["normal_map"][tris["mat"]] >= 0)
        has_tex = torch.zeros(ntiles, dtype=torch.bool, device=dev)
        ct, _, ctri = cand
        has_tex[ct[tex_tri[ctri]]] = True
        tb = max(1, int(round(ntiles * st.texture_tile_budget)))
        order = torch.argsort((~has_tex).to(torch.int64), stable=True)
        textured_tile = torch.zeros(ntiles, dtype=torch.bool, device=dev)
        textured_tile[order[:tb]] = True
    factors = shadow_factors(sh, d_o, w_o, ipv, ndc_x, ndc_y, sc) \
        if st.shadows else None

    def shade(win, dep, shadows, textured):
        cov = win >= 0
        tri = win.clamp(min=0)
        x, y = tris["xy"][tri, :, 0], tris["xy"][tri, :, 1]
        l0 = (x[..., 2] - x[..., 1]) * (yy - y[..., 1]) \
            - (y[..., 2] - y[..., 1]) * (xx - x[..., 1])
        l1 = (x[..., 0] - x[..., 2]) * (yy - y[..., 2]) \
            - (y[..., 0] - y[..., 2]) * (xx - x[..., 2])
        l2 = (x[..., 1] - x[..., 0]) * (yy - y[..., 0]) \
            - (y[..., 1] - y[..., 0]) * (xx - x[..., 0])
        area = l0 + l1 + l2
        ia = 1.0 / torch.where(area.abs() > 1e-12, area, 1.0)
        iw = tris["inv_w"][tri]
        w0, w1, w2 = l0 * ia * iw[..., 0], l1 * ia * iw[..., 1], \
            l2 * ia * iw[..., 2]
        den = w0 + w1 + w2
        idn = 1.0 / torch.where(den.abs() > 1e-12, den, 1.0)
        p0, p1, p2 = w0 * idn, w1 * idn, w2 * idn
        nv = tris["nrm"][tri]
        n = (p0[..., None] * nv[..., 0, :] + p1[..., None] * nv[..., 1, :]
             + p2[..., None] * nv[..., 2, :])
        nl = X.norm(n, keepdim=True)
        n = n / torch.where(nl > 1e-12, nl, 1.0)
        uvv = tris["uv"][tri]
        uv = (p0[..., None] * uvv[..., 0, :] + p1[..., None] * uvv[..., 1, :]
              + p2[..., None] * uvv[..., 2, :])
        mat = tris["mat"][tri]
        albedo = bank["albedo"][mat]
        unlit = mat_unlit[ent_model[tris["ent"][tri]].clamp(min=0)]
        emis = torch.where(unlit, bank["emissive"][mat].clamp(min=1.0)
                           * D.EMISSIVE_BOOST, bank["emissive"][mat])
        alpha = bank["alpha"][mat].clamp(0.0, 1.0)
        spec_k = bank["specular"][mat]
        if textured is not None:
            tex = bank["texture"][mat]
            nmap = bank["normal_map"][mat]
            use = textured
            albedo = torch.where(((tex >= 0) & use)[..., None],
                                 sample(sc.atlas, tex, uv), albedo)
            pert = perturb(n, tan[tri], hand[tri], sample(sc.atlas, nmap, uv))
            n = torch.where(((nmap >= 0) & use)[..., None], pert, n)
        # the position from the depth
        ndc = torch.stack([ndc_x, ndc_y, dep, torch.ones_like(dep)], -1)
        wp = torch.einsum("ij,hwj->hwi", ipv, ndc)
        pos = wp[..., :3] / torch.where(wp[..., 3:].abs() > 1e-12,
                                        wp[..., 3:], 1.0)
        v = camv[0:3] - pos
        v = v / X.norm(v, keepdim=True).clamp(min=1e-12)
        color = torch.zeros_like(pos)
        for li in lights.tolist():
            lp = w["comps.position"][li]
            sd = w["comps.light_direction"][li]
            sd = sd / torch.where(X.norm(sd) > 1e-9, X.norm(sd), 1.0)
            tv = lp - pos
            d2 = (tv * tv).sum(-1, keepdim=True)
            dist = torch.sqrt(d2.clamp(min=1e-18))
            ld = tv / dist
            at = w["comps.light_atten"][li]
            atten = 1.0 / (1.0 + at[0] * dist + at[1] * d2)
            cut = w["comps.light_cutoff"][li]
            cos_t = -(ld * sd).sum(-1, keepdim=True)
            eps = torch.clamp(cut[0] - cut[1], min=1e-6)
            inten = ((cos_t - cut[1]) / eps).clamp(0.0, 1.0)
            ndl = (n * ld).sum(-1, keepdim=True).clamp(min=0.0)
            h = ld + v
            h = h / X.norm(h, keepdim=True).clamp(min=1e-12)
            ndh = (n * h).sum(-1, keepdim=True).clamp(min=0.0)
            spec = torch.where(ndl > 0.0, ndh ** SHININESS, 0.0) \
                * spec_k[..., None]
            s = atten * inten
            if shadows and factors is not None:
                for slot, ent in enumerate(sh["slot_entity"].tolist()):
                    if ent == li:
                        s = s * factors[slot][..., None]
            color = color + s * (w["comps.light_ambient"][li] * albedo
                                 + w["comps.light_diffuse"][li] * ndl * albedo
                                 + w["comps.light_specular"][li] * spec)
        color = torch.maximum(color, DIFFUSE_FLOOR * albedo)
        color = torch.where((emis > 0.0)[..., None], albedo * emis[..., None],
                            color)
        return torch.where(cov[..., None], color, 0.0), alpha, cov

    if st.fused:
        tex_px = _untile_bool(textured_tile, tx, ty, th, tw, H, W)
    else:
        tex_px = torch.ones(H, W, dtype=torch.bool, device=dev)
    c_o, _, cov_o = shade(w_o, d_o, True, tex_px)
    c_t, a_t, cov_t = shade(w_t, d_t, False,
                            None if st.fused else tex_px)
    bg = starfield(camv, sc)
    base = torch.where(cov_o[..., None], c_o, bg)
    front = (cov_t & (d_t <= d_o))[..., None]
    a = torch.where(cov_t, a_t, 1.0)[..., None]
    return torch.where(front, a * c_t + (1.0 - a) * base, base).clamp(0.0, 1.0)


def _untile_bool(per_tile, tx, ty, th, tw, h, w):
    a = per_tile.reshape(ty, 1, tx, 1).expand(ty, th, tx, tw)
    return a.reshape(ty * th, tx * tw)[:h, :w]


def shadow_factors(sh, d_o, w_o, ipv, ndc_x, ndc_y, sc):
    """(slots, H, W) shadow factors of the opaque layer: each mapped
    slot's factor at a source pixel, every third pixel in both directions,
    repeated over the pixels after it; where the route has a budget of
    tiles, tiles beyond it are lit."""
    st, dev = sc.settings, d_o.device
    H, W, th, tw, k = st.height, st.width, st.tile_h, st.tile_w, st.pcf_scale
    tx, ty = -(-W // tw), -(-H // th)
    nt = tx * ty
    hp, wp_ = ty * th, tx * tw
    # pixel coordinates of the padded image
    gy = torch.arange(hp, device=dev)[:, None].expand(hp, wp_)
    gx = torch.arange(wp_, device=dev)[None, :].expand(hp, wp_)
    tile = (gy // th) * tx + gx // tw
    ry, rx = gy % th, gx % tw
    if st.fused:
        # the fused route samples within each tile
        sy = (gy // th) * th + (ry // k) * k
        sx = (gx // tw) * tw + (rx // k) * k
    else:
        # the default route samples its tiles stacked into one tall image
        # (tile after tile, each 8 rows of 128): every third row of that
        # image, every third column of a tile
        tall = tile * th + ry
        src = (tall // k) * k
        st_tile, st_row = src // th, src % th
        sy = (st_tile // tx) * th + st_row
        sx = (st_tile % tx) * tw + (rx // k) * k
    dpad = torch.ones(hp, wp_, device=dev)
    dpad[:H, :W] = d_o
    ds = dpad[sy, sx]
    nxs = (sx.to(torch.float32) + 0.5) / float(W) * 2.0 - 1.0
    nys = 1.0 - (sy.to(torch.float32) + 0.5) / float(H) * 2.0
    out = []
    cov = torch.zeros(hp, wp_, dtype=torch.bool, device=dev)
    cov[:H, :W] = w_o >= 0
    for slot, ent in enumerate(sh["slot_entity"].tolist()):
        if ent < 0:
            out.append(torch.ones(H, W, device=dev))
            continue
        if st.fused:
            m = torch.matmul(sh["light_mats"][slot], ipv)
            cx = m[0, 0] * nxs + m[0, 1] * nys + m[0, 2] * ds + m[0, 3]
            cy = m[1, 0] * nxs + m[1, 1] * nys + m[1, 2] * ds + m[1, 3]
            cz = m[2, 0] * nxs + m[2, 1] * nys + m[2, 2] * ds + m[2, 3]
            cw = m[3, 0] * nxs + m[3, 1] * nys + m[3, 2] * ds + m[3, 3]
            f = pcf(sh, slot, cx, cy, cz, cw)
            f = torch.where(_budget_tiles(m, dpad, cov, tx, ty, th, tw, W, H,
                                          nt, st.shadow_tile_budget)[tile],
                            f, torch.ones_like(f))
        else:
            ndc = torch.stack([nxs, nys, ds, torch.ones_like(ds)], -1)
            wpos = torch.einsum("ij,hwj->hwi", ipv, ndc)
            wpos = wpos[..., :3] / torch.where(wpos[..., 3:].abs() > 1e-12,
                                               wpos[..., 3:], 1.0)
            # the route's G-buffer holds no position where nothing is drawn
            wpos = torch.where(cov[sy, sx][..., None], wpos, 0.0)
            homo = torch.cat([wpos, torch.ones_like(wpos[..., :1])], -1)
            c = torch.einsum("ij,hwj->hwi", sh["light_mats"][slot], homo)
            f = pcf(sh, slot, c[..., 0], c[..., 1], c[..., 2], c[..., 3])
        out.append(f[:H, :W])
    return out


def _budget_tiles(m, dpad, cov, tx, ty, th, tw, W, H, nt, frac):
    """The fused route's tiles that get a slot's shadow factors: tiles
    with a covered pixel whose rectangle times its covered depth range
    can meet the light's view, the most covered first, up to the budget."""
    dev = dpad.device
    d = _tile(dpad, tx, ty, th, tw)
    c = _tile(cov, tx, ty, th, tw)
    ncov = c.sum((1, 2))
    dmin = torch.where(c, d, 1e9).amin((1, 2))
    dmax = torch.where(c, d, -1e9).amax((1, 2))
    tid = torch.arange(nt, device=dev)
    oy = ((tid // tx) * th).to(torch.float32)
    ox = ((tid % tx) * tw).to(torch.float32)
    x0, x1 = ox / W * 2.0 - 1.0, (ox + tw) / W * 2.0 - 1.0
    y0, y1 = 1.0 - oy / H * 2.0, 1.0 - (oy + th) / H * 2.0
    cx = torch.stack([x0, x1, x0, x1] * 2, 1)
    cy = torch.stack([y0, y0, y1, y1] * 2, 1)
    cz = torch.stack([dmin] * 4 + [dmax] * 4, 1)
    corners = torch.stack([cx, cy, cz, torch.ones_like(cx)], -1)
    cl = torch.einsum("tcj,ij->tci", corners, m)
    xs, ys, zs, ws = cl.unbind(-1)
    culled = ((xs + ws < 0).all(1) | (xs - ws > 0).all(1)
              | (ys + ws < 0).all(1) | (ys - ws > 0).all(1)
              | (zs - ws > 0).all(1) | (ws <= 0).all(1))
    need = ~culled & (ncov > 0)
    tb = max(1, int(round(nt * frac)))
    key = torch.where(need, ncov, -1)
    sel = torch.argsort(-key, stable=True)[:tb]
    out = torch.zeros(nt, dtype=torch.bool, device=dev)
    out[sel] = need[sel]
    return out


def starfield(camv, sc):
    """Deep-space blue with each star a 2x2 splat (full at its pixel,
    0.45 on the three after it), brighter stars winning."""
    st, dev = sc.settings, camv.device
    H, W = st.height, st.width
    fwd = X.direction(camv[3], camv[4])
    up0 = torch.tensor([0.0, 1.0, 0.0], device=dev)
    right = X.cross(fwd, up0)
    right = right / X.norm(right)
    up = X.cross(right, fwd)
    dirs = sc.stars["dirs"]
    dx = torch.matmul(dirs, right)
    dy = torch.matmul(dirs, up)
    dz = torch.matmul(dirs, fwd)
    t = torch.tan(0.5 * torch.tensor(sc.cam["fov_y"], dtype=torch.float32,
                                     device=dev))
    safe = torch.where(dz > 1e-6, dz, 1.0)
    nx = dx / (safe * t * sc.cam["aspect"])
    ny = dy / (safe * t)
    px = ((nx * 0.5 + 0.5) * W).to(torch.int64)
    py = ((0.5 - ny * 0.5) * H).to(torch.int64)
    ok = (dz > 1e-6) & (px >= 0) & (px < W - 1) & (py >= 0) & (py < H - 1)
    bg = torch.tensor(SPACE_BASE, device=dev).expand(H, W, 3).clone()
    flat = bg.reshape(-1, 3)
    col = sc.stars["colors"][ok]
    for oy in (0, 1):
        for ox in (0, 1):
            wgt = 1.0 if (ox == 0 and oy == 0) else 0.45
            at = (py[ok] + oy) * W + px[ok] + ox
            flat.scatter_reduce_(0, at[:, None].expand(-1, 3), col * wgt,
                                 "amax")
    return flat.reshape(H, W, 3)
