"""Fused per-tile shading (kernel K3): resolve + interpolation + Blinn-Phong.

Port of ``render_engine_tpu/render/shade_pallas.py`` (the module keeps the
JAX package's name so the two line up). On the GPU ``fused_shade``
launches ``csrc/fused_shade.cu`` through ``shade_tiles``; for CPU tensors
it runs the plain PyTorch version below, which follows the Pallas kernel
step for step over (NT, th, tw) tensors and loops over lights like its
``fori_loop``.

Per tile and layer (opaque, then transparent) the kernel resolves each
pixel's winner row, interpolates perspective-correct attributes (rsqrt-
normalized normal, channel-34 spec/Ns decode), applies the texture /
spec / emissive / dissolve / normal-map overrides, unprojects depth through
the inverse proj-view (+ ``pixel_origin``), runs Blinn-Phong over the live
lights or the tile's culled list, multiplies per-slot PCF factors on the
opaque layer, and applies the diffuse floor, emissive bypass and coverage.
Output (8, NT, th, tw) = [lit rgb | t_lit rgb | alpha | flags], flags
bit0 = opaque covered, bit1 = transparent in front.

Packed light-table row (N_LCOL f32 columns): 0 kind (0 dir, 1 point,
2 spot) | 1:4 position | 4:7 direction (normalized) | 7:10 diffuse |
10:13 specular | 13:16 ambient | 16:18 attenuation | 18:20 cutoff cos |
20 radius (<= 0 unbounded) | 21:21+S shadow-slot ownership.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.render.lighting import (DIFFUSE_FLOOR,
                                                     SHININESS, LightArrays)
from render_engine_tpu_torch.utils import consts

N_LCOL = 28
MAX_TILE_PIXELS = 1024  # the largest tile K3 takes
MAX_LTAB_BYTES = 48 * 1024  # K3 stages the light rows in shared memory
BLOCK_PIXELS = 256  # K3: a block owns 256 consecutive pixels of a tile
BLOCK_THREADS = 128  # two pixels a thread in pass A, one item in pass B


def pack_lights(lights: LightArrays, budget: int, slot_entity=None):
    """(budget, N_LCOL) f32 table with the live rows compacted to the
    prefix (dir, point, spot order kept) and the live count (int32)."""
    rows, valid_parts = [], []
    dev = lights.dir_direction.device

    def seg(kind, pos, direction, dif, spe, amb, att, cut, radius, count,
            entity):
        n = pos.shape[0]
        if n == 0:
            return
        k = torch.full((n, 1), float(kind), device=dev)
        if slot_entity is not None:
            own = ((entity[:, None] == slot_entity[None, :])
                   & (entity[:, None] >= 0)).to(torch.float32)
        else:
            own = torch.zeros((n, 0), device=dev)
        rows.append(torch.cat(
            [k, pos, direction, dif, spe, amb, att, cut,
             radius.reshape(n, 1).to(torch.float32), own,
             torch.zeros((n, N_LCOL - 21 - own.shape[1]), device=dev)],
            dim=1))
        valid_parts.append(torch.arange(n, device=dev) < count)

    def unit(v):
        n = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
        return v / torch.where(n > 1e-9, n, torch.ones_like(n))

    nd = lights.dir_direction.shape[0]
    z3 = lambda n: torch.zeros((n, 3), device=dev)  # noqa: E731
    z2 = lambda n: torch.zeros((n, 2), device=dev)  # noqa: E731
    seg(0, z3(nd), unit(lights.dir_direction), lights.dir_diffuse,
        lights.dir_specular, lights.dir_ambient, z2(nd), z2(nd),
        torch.zeros(nd, device=dev), lights.dir_count, lights.dir_entity)
    npt = lights.pt_position.shape[0]
    seg(1, lights.pt_position, z3(npt), lights.pt_diffuse,
        lights.pt_specular, lights.pt_ambient, lights.pt_atten, z2(npt),
        lights.pt_radius, lights.pt_count, lights.pt_entity)
    ns = lights.sp_position.shape[0]
    seg(2, lights.sp_position, unit(lights.sp_direction), lights.sp_diffuse,
        lights.sp_specular, lights.sp_ambient, lights.sp_atten,
        lights.sp_cutoff, torch.zeros(ns, device=dev), lights.sp_count,
        lights.sp_entity)
    table = torch.cat(rows) if rows else torch.zeros((0, N_LCOL),
                                                     device=dev)
    valid = torch.cat(valid_parts) if valid_parts else torch.zeros(
        0, dtype=torch.bool, device=dev)
    total = table.shape[0]
    if total > budget:
        raise ValueError(f"light table has {total} rows but the fused-shade "
                         f"budget is {budget}")
    if total:
        order = torch.argsort((~valid).to(torch.int32), stable=True)
        table = torch.where(valid[order][:, None], table[order],
                            torch.zeros_like(table))
    if total < budget:
        table = torch.cat([table, torch.zeros((budget - total, N_LCOL),
                                              device=dev)])
    return table.contiguous(), valid.sum(dtype=torch.int32)


@consts.cached(maxsize=8)
def _tile_corner_ndc(tiles_x, tiles_y, tile_h, tile_w, width, h_total, y_off,
                     device):
    """(tiles_y + 1, tiles_x + 1, 4) camera-NDC points [x, y, 0.5, 1] of the
    tile boundary grid, computed on the host: numpy rounds each division
    like the JAX package (CUDA multiplies by a host scalar's reciprocal
    instead)."""
    f32 = np.float32
    cx = np.arange(tiles_x + 1, dtype=f32) * f32(tile_w)
    cy = np.arange(tiles_y + 1, dtype=f32) * f32(tile_h) + f32(y_off)
    ndc_x = cx / f32(width) * f32(2.0) - f32(1.0)
    ndc_y = f32(1.0) - cy / f32(h_total) * f32(2.0)
    shape = (tiles_y + 1, tiles_x + 1)
    return torch.tensor(np.stack(
        [np.broadcast_to(ndc_x[None, :], shape),
         np.broadcast_to(ndc_y[:, None], shape),
         np.full(shape, 0.5, f32), np.ones(shape, f32)], axis=-1),
        device=device)


def select_tile_lights(ltab, n_live, camera_position, inv_pv, tiles_x,
                       tiles_y, tile_h, tile_w, width, h_total, y_off,
                       budget: int):
    """Per-tile light lists: each tile culls the packed light table against
    its view pyramid (four side planes and the behind-camera plane, with
    each light's influence sphere; no depth dependence, so the drop
    counters reproduce the exact counts). K3's light loop then runs over
    ``tlist[t, :tcount[t]]`` instead of every live light.

    A culled light contributes exactly 0 in the full loop (its radius
    cutoff zeroes the attenuation) and ``tlist`` keeps ascending table
    order, so shading through the lists is bit-identical to the full loop
    as long as no tile overflows ``budget``. Directional lights and lights
    with radius <= 0 (unbounded; spot rows pack radius 0) are in every
    list. Returns (tlist int32 (NT, min(budget, L)), tcount int32 (NT,),
    dropped int32 scalar)."""
    nt = tiles_x * tiles_y
    ll = ltab.shape[0]
    dev = ltab.device
    cam = consts.on_device(camera_position, device=dev).reshape(3)

    # world rays through the tile boundary grid, from the camera
    ndc = _tile_corner_ndc(tiles_x, tiles_y, tile_h, tile_w, width, h_total,
                           float(y_off), dev)
    wp = ndc @ inv_pv.T
    w = wp[..., 3:4]
    rays = wp[..., :3] / torch.where(w.abs() > 1e-12, w,
                                     torch.ones_like(w)) - cam
    tl, tr = rays[:-1, :-1], rays[:-1, 1:]  # (Ty, Tx, 3)
    bl, br = rays[1:, :-1], rays[1:, 1:]
    cross = functools.partial(torch.linalg.cross, dim=-1)
    planes = torch.stack([cross(tl, bl), cross(br, tr), cross(tr, tl),
                          cross(bl, br)], dim=2)  # left right top bottom
    center = tl + tr + bl + br  # un-normalized center ray
    # every normal points inward (positive toward the tile's own rays)
    sign = torch.sign((planes * center[:, :, None, :]).sum(dim=-1))
    sign = torch.where(sign == 0.0, torch.ones_like(sign), sign)
    planes = planes * sign[..., None]
    planes = planes / torch.linalg.vector_norm(
        planes, dim=-1, keepdim=True).clamp(min=1e-12)
    fwd = center / torch.linalg.vector_norm(
        center, dim=-1, keepdim=True).clamp(min=1e-12)
    planes = torch.cat([planes, fwd[:, :, None, :]], dim=2).reshape(nt, 5, 3)

    kind = ltab[:, 0]
    lpos = ltab[:, 1:4] - cam[None, :]  # (L, 3) offsets from the camera
    radius = ltab[:, 20]
    live = torch.arange(ll, device=dev) < n_live
    always = live & ((kind < 0.5) | (radius <= 0.0))
    # the plane distances, term by term in float32 (no library product:
    # its summation order and a TF32 mode would move boundary lights)
    p, q = planes[:, :, None, :], lpos[None, None, :, :]
    d = (p[..., 0] * q[..., 0] + p[..., 1] * q[..., 1]) \
        + p[..., 2] * q[..., 2]  # (NT, 5, L)
    in_pyramid = (d >= -radius[None, None, :]).all(dim=1)
    mask = (always[None, :] | in_pyramid) & live[None, :]

    idx = torch.arange(ll, dtype=torch.int32, device=dev)
    key = torch.where(mask, idx[None, :], ll)
    tlist = torch.sort(key, dim=1).values[:, :budget]
    tlist = torch.where(tlist < ll, tlist, 0).to(torch.int32)
    counts = mask.sum(dim=1, dtype=torch.int32)
    dropped = (counts - budget).clamp(min=0).sum(dtype=torch.int32)
    return tlist.contiguous(), counts.clamp(max=budget), dropped


def _interp(ch, px, py, spec_packed=False):
    """Winner attributes from channel planes ``ch(c)`` -> (normal xyz,
    albedo rgb, emissive, alpha, spec, shin or None)."""
    x0, y0, x1, y1, x2, y2 = (ch(i) for i in range(6))
    l0 = (x2 - x1) * (py - y1) - (y2 - y1) * (px - x1)
    l1 = (x0 - x2) * (py - y2) - (y0 - y2) * (px - x2)
    l2 = (x1 - x0) * (py - y0) - (y1 - y0) * (px - x0)
    area = l0 + l1 + l2
    one = torch.ones_like(area)
    inv_area = 1.0 / torch.where(area.abs() > 1e-12, area, one)
    w0 = l0 * inv_area * ch(25)
    w1 = l1 * inv_area * ch(26)
    w2 = l2 * inv_area * ch(27)
    denom = w0 + w1 + w2
    inv_d = 1.0 / torch.where(denom.abs() > 1e-12, denom, one)
    p0, p1, p2 = w0 * inv_d, w1 * inv_d, w2 * inv_d
    nx = p0 * ch(10) + p1 * ch(13) + p2 * ch(16)
    ny = p0 * ch(11) + p1 * ch(14) + p2 * ch(17)
    nz = p0 * ch(12) + p1 * ch(15) + p2 * ch(18)
    nl = torch.rsqrt(torch.clamp(nx * nx + ny * ny + nz * nz, min=1e-24))
    c34 = ch(34)
    if spec_packed:
        hq = torch.floor(c34 * (1.0 / 4096.0))
        spec, shin = (c34 - hq * 4096.0) * (1.0 / 1024.0), hq
    else:
        spec, shin = c34, None
    return ((nx * nl, ny * nl, nz * nl), (ch(29), ch(30), ch(31)), ch(32),
            ch(33), spec, shin)


def fused_shade_reference(rows, s_o, s_t, d_o, d_t, ltab, lcount, cam, ipv,
                          org, *, tiles_x, width, height, sf=None, sfi=None,
                          ovr=None, ovr_chans=4, with_norm=False,
                          with_diss=False, tlist=None, tcount=None,
                          spec_packed=False, shin_const=SHININESS):
    """Plain PyTorch K3 over (NT, th, tw) tensors (same arguments as the
    kernel, see ``fused_shade``)."""
    nt, k, a = rows.shape
    th, tw = s_o.shape[1], s_o.shape[2]
    dev = rows.device
    tids = torch.arange(nt, device=dev)
    oy = (torch.div(tids, tiles_x, rounding_mode="floor") * th).to(
        torch.float32)
    ox = ((tids % tiles_x) * tw).to(torch.float32)
    py = (torch.arange(th, device=dev, dtype=torch.float32)[None, :, None]
          + oy[:, None, None]) + 0.5
    px = (torch.arange(tw, device=dev, dtype=torch.float32)[None, None, :]
          + ox[:, None, None]) + 0.5
    zero = torch.zeros((nt, th, tw), device=dev)
    n_slots = 0 if sf is None else sf.shape[0]
    has_texture = ovr is not None
    use_tile_lights = tlist is not None

    def unproject(depth):
        ndc_x = (px + org[0]) / width * 2.0 - 1.0
        ndc_y = 1.0 - (py + org[1]) / height * 2.0
        c = [ipv[r, 0] * ndc_x + ipv[r, 1] * ndc_y + ipv[r, 2] * depth
             + ipv[r, 3] for r in range(4)]
        inv = 1.0 / torch.where(c[3].abs() > 1e-12, c[3],
                                torch.ones_like(c[3]))
        return c[0] * inv, c[1] * inv, c[2] * inv

    def shade_layer(slot, depth, covered, use_shadows, ovr_base):
        flat = slot.reshape(nt, th * tw).clamp(min=0).long()

        def ch(c):  # one resolved channel plane (K2's gather)
            g = torch.gather(rows[:, :, c], 1, flat).reshape(nt, th, tw)
            return torch.where(covered, g, zero)

        (nx, ny, nz), (ar, ag, ab), emissive, alpha, spec_k, shin = \
            _interp(ch, px, py, spec_packed=spec_packed)
        if shin is None:
            shin = shin_const
        if has_texture:
            base_chans = ovr_chans - (4 if with_norm else 0)
            o = lambda c: ovr[ovr_base + c]  # noqa: E731
            tf = o(3) > 0.5
            ar, ag, ab = (torch.where(tf, o(0), ar), torch.where(tf, o(1), ag),
                          torch.where(tf, o(2), ab))
            if base_chans >= 5:
                spec_k = spec_k * (1.0 + o(4))
            if base_chans >= 6:
                emissive = emissive * (1.0 + o(5))
            if with_diss and base_chans >= 7:
                alpha = alpha * (1.0 + o(6))
            if with_norm:
                nb = base_chans
                nf = o(nb + 3) > 0.5
                nx, ny, nz = (torch.where(nf, o(nb), nx),
                              torch.where(nf, o(nb + 1), ny),
                              torch.where(nf, o(nb + 2), nz))
        wx, wy, wz = unproject(depth)
        vx, vy, vz = cam[0] - wx, cam[1] - wy, cam[2] - wz
        vl = torch.rsqrt(torch.clamp(vx * vx + vy * vy + vz * vz, min=1e-24))
        vx, vy, vz = vx * vl, vy * vl, vz * vl
        cr, cg, cb = zero, zero, zero
        n_iter = (tcount if use_tile_lights else lcount.expand(nt))
        n_loop = (tlist.shape[1] if use_tile_lights else ltab.shape[0])
        for i in range(n_loop):
            run = (i < n_iter)[:, None, None]
            li = tlist[:, i].long() if use_tile_lights else \
                torch.full((nt,), i, dtype=torch.long, device=dev)
            row = ltab[li]  # (NT, N_LCOL)
            L = lambda c: row[:, c][:, None, None]  # noqa: E731
            kind = L(0)
            tx, ty, tz = L(1) - wx, L(2) - wy, L(3) - wz
            d2 = tx * tx + ty * ty + tz * tz
            d = torch.sqrt(torch.clamp(d2, min=1e-18))
            invd = 1.0 / d
            is_dir = kind < 0.5
            lx = torch.where(is_dir, -L(4), tx * invd)
            ly = torch.where(is_dir, -L(5), ty * invd)
            lz = torch.where(is_dir, -L(6), tz * invd)
            atten = torch.where(is_dir, torch.ones_like(d),
                                1.0 / (1.0 + L(16) * d + L(17) * d2))
            radius = L(20)
            atten = torch.where((radius > 0.0) & (d > radius),
                                torch.zeros_like(atten), atten)
            cos_t = -(lx * L(4) + ly * L(5) + lz * L(6))
            inner, outer = L(18), L(19)
            eps = torch.clamp(inner - outer, min=1e-6)
            spot_i = torch.clamp((cos_t - outer) / eps, 0.0, 1.0)
            intensity = torch.where(kind > 1.5, spot_i,
                                    torch.ones_like(spot_i))
            ndl = torch.clamp(nx * lx + ny * ly + nz * lz, min=0.0)
            hx, hy, hz = lx + vx, ly + vy, lz + vz
            hl = torch.rsqrt(torch.clamp(hx * hx + hy * hy + hz * hz,
                                         min=1e-24))
            ndh = torch.clamp((nx * hx + ny * hy + nz * hz) * hl, min=0.0)
            spec = torch.where(ndl > 0.0, torch.pow(ndh, shin),
                               torch.zeros_like(ndh)) * spec_k
            s = atten * intensity
            if use_shadows:
                for sl in range(n_slots):
                    inv_t = sfi[sl]
                    fac = sf[sl][inv_t.clamp(min=0).long()]
                    mapped = (inv_t >= 0).to(torch.float32)[:, None, None]
                    s = s * torch.where(L(21 + sl) * mapped > 0.5, fac,
                                        torch.ones_like(fac))
            cr = torch.where(run, cr + s * (L(13) * ar + L(7) * ndl * ar
                                            + L(10) * spec), cr)
            cg = torch.where(run, cg + s * (L(14) * ag + L(8) * ndl * ag
                                            + L(11) * spec), cg)
            cb = torch.where(run, cb + s * (L(15) * ab + L(9) * ndl * ab
                                            + L(12) * spec), cb)
        cr = torch.maximum(cr, DIFFUSE_FLOOR * ar)
        cg = torch.maximum(cg, DIFFUSE_FLOOR * ag)
        cb = torch.maximum(cb, DIFFUSE_FLOOR * ab)
        emi = emissive > 0.0
        cr = torch.where(emi, ar * emissive, cr)
        cg = torch.where(emi, ag * emissive, cg)
        cb = torch.where(emi, ab * emissive, cb)
        return (torch.where(covered, cr, zero), torch.where(covered, cg, zero),
                torch.where(covered, cb, zero), alpha)

    cov_o, cov_t = s_o >= 0, s_t >= 0
    r_o, g_o, b_o, _ = shade_layer(s_o, d_o, cov_o, n_slots > 0, 0)
    r_t, g_t, b_t, alpha = shade_layer(s_t, d_t, cov_t, False, ovr_chans)
    t_front = cov_t & (d_t <= d_o)
    flags = cov_o.to(torch.float32) + 2.0 * t_front.to(torch.float32)
    return torch.stack([r_o, g_o, b_o, r_t, g_t, b_t,
                        torch.where(cov_t, alpha, torch.ones_like(alpha)),
                        flags])


def shade_work_list(s_o, s_t, d_o, d_t):
    """K3's pass A, plainly (csrc/fused_shade.cu): the flags plane
    (NT, th, tw), bit0 opaque covered and bit1 transparent in front, and
    each tile's work list, (NT, 2 * npx) int32 items, ``p`` for pixel p on
    the opaque layer and ``npx + p`` on the transparent one, opaque items
    first and each layer in pixel order, padded with -1; with the (NT,)
    item counts. The kernel splits a tile's list over blocks
    (``shade_block_items``)."""
    nt, th, tw = s_o.shape
    npx = th * tw
    cov = torch.cat([s_o.reshape(nt, npx) >= 0, s_t.reshape(nt, npx) >= 0],
                    dim=1)
    t_front = (s_t >= 0) & (d_t <= d_o)
    flags = (s_o >= 0).to(torch.float32) + 2.0 * t_front.to(torch.float32)
    order = torch.argsort((~cov).to(torch.int8), dim=1, stable=True)
    n = cov.sum(dim=1, dtype=torch.int32)
    slot = torch.arange(2 * npx, device=s_o.device)[None]
    items = torch.where(slot < n[:, None], order, -1).to(torch.int32)
    return flags, items, n


def shade_block_items(s_o, s_t):
    """K3's split of a tile over blocks, plainly (csrc/fused_shade.cu):
    block b of tile t owns the tile's pixels [b * BLOCK_PIXELS,
    (b + 1) * BLOCK_PIXELS) (two rows of an 8x128 tile) and shades their
    covered items, coded as in ``shade_work_list``, opaque first and each
    layer in pixel order. Returns (NT, NB, 2 * BLOCK_PIXELS) int32 items
    padded with -1 and the (NT, NB) item counts, NB = ceil(th * tw /
    BLOCK_PIXELS)."""
    nt, th, tw = s_o.shape
    npx = th * tw
    nb = -(-npx // BLOCK_PIXELS)
    dev = s_o.device
    pad = torch.zeros((nt, nb * BLOCK_PIXELS - npx), dtype=torch.bool,
                      device=dev)

    def covered(s):
        return torch.cat([s.reshape(nt, npx) >= 0, pad], dim=1).reshape(
            nt, nb, BLOCK_PIXELS)

    cov = torch.cat([covered(s_o), covered(s_t)], dim=2)
    p = torch.arange(nb * BLOCK_PIXELS, device=dev).reshape(nb, BLOCK_PIXELS)
    code = torch.cat([p, p + npx], dim=1).expand(nt, nb, 2 * BLOCK_PIXELS)
    order = torch.argsort((~cov).to(torch.int8), dim=2, stable=True)
    n = cov.sum(dim=2, dtype=torch.int32)
    slot = torch.arange(2 * BLOCK_PIXELS, device=dev)
    items = torch.where(slot < n[..., None], torch.gather(code, 2, order), -1)
    return items.to(torch.int32), n


def staged_light_rows(ltab, lcount, nt, tlist=None, tcount=None):
    """The light rows a block of each tile stages in shared memory, in loop
    order (csrc/fused_shade.cu): on the list route row i of tile t is
    ``ltab[clamp(tlist[t, i], 0, nl - 1)]``, on the dense route ``ltab[i]``,
    for i < n_iter = clamp(tcount[t], 0, lb) or clamp(lcount, 0, nl).
    Returns (NT, lb or nl, N_LCOL) rows, zero past n_iter, and the (NT,)
    int32 n_iter."""
    nl = ltab.shape[0]
    if tlist is None:
        n_iter = lcount.reshape(1).clamp(0, nl).expand(nt)
        idx = torch.arange(nl, device=ltab.device).expand(nt, nl)
    else:
        n_iter = tcount.reshape(nt).clamp(0, tlist.shape[1])
        idx = tlist.long().clamp(0, nl - 1)
    live = torch.arange(idx.shape[1], device=ltab.device) < n_iter[:, None]
    rows = torch.where(live[..., None], ltab[idx], 0.0)
    return rows, n_iter.to(torch.int32)


# K3 passes over a light whose radius cuts an item off where the item's and
# the light's values are bounded (csrc/fused_shade.cu: skip_cut,
# item_bounded): the light's contribution is then exactly +-0
SKIP_POS = 2.0 ** 60  # positions, the spot cone
SKIP_COLOR = 2.0 ** 40  # colours, albedo, spec strength
SKIP_SHIN = 2.0 ** 16  # the specular exponent
SKIP_NORMAL2 = 1.0 + 2.0 ** -11  # the normal's squared length


def shade_skip_cut(ltab):
    """(L,) each light row's cutoff: its radius where the row is bounded
    (position and cone within SKIP_POS, direction within 2, colours within
    SKIP_COLOR), else +inf. K3 skips the light for a bounded item whose
    ``d`` exceeds it."""
    def within(c0, c1, b):
        return (ltab[:, c0:c1].abs() <= b).all(dim=1)

    radius = ltab[:, 20]
    ok = ((radius > 0) & torch.isfinite(radius) & within(1, 4, SKIP_POS)
          & within(4, 7, 2.0) & within(7, 16, SKIP_COLOR)
          & within(18, 20, SKIP_POS))
    return torch.where(ok, radius, torch.full_like(radius, float("inf")))


def shade_skip_item(w, v, n, albedo, spec_k, shin):
    """Whether an item's values allow skips: world position ``w`` within
    SKIP_POS, view vector ``v`` within 2, normal ``n`` of squared length
    within SKIP_NORMAL2, ``albedo`` and ``spec_k`` within SKIP_COLOR, the
    exponent in [0, SKIP_SHIN] (each a tensor, vectors on the last axis;
    the item's PCF factors must be finite too)."""
    n2 = (n[..., 0] * n[..., 0] + n[..., 1] * n[..., 1]) \
        + n[..., 2] * n[..., 2]
    return ((w.abs() <= SKIP_POS).all(-1) & (v.abs() <= 2.0).all(-1)
            & (n2 <= SKIP_NORMAL2) & (albedo.abs() <= SKIP_COLOR).all(-1)
            & (spec_k.abs() <= SKIP_COLOR) & (shin >= 0) & (shin <= SKIP_SHIN))


def fused_shade(rows, s_o, s_t, d_o, d_t, lights: LightArrays,
                camera_position, inv_pv, tiles_x, width, height,
                light_budget: int | None = None, slot_factor_tiles=None,
                slot_factor_inv=None, slot_entity=None,
                pixel_origin=(0.0, 0.0), albedo_override=None,
                tile_lights=None, with_norm=False, with_diss=False,
                spec_packed=False, shin_const=SHININESS):
    """K3 over tiled buffers. rows (NT, K, A) candidate rows; s_o/s_t
    (NT, th, tw) int32 winner slots; d_o/d_t depths. Optional: COMPACT
    per-slot PCF factor tiles (S, TB, th, tw) with their (S, NT) int32
    inverse map and the (S,) slot owner entities; texture overrides
    (2 * ovr_chans, NT, th, tw); per-tile light lists (tlist (NT, LB),
    tcount (NT,)). Returns (8, NT, th, tw)."""
    if light_budget is None:
        light_budget = (lights.dir_direction.shape[0]
                        + lights.pt_position.shape[0]
                        + lights.sp_position.shape[0])
    dev = rows.device
    nt, k, a = rows.shape
    th, tw = s_o.shape[1], s_o.shape[2]
    ltab, n_live = pack_lights(lights, light_budget, slot_entity=slot_entity)
    lcount = n_live.reshape(1)
    cam = consts.on_device(camera_position, device=dev).reshape(
        3).contiguous()
    ipv = inv_pv.to(torch.float32).contiguous()
    org = consts.on_device(pixel_origin, device=dev)
    sf = sfi = None
    if slot_factor_tiles is not None:
        sf, sfi = slot_factor_tiles.contiguous(), slot_factor_inv.contiguous()
        if sf.shape[0] > N_LCOL - 21:
            raise ValueError("shadow budget exceeds the light-table pad")
    has_texture = albedo_override is not None
    ovr_chans = albedo_override.shape[0] // 2 if has_texture else 4
    tlist = tcount = None
    if tile_lights is not None:
        tlist = tile_lights[0].to(torch.int32).contiguous()
        tcount = tile_lights[1].reshape(nt).to(torch.int32).contiguous()
    opts = dict(tiles_x=tiles_x, width=float(width), height=float(height),
                sf=sf, sfi=sfi, ovr=albedo_override, ovr_chans=ovr_chans,
                with_norm=bool(with_norm) and has_texture,
                with_diss=bool(with_diss) and has_texture, tlist=tlist,
                tcount=tcount, spec_packed=bool(spec_packed),
                shin_const=float(shin_const))
    return shade_tiles(rows, s_o, s_t, d_o, d_t, ltab, lcount, cam, ipv, org,
                       **opts)


def blocks_per_sm(n_rows: int) -> int:
    """Blocks of K3 one SM holds at once with room for ``n_rows`` staged
    light rows in shared memory (the list length on the list route, the
    table's rows on the dense route; the CUDA occupancy calculator, on the
    card)."""
    blocks = kernels.library().fused_shade_blocks_per_sm(int(n_rows))
    if blocks < 0:
        raise RuntimeError("fused_shade_blocks_per_sm: CUDA error")
    return blocks


def shade_tiles(rows, s_o, s_t, d_o, d_t, ltab, lcount, cam, ipv, org, *,
                tiles_x, width, height, sf, sfi, ovr, ovr_chans, with_norm,
                with_diss, tlist, tcount, spec_packed, shin_const):
    """K3 on prepared inputs (``fused_shade_reference``'s arguments). CPU
    tensors run the plain version; CUDA tensors launch
    csrc/fused_shade.cu."""
    if rows.device.type == "cpu":
        return fused_shade_reference(
            rows, s_o, s_t, d_o, d_t, ltab, lcount, cam, ipv, org,
            tiles_x=tiles_x, width=width, height=height, sf=sf, sfi=sfi,
            ovr=ovr, ovr_chans=ovr_chans, with_norm=with_norm,
            with_diss=with_diss, tlist=tlist, tcount=tcount,
            spec_packed=spec_packed, shin_const=shin_const)
    nt, k, a = rows.shape
    th, tw = s_o.shape[1], s_o.shape[2]
    dev = rows.device
    if th * tw > MAX_TILE_PIXELS:
        raise ValueError(f"tile of {th}x{tw} exceeds {MAX_TILE_PIXELS} px")
    if a < 35:
        raise ValueError(f"rows carry {a} channels, K3 reads 35")
    f32, i32 = torch.float32, torch.int32
    check = kernels.check
    check(rows, "rows", f32, (nt, k, a), dev)
    for name, t_, dt in (("s_o", s_o, i32), ("s_t", s_t, i32),
                         ("d_o", d_o, f32), ("d_t", d_t, f32)):
        check(t_, name, dt, (nt, th, tw), dev)
    nl = ltab.shape[0]
    check(ltab, "ltab", f32, (nl, N_LCOL), dev)
    check(lcount, "lcount", i32, (1,), dev)
    check(cam, "cam", f32, (3,), dev)
    check(ipv, "ipv", f32, (4, 4), dev)
    check(org, "org", f32, (2,), dev)
    n_slots = tb = 0
    if sf is not None:
        n_slots, tb = sf.shape[0], sf.shape[1]
        check(sf, "slot_factor_tiles", f32, (n_slots, tb, th, tw), dev)
        check(sfi, "slot_factor_inv", i32, (n_slots, nt), dev)
    if ovr is not None:
        check(ovr, "albedo_override", f32, (2 * ovr_chans, nt, th, tw), dev)
    lb = 0
    if tlist is not None:
        lb = tlist.shape[1]
        check(tlist, "tlist", i32, (nt, lb), dev)
        check(tcount, "tcount", i32, (nt,), dev)
        if lb < 1 or lb * N_LCOL * 4 > MAX_LTAB_BYTES:
            raise ValueError(f"light lists of {lb} entries do not fit K3")
    if nl < 1 or nl * N_LCOL * 4 > MAX_LTAB_BYTES:
        raise ValueError(f"light table of {nl} rows does not fit K3")
    out = torch.empty((8, nt, th, tw), dtype=f32, device=dev)
    p = lambda t_: None if t_ is None else kernels.ptr(t_)  # noqa: E731
    kernels.launch(
        "launch_fused_shade", "fused_shade",
        p(rows), p(s_o), p(s_t), p(d_o), p(d_t), p(ltab), p(lcount), p(cam),
        p(ipv), p(org), p(sf), p(sfi), p(ovr), p(tlist), p(tcount), p(out),
        nt, k, a, tiles_x, th, tw, n_slots, tb, lb, nl, width, height,
        ovr_chans, int(with_norm), int(with_diss), int(spec_packed),
        shin_const, DIFFUSE_FLOOR, kernels.stream_ptr(dev))
    if tlist is not None:
        kernels.LAUNCHES["fused_shade_tile_lists"] += 1
    return out
