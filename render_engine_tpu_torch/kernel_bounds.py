"""The least time an NVIDIA H100 could take for each kernel's work.

For a kernel call on given inputs, ``bound_ms`` is the larger of two times:
the bytes the work must move (each input byte it needs read once, each
output byte written once) over the card's memory rate, and the float
operations these inputs need over the card's float32 rate outside the
tensor cores. The rates are NVIDIA's data-sheet peaks for the H100 SXM at
its 700 W limit (3.35 TB/s, 67 TFLOP/s); a card set below 700 W reaches
less. Work that depends on the data is counted for these inputs.

Each ``*_work`` function takes a kernel's captured arguments (the same as
its wrapper's) and returns a dict with ``bytes`` and ``ops`` and the counts
they come from. ``bound`` turns bytes and operations into
``(bound_ms, "bytes" | "operations")``.
"""

from __future__ import annotations

import torch

from render_engine_tpu_torch.render import custom_gbuffer as CG
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render import shade_pallas as SP

H100_BYTES_PER_S = 3.35e12
H100_F32_OPS_PER_S = 67e12

K1_OPS_PER_PAIR = 25  # edge tests, area, depth and compare per pixel
K1_BYTES_PER_CANDIDATE = 44  # 10 f32 scalars and one i32 id
K3_OPS_PER_LIGHT = 60  # Blinn-Phong terms per (pixel, layer, light)
K3_ROW_FLOATS = 35  # channels 0-34 of an attribute row are read


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = ops / H100_F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _max(x):
    return int(x.max()) if x.numel() else 0


def k1_live(counts, k, tile_budget, trans_budget):
    """(NT, K) bool: the candidate slots K1 visits (its clamped trip
    counts over the opaque window, the transparent window and the global
    list)."""
    cnt = counts[:, 0, :].long()
    glob0 = tile_budget + trans_budget
    n0 = cnt[:, 0].clamp(0, tile_budget)[:, None]
    n1 = cnt[:, 1].clamp(0, trans_budget)[:, None]
    n2 = cnt[:, 2].clamp(0, k - glob0)[:, None]
    i = torch.arange(k, device=counts.device)[None]
    return ((i < n0) | ((i >= tile_budget) & (i < tile_budget + n1))
            | ((i >= glob0) & (i < glob0 + n2)))


def tile_raster_work(data, ids, counts, *, tiles_x, tile_h, tile_w,
                     tile_budget, trans_budget, two_pass):
    """K1: live candidates x 44 B + counts + 12 B (one layer) or 24 B (two
    layers) per tile pixel; 25 operations per (live candidate, pixel centre
    of its tile inside the candidate's screen bounding box) pair."""
    nt, _, k = data.shape
    live = k1_live(counts, k, tile_budget, trans_budget)
    v = data[:, :6].double()
    x, y = v[:, 0::2], v[:, 1::2]  # (NT, 3, K)
    tids = torch.arange(nt, device=data.device)
    ox = ((tids % tiles_x) * tile_w).double()[:, None]
    oy = (torch.div(tids, tiles_x, rounding_mode="floor")
          * tile_h).double()[:, None]

    def span(lo, hi, o, n):
        # pixel columns c in [o, o + n) with lo <= c + 0.5 <= hi
        first = torch.clamp(torch.ceil(lo - 0.5), min=o, max=o + n)
        last = torch.clamp(torch.floor(hi - 0.5), min=o - 1, max=o + n - 1)
        return torch.nan_to_num(torch.clamp(last - first + 1, min=0), nan=0)

    nx = span(x.amin(1), x.amax(1), ox, tile_w)
    ny = span(y.amin(1), y.amax(1), oy, tile_h)
    pairs = int(torch.where(live, nx * ny, torch.zeros_like(nx)).sum())
    n_live = int(live.sum())
    out_bytes = nt * tile_h * tile_w * (24 if two_pass else 12)
    return {"bytes": n_live * K1_BYTES_PER_CANDIDATE + counts.numel() * 4
            + out_bytes, "ops": K1_OPS_PER_PAIR * pairs, "pairs": pairs,
            "live_candidates": n_live}


def resolve_work(slot, rows):
    """K2: the output, the slots and each distinct referenced row."""
    tb, th, tw = slot.shape
    _, k, a = rows.shape
    flat = slot.reshape(tb, th * tw).long()
    hit = (flat >= 0) & (flat < k)
    key = torch.arange(tb, device=slot.device)[:, None] * k + flat
    n_rows = int(torch.unique(key[hit]).numel())
    return {"bytes": (a * tb * th * tw + slot.numel()) * 4 + n_rows * a * 4,
            "ops": 0, "rows": n_rows}


def fused_shade_work(rows, s_o, s_t, d_o, d_t, ltab, lcount, cam, ipv, org,
                     *, sf=None, sfi=None, ovr=None, ovr_chans=4, tlist=None,
                     tcount=None, **_):
    """K3: the four slot / depth planes, the eight output planes, and for
    covered (pixel, layer) items only: their override values, the opaque
    items' slot-factor values of mapped tiles, and the 35 used floats of
    each distinct referenced row; about 60 operations per (item, light).
    Beside them the counts the light loop's critical path comes from:
    the most items in a tile and in one of the kernel's blocks
    (``shade_block_items``), the most (item, light) iterations of a tile,
    and ``critical_path``, the most light iterations one thread of a block
    runs: ceil(items / BLOCK_THREADS) x n_iter, the maximum over blocks."""
    nt, k, _a = rows.shape
    npx = s_o.shape[1] * s_o.shape[2]
    cov = torch.stack([s_o.reshape(nt, npx) >= 0,
                       s_t.reshape(nt, npx) >= 0])  # (2, NT, npx)
    per_tile = cov.sum(dim=(0, 2))  # items a tile
    n_items = int(per_tile.sum())
    if tlist is not None:
        n_iter = tcount.long().clamp(0, tlist.shape[1])
    else:
        n_iter = lcount.long().clamp(0, ltab.shape[0]).expand(nt)
    ops = K3_OPS_PER_LIGHT * int((per_tile * n_iter).sum())
    per_block = SP.shade_block_items(s_o, s_t)[1]  # (NT, NB)
    rounds = (per_block.long() + SP.BLOCK_THREADS - 1) // SP.BLOCK_THREADS
    slots = torch.stack([s_o.reshape(nt, npx), s_t.reshape(nt, npx)])
    key = (torch.arange(nt, device=rows.device)[None, :, None] * k
           + slots.long().clamp(max=k - 1))
    n_rows = int(torch.unique(key[cov]).numel())
    nbytes = nt * npx * (4 * 4 + 8 * 4) + n_rows * K3_ROW_FLOATS * 4
    nbytes += ltab.numel() * 4
    if ovr is not None:
        nbytes += n_items * ovr_chans * 4
    if sf is not None:
        # a factor is read where the tile is mapped in a slot a live light
        # owns
        n_slots = sf.shape[0]
        owned = (ltab[:int(lcount.reshape(-1)[0]), 21:21 + n_slots]
                 > 0.5).any(dim=0)
        mapped = ((sfi >= 0) & owned[:, None]).sum(dim=0)  # (NT,)
        nbytes += (int((cov[0].sum(dim=1) * mapped).sum()) * 4
                   + sfi.numel() * 4)
    if tlist is not None:
        nbytes += (tlist.numel() + tcount.numel()) * 4
    return {"bytes": nbytes, "ops": ops, "items": n_items,
            "items_opaque": int(cov[0].sum()),
            "items_transparent": int(cov[1].sum()), "rows": n_rows,
            "items_max_tile": _max(per_tile),
            "items_max_block": _max(per_block),
            "light_iters_max_tile": _max(per_tile * n_iter),
            "critical_path": _max(rounds * n_iter[:, None])}


DS_PIXEL_BYTES = 40  # both winner ids, 8 floats out
DS_LAYER_BYTES = 56  # position, normal, albedo, material, uv, emis, spec
DS_FRONT_BYTES = 12  # where the transparent layer is covered: both depths
# and its alpha, for the flags and the blend
DS_OPS_PER_LIGHT = 60  # Blinn-Phong terms per (covered item, live light)
DS_OPS_PER_PCF = 80  # the light-clip rows, the division, 9 taps, per slot
DS_OPS_PER_SAMPLE = 40  # a bilinear sample: wrap, rect, 4 taps x 3


def _atlas_texels(atlas, tex, uv):
    """Flat texel ids (layer, row, column) of the four taps
    ``textures.sample_atlas`` reads for texture ids ``tex`` at ``uv``."""
    s = atlas.size
    t = tex.clamp(0, atlas.num_textures - 1).long()
    lay = atlas.tex_layer[t].long()
    rect = atlas.uv_rect[t]
    u = rect[:, 2] + torch.remainder(uv[:, 0], 1.0) * rect[:, 0]
    v = rect[:, 3] + (1.0 - torch.remainder(uv[:, 1], 1.0)) * rect[:, 1]
    u0 = torch.floor(u).clamp(0.0, s - 1.0).long()
    v0 = torch.floor(v).clamp(0.0, s - 1.0).long()
    u1, v1 = (u0 + 1).clamp(max=s - 1), (v0 + 1).clamp(max=s - 1)
    return torch.cat([(lay * s + vv) * s + uu
                      for vv in (v0, v1) for uu in (u0, u1)])


def _pcf_texels(shadow, slot, pos):
    """Flat texel ids of the 3x3 taps ``shadows.pcf_factor`` reads in
    ``slot`` at world positions ``pos`` (N, 3)."""
    res = shadow.resolution
    homo = torch.cat([pos, torch.ones_like(pos[:, :1])], dim=1)
    clip = homo @ shadow.light_mats[slot].T
    w = clip[:, 3]
    ndc = clip[:, :3] / torch.where(w.abs() > 1e-9, w,
                                    torch.ones_like(w))[:, None]
    u = (ndc[:, 0] * 0.5 + 0.5) * res - 0.5
    v = (0.5 - ndc[:, 1] * 0.5) * res - 0.5
    ui = torch.round(u).clamp(0, res - 1).long()
    vi = torch.round(v).clamp(0, res - 1).long()
    taps = [((vi + dy).clamp(0, res - 1) * res + (ui + dx).clamp(0, res - 1))
            for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
    return torch.cat(taps) + slot * res * res


def deferred_shade_work(gbuf, extras, t_gbuf, t_extras, lights, bank,
                        camera_position, *, atlas=None, batch=None,
                        shadow_state=None, gbuffer_planes=False):
    """The default route's shading kernel: 40 B per pixel (both winner ids,
    the packed row) and the planes of each covered (pixel, layer) item, 56 B
    (60 with a shininess plane), read once, and 12 B more for each covered
    transparent item (both depths and the alpha); with
    ``gbuffer_planes`` every pixel's planes read and its two textured planes
    written; the light arrays; the distinct atlas texels the textured items'
    taps read (12 B) and, where a normal map is sampled, the winner
    triangles' positions and uvs (60 B each); the distinct shadow-map texels
    of the PCF taps of the covered opaque pixels' block anchors, in the
    slots a live shadowed light owns (4 B). Operations: about 60 per (item,
    live light), 80 per (opaque item, needed slot), 40 per atlas sample."""
    rows, cols = gbuf.depth.shape
    npx = rows * cols
    layer_bytes = DS_LAYER_BYTES + (4 if "shininess" in extras else 0)
    covs = [g.tri_id.reshape(-1) >= 0 for g in (gbuf, t_gbuf)]
    items = [int(c.sum()) for c in covs]
    n_live = (int(lights.dir_count) + int(lights.pt_count)
              + int(lights.sp_count))
    nbytes = (npx * DS_PIXEL_BYTES + sum(items) * layer_bytes
              + items[1] * DS_FRONT_BYTES)
    nbytes += sum(t.numel() * 4 for t in vars(lights).values())
    ops = DS_OPS_PER_LIGHT * sum(items) * n_live
    shaded = covs
    if gbuffer_planes:
        nbytes += ((2 * npx - sum(items)) * layer_bytes
                   + (npx - items[1]) * 4 + 2 * npx * 24)
        shaded = [torch.ones_like(c) for c in covs]
    texels = samples = 0
    tan_rows = set()
    if atlas is not None:
        roles = [(0, True), (1, bank.has_specular_maps()),
                 (2, bank.has_emissive_maps()), (3, bank.has_normal_maps())]
        ids = []
        for layer, (g, ex) in enumerate(((gbuf, extras),
                                         (t_gbuf, t_extras))):
            m = shaded[layer]
            mat = g.material.reshape(-1)[m].clamp(
                0, bank.mat_textures.shape[0] - 1).long()
            uv = ex["uv"].reshape(-1, 2)[m]
            tx = bank.mat_textures[mat]
            use = roles + ([(4, bank.has_dissolve_maps())] if layer else [])
            for col, on in use:
                if not on:
                    continue
                hit = tx[:, col] >= 0
                if bool(hit.any()):
                    ids.append(_atlas_texels(atlas, tx[hit, col], uv[hit]))
                    samples += int(hit.sum())
                    if col == 3:
                        tri = g.tri_id.reshape(-1)[m][hit]
                        tan_rows.update(tri.clamp(0, batch.budget - 1)
                                        .tolist())
        if ids:
            texels = int(torch.unique(torch.cat(ids)).numel())
    nbytes += texels * 12 + len(tan_rows) * 60
    ops += DS_OPS_PER_SAMPLE * samples
    if shadow_state is not None and items[0]:
        k = shadow_state.pcf_scale
        r = torch.arange(rows, device=gbuf.depth.device)
        c = torch.arange(cols, device=gbuf.depth.device)
        anchor = ((r - r % k)[:, None] * cols + (c - c % k)[None, :])
        anchor = torch.unique(anchor.reshape(-1)[covs[0]])
        pos = gbuf.position.reshape(-1, 3)[anchor]
        n_sf = min(4, lights.pt_entity.shape[0])
        ents = torch.cat([
            lights.dir_entity[:int(lights.dir_count)],
            lights.pt_entity[:min(n_sf, int(lights.pt_count))],
            lights.sp_entity[:int(lights.sp_count)]])
        need = [s for s in range(shadow_state.slots)
                if int(shadow_state.slot_entity[s]) >= 0
                and bool((ents == shadow_state.slot_entity[s]).any())]
        if need:
            taps = torch.cat([_pcf_texels(shadow_state, s, pos)
                              for s in need])
            nbytes += int(torch.unique(taps).numel()) * 4
        ops += DS_OPS_PER_PCF * items[0] * len(need)
    return {"bytes": nbytes, "ops": ops, "items_opaque": items[0],
            "items_transparent": items[1], "live_lights": n_live,
            "atlas_texels": texels, "atlas_samples": samples}


CG_PIXEL_BYTES = 48  # the winner id in; position, normal, albedo, material
# and system out
CG_OWNED_BYTES = 8  # an owned pixel's slot and depth
CG_ROW_FLOATS = 28  # channels 0-5 and 10-31 of a winner's row
CG_NORM_FLOATS = 4  # and 55-58 with normal maps
CG_OPS_PER_PIXEL = 110  # barycentrics, unprojection, normal and uv of an
# owned pixel


def custom_gbuffer_work(layers, rows, tri_sys, sys_shaded, inv_pv, bank,
                        atlas=None, *, tiles_x, width, h_total, h_local,
                        y_off):
    """The custom-shading hook's G-buffer kernel, both layers: 48 B per
    pixel (its winner id read, its planes written); for each owned pixel
    its slot and depth (8 B), and once each distinct winner row's 28
    channels (32 with normal maps) and each distinct atlas texel of the
    owned pixels' albedo and normal-map taps (12 B); the distinct entries
    of ``tri_sys`` the pixels look up (4 B). Operations: about 110 per
    owned pixel, 40 per atlas sample."""
    nt, th, tw = layers[0][0].shape
    k = rows.shape[1]
    dev = rows.device
    with_norm = atlas is not None and bank.has_normal_maps()
    px, py = RP._tall_pixel_centers(torch.arange(nt, device=dev), tiles_x,
                                    th, tw)
    inside = CG.inside_image(nt, tiles_x, th, tw, width, h_local, dev)
    tile = torch.arange(nt, device=dev).repeat_interleave(th)[:, None]
    n_tri = tri_sys.shape[0]
    owned = samples = 0
    keys, looked_up, texel_ids = [], [], []
    for slot, depth, winner, textured in layers:
        wn = winner.reshape(nt * th, tw)
        px_sys = tri_sys[wn.clamp(0, n_tri - 1).long()]
        own = CG.owned_pixels(px_sys, wn, sys_shaded, inside)
        owned += int(own.sum())
        keys.append((tile * k + slot.reshape(nt * th, tw))[own])
        looked_up.append(wn.clamp(0, n_tri - 1).reshape(-1))
        if atlas is None or not textured or not bool(own.any()):
            continue
        gbuf, uv = CG._layer_chain(slot, depth, winner, False, rows, inv_pv,
                                   bank, None, px, py, width=width,
                                   h_total=h_total, y_off=y_off)
        mat = gbuf.material[own].clamp(0, bank.mat_textures.shape[0]
                                       - 1).long()
        tx, uv = bank.mat_textures[mat], uv[own]
        for col in (0, 3) if with_norm else (0,):
            hit = tx[:, col] >= 0
            if bool(hit.any()):
                texel_ids.append(_atlas_texels(atlas, tx[hit, col], uv[hit]))
                samples += int(hit.sum())
    n_rows = int(torch.unique(torch.cat(keys)).numel())
    texels = (int(torch.unique(torch.cat(texel_ids)).numel()) if texel_ids
              else 0)
    row_floats = CG_ROW_FLOATS + (CG_NORM_FLOATS if with_norm else 0)
    nbytes = (2 * nt * th * tw * CG_PIXEL_BYTES + owned * CG_OWNED_BYTES
              + n_rows * row_floats * 4 + texels * 12
              + int(torch.unique(torch.cat(looked_up)).numel()) * 4)
    return {"bytes": nbytes,
            "ops": CG_OPS_PER_PIXEL * owned + DS_OPS_PER_SAMPLE * samples,
            "owned_pixels": owned, "rows": n_rows, "atlas_texels": texels,
            "atlas_samples": samples}


TG_PIXEL_BYTES = 64  # the winner id in; position, normal, albedo, material,
# uv, emissive, alpha and specular out
TG_SHIN_BYTES = 4  # the shininess plane, with packed (spec, Ns) rows
TG_COVERED_BYTES = 8  # a covered pixel's slot and depth
TG_ROW_FLOATS = 31  # channels 0-5 and 10-34 of a winner's row
TG_OPS_PER_PIXEL = 115  # CG_OPS_PER_PIXEL and the spec/Ns unpacking


def tall_gbuffer_work(layers, rows, inv_pv, *, tiles_x, width, height,
                      spec_packed):
    """The default route's G-buffer kernel, both layers: 64 B per pixel
    (its winner id read, its planes written; 68 with a shininess plane);
    for each covered pixel its slot and depth (8 B), and once each distinct
    winner row's 31 channels. Operations: about 115 per covered pixel."""
    nt, th, tw = layers[0][0].shape
    k = rows.shape[1]
    tile = torch.arange(nt, device=rows.device)[:, None, None]
    covered, keys = 0, []
    for slot, _, winner in layers:
        cov = winner >= 0
        covered += int(cov.sum())
        keys.append((tile * k + slot)[cov & (slot >= 0) & (slot < k)])
    n_rows = int(torch.unique(torch.cat(keys)).numel())
    pixel = TG_PIXEL_BYTES + (TG_SHIN_BYTES if spec_packed else 0)
    return {"bytes": 2 * nt * th * tw * pixel + covered * TG_COVERED_BYTES
            + n_rows * TG_ROW_FLOATS * 4,
            "ops": TG_OPS_PER_PIXEL * covered, "covered_pixels": covered,
            "rows": n_rows}
