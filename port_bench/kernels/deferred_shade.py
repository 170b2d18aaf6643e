"""The default route's shading kernel: ``deferred_shade_kernel``
(``csrc/deferred_shade.cu``), from ``deferred_shade.deferred_shade``'s
calls. The arithmetic is a frozen copy of the port's
``kernel_bounds.deferred_shade_work``: 40 B a pixel, the covered items'
planes, 12 B more a covered transparent item, the light arrays, the
distinct atlas and shadow-map texels read."""

from __future__ import annotations

import torch

PROFILER_NAME = "deferred_shade_kernel"
EXCLUDE = None
WRAPS = "render_engine_tpu_torch.render.deferred_shade:deferred_shade"

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


def work(*a, **kw):
    return deferred_shade_work(*a, **kw)
