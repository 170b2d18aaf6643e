"""The many-lights scene's lights and image, written out plainly.

The scene is the demo's (``demo.py``) with a fixed rig of point lights
spawned after it; the image is ``render.py``'s frame with every live light
of the engine's light table shaded at every covered pixel, where
``render.py`` shades the spot lights alone:

* the rig: a generator seeded by the configuration's own seed draws the
  positions (a cube of half-width ``spread`` around ``center``), then the
  diffuse colours, then the radii; each light takes the configuration's
  attenuation, no ambient and no specular colour, into the first free
  entity slots;
* the light table: directional, then point, then spot lights, each kind
  by entity index and up to its budget;
* each light's term: Blinn-Phong (ambient, diffuse and specular colours
  over the albedo, the half vector's power on the specular strength),
  scaled by the attenuation ``1 / (1 + l d + q d^2)`` (none for a
  directional light), zero beyond a point light's radius (a radius of 0
  or less has none), a spot light's smooth cone, and on the opaque layer
  the PCF factor of each shadow slot the light owns; the terms summed in
  table order, then ``render.py``'s diffuse floor, emissive bypass,
  transparency and starfield.

No per-tile light list is taken: lists must not change the image, so a
tile whose list overflows shows in the image. Nothing here imports the
port."""

from __future__ import annotations

import numpy as np
import torch

from port_bench.reference import demo as D
from port_bench.reference import render as R
from port_bench.reference import xform as X

# the configurations' precision: float32 with TF32 off
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

SORTABLE_DIRECTIONAL, SORTABLE_POINT = 1, 2
# the light table's kinds in its order
KINDS = (SORTABLE_DIRECTIONAL, SORTABLE_POINT, D.SORTABLE_SPOT)


def count(lights: dict, overrides=None) -> int:
    """The rig's number of point lights (``n_lights`` among the tests'
    small sizes)."""
    return int((overrides or {}).get("n_lights", lights["count"]))


def budgets(lights: dict, overrides=None) -> tuple:
    """The light table's budget of each kind of ``KINDS``: the point
    lights' is the rig's size."""
    return (int(lights["max_dir_lights"]), count(lights, overrides),
            int(lights["max_spot_lights"]))


def rig(lights: dict, overrides=None) -> dict:
    """The point lights of the configuration's ``lights``, as columns of
    the world."""
    n = count(lights, overrides)
    rng = np.random.default_rng(int(lights["seed"]))
    s = float(lights["spread"])
    pos = (np.asarray(lights["center"], np.float64)
           + rng.uniform(-s, s, (n, 3))).astype(np.float32)
    diffuse = rng.uniform(*lights["diffuse"], (n, 3)).astype(np.float32)
    radius = rng.uniform(*lights["radius"], n).astype(np.float32)
    return {"position": pos,
            "sortable": np.full(n, SORTABLE_POINT, np.int32),
            "light_diffuse": diffuse,
            "light_atten": np.full((n, 2), lights["attenuation"], np.float32),
            "light_radius": radius}


def spawn(w: dict, columns: dict):
    """The entities of ``columns`` into the first free slots of the world
    ``w`` (changed in place): those columns set, every other at its
    default, ``comp_mask`` the bits of those columns."""
    n = len(next(iter(columns.values())))
    idx = torch.nonzero(~w["alive"]).flatten()[:n]
    if idx.numel() < n:
        raise ValueError(f"the world has {idx.numel()} free slots, the rig "
                         f"{n} lights")
    bits = 0
    for name, values in columns.items():
        col = w[f"comps.{name}"]
        col[idx] = torch.as_tensor(np.asarray(values), dtype=col.dtype,
                                   device=col.device)
        bits |= D.BIT[name]
    w["alive"][idx] = True
    w["comp_mask"][idx] = bits


def table(w: dict, budget: tuple) -> list[tuple[int, int]]:
    """The light table's live rows in order, ``(kind, entity)``: each kind
    of ``KINDS`` by entity index, up to its ``budget``."""
    out = []
    for kind, b in zip(KINDS, budget):
        ids = torch.nonzero(w["alive"] & (w["comps.sortable"] == kind))
        out += [(kind, e) for e in ids.flatten()[:b].tolist()]
    return out


def term(kind: int, light: dict, pos, n, v, albedo, spec_k):
    """One light's ``(s, c)`` at world positions ``pos`` (..., 3) with unit
    normals ``n`` and unit view vectors ``v``, albedo and specular
    strength ``spec_k`` (...): ``c`` the Blinn-Phong colour (..., 3), ``s``
    (..., 1) its scale, the attenuation (1 for a directional light), zero
    beyond a point light's radius, times a spot light's cone. ``light``
    holds the entity's ``position``, ``light_direction``,
    ``light_diffuse``, ``light_specular``, ``light_ambient``,
    ``light_atten``, ``light_cutoff`` and ``light_radius``."""

    def unit(a):
        na = X.norm(a)
        return a / torch.where(na > 1e-9, na, 1.0)

    if kind == SORTABLE_DIRECTIONAL:
        ld = (-unit(light["light_direction"])).expand_as(pos)
        s = torch.ones_like(pos[..., :1])
    else:
        tv = light["position"] - pos
        d2 = (tv * tv).sum(-1, keepdim=True)
        dist = torch.sqrt(d2.clamp(min=1e-18))
        ld = tv / dist
        at = light["light_atten"]
        s = 1.0 / (1.0 + at[0] * dist + at[1] * d2)
        if kind == SORTABLE_POINT:
            r = light["light_radius"]
            s = torch.where((r > 0.0) & (dist > r), 0.0, s)
        else:
            cut = light["light_cutoff"]
            cos_t = -(ld * unit(light["light_direction"])).sum(-1,
                                                               keepdim=True)
            eps = torch.clamp(cut[0] - cut[1], min=1e-6)
            s = s * ((cos_t - cut[1]) / eps).clamp(0.0, 1.0)
    ndl = (n * ld).sum(-1, keepdim=True).clamp(min=0.0)
    h = ld + v
    h = h / X.norm(h, keepdim=True).clamp(min=1e-12)
    ndh = (n * h).sum(-1, keepdim=True).clamp(min=0.0)
    spec = torch.where(ndl > 0.0, ndh ** R.SHININESS, 0.0) * spec_k[..., None]
    c = (light["light_ambient"] * albedo + light["light_diffuse"] * ndl
         * albedo + light["light_specular"] * spec)
    return s, c


def frame_image(w, camv, sh, sc, budget: tuple):
    """The frame's (H, W, 3) image from the world, the camera vector and
    the shadow state after this frame's update, every live light of the
    table (``budget``: ``budgets``) shaded."""
    st, bank, cam, dev = sc.settings, sc.bank, sc.cam, camv.device
    W, H, th, tw = st.width, st.height, st.tile_h, st.tile_w
    tx, ty = -(-W // tw), -(-H // th)
    pv = X.proj_view(camv, cam)
    tris = R.to_screen(R.triangles(w, sc, pv, camv[0:3], st.max_tris), W, H)
    cls = torch.where(tris["valid"],
                      torch.where(tris["transparent"], 2, 1), 0)
    cand = R.bins(tris, cls, W, H, st.tile_budget, st.trans_budget,
                  st.global_budget, st.pair_budget)
    (d_o, w_o), (d_t, w_t) = R.raster(tris, cls, cand, W, H, layers=(1, 2))
    ipv = torch.linalg.inv(pv)
    yy = torch.arange(H, device=dev, dtype=torch.float32)[:, None] + 0.5
    xx = torch.arange(W, device=dev, dtype=torch.float32)[None, :] + 0.5
    ndc_x = (xx / float(W) * 2.0 - 1.0).expand(H, W)
    ndc_y = (1.0 - yy / float(H) * 2.0).expand(H, W)
    names = ("position", "light_direction", "light_diffuse",
             "light_specular", "light_ambient", "light_atten",
             "light_cutoff", "light_radius")
    rows = [(kind, e, {k: w[f"comps.{k}"][e] for k in names})
            for kind, e in table(w, budget)]
    tan, hand = R.tangents(tris)
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
    factors = R.shadow_factors(sh, d_o, w_o, ipv, ndc_x, ndc_y, sc) \
        if st.shadows else None
    owners = [] if sh is None else sh["slot_entity"].tolist()

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
        unlit = bank["unlit"][w["comps.model_id"][tris["ent"][tri]]
                              .clamp(min=0)]
        emis = torch.where(unlit, bank["emissive"][mat].clamp(min=1.0)
                           * D.EMISSIVE_BOOST, bank["emissive"][mat])
        alpha = bank["alpha"][mat].clamp(0.0, 1.0)
        spec_k = bank["specular"][mat]
        if textured is not None:
            tex = bank["texture"][mat]
            nmap = bank["normal_map"][mat]
            albedo = torch.where(((tex >= 0) & textured)[..., None],
                                 R.sample(sc.atlas, tex, uv), albedo)
            pert = R.perturb(n, tan[tri], hand[tri],
                             R.sample(sc.atlas, nmap, uv))
            n = torch.where(((nmap >= 0) & textured)[..., None], pert, n)
        # the position from the depth
        ndc = torch.stack([ndc_x, ndc_y, dep, torch.ones_like(dep)], -1)
        wp = torch.einsum("ij,hwj->hwi", ipv, ndc)
        pos = wp[..., :3] / torch.where(wp[..., 3:].abs() > 1e-12,
                                        wp[..., 3:], 1.0)
        v = camv[0:3] - pos
        v = v / X.norm(v, keepdim=True).clamp(min=1e-12)
        color = torch.zeros_like(pos)
        for kind, e, light in rows:
            s, c = term(kind, light, pos, n, v, albedo, spec_k)
            if shadows and factors is not None:
                for slot, ent in enumerate(owners):
                    if ent == e:
                        s = s * factors[slot][..., None]
            color = color + s * c
        color = torch.maximum(color, R.DIFFUSE_FLOOR * albedo)
        color = torch.where((emis > 0.0)[..., None], albedo * emis[..., None],
                            color)
        return torch.where(cov[..., None], color, 0.0), alpha, cov

    if st.fused:
        tex_px = R._untile_bool(textured_tile, tx, ty, th, tw, H, W)
    else:
        tex_px = torch.ones(H, W, dtype=torch.bool, device=dev)
    c_o, _, cov_o = shade(w_o, d_o, True, tex_px)
    c_t, a_t, cov_t = shade(w_t, d_t, False, None if st.fused else tex_px)
    bg = R.starfield(camv, sc)
    base = torch.where(cov_o[..., None], c_o, bg)
    front = (cov_t & (d_t <= d_o))[..., None]
    a = torch.where(cov_t, a_t, 1.0)[..., None]
    return torch.where(front, a * c_t + (1.0 - a) * base, base).clamp(0.0, 1.0)
