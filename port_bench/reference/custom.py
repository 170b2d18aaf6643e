"""The frame of the demo with the user's render systems, written out
plainly: the ``custom`` program's image.

The semantics are the engine's specification of render systems (the JAX
package's ``render/render_system.py`` and the fused route of
``render/frame.py``, not imported) on the demo scene of ``demo.py``:

* systems: the lit system holds every model but the stars, the light
  sources the stars (``demo.py``'s unlit models); a pixel's system is its
  winner triangle's entity's model's;
* the light sources' draw callback: their instances draw only in the
  spot-light sortable bucket and while the camera's z is positive; the
  emissive boost it writes (1) times the system's own (6) is the stars';
  the skybox shows under the same gate, else the clear color (black);
* the G-buffer of each layer: the world position unprojected from the
  pixel's depth, the perspective-correct normal (normal-mapped on the
  opaque layer, every pixel: the shading functions' resolve has no tile
  budget), the albedo (the atlas's on the opaque layer), the material;
* the lit system's fragment shader, ``fog_rim``, over the default lit
  color of each covered pixel it owns, opaque and transparent, before the
  transparent layer is blended over; every other pixel keeps the demo's
  color (``render.py``: shadows, texture budget, the unlit stars).

Helpers come from ``render.py``; its ``frame_image`` is the frame of the
demo without systems of the user's."""

from __future__ import annotations

import torch

from port_bench.reference import demo as D
from port_bench.reference import render as R
from port_bench.reference import xform as X

SYSTEM_LIT, SYSTEM_SOURCES = 0, 1
CALLBACK_BOOST = 1.0  # the callback's ``emissive_boost``
MATERIAL_KEYS = ("fog_color", "fog_density", "rim_color", "rim_power")


def model_systems(sc) -> torch.Tensor:
    """(M,) the system of each model: the light sources' for the unlit
    models, the lit system's for the others."""
    return torch.where(sc.bank["unlit"], SYSTEM_SOURCES, SYSTEM_LIT)


def draw_callback(w, camv, sc):
    """The light sources' draw callback: (CAP,) bool, the entities that
    draw (the light sources' only in the spot-light bucket and while the
    camera's z is positive; every other entity), and the skybox gate."""
    front = camv[2] > 0.0
    mid = w["comps.model_id"]
    sources = (mid >= 0) & (model_systems(sc)[mid.clamp(min=0)]
                            == SYSTEM_SOURCES)
    drawn = (w["comps.sortable"] == D.SORTABLE_SPOT) & front
    return torch.where(sources, drawn, True), front


def fog_rim(base, pos, nrm, eye, m: dict):
    """The lit system's fragment shader: with ``d = |eye - pos|``, ``V``
    the unit vector to the eye and ``f = exp(-fog_density * d)``,
    ``f * (base + rim_color * (1 - max(N . V, 0)) ** rim_power) + (1 - f)
    * fog_color``, clipped to [0, 1]."""
    dev = base.device
    fog_color = torch.tensor(m["fog_color"], dtype=torch.float32, device=dev)
    rim_color = torch.tensor(m["rim_color"], dtype=torch.float32, device=dev)
    to_eye = eye - pos
    d = X.norm(to_eye, keepdim=True)
    v = to_eye / d.clamp(min=1e-6)
    f = torch.exp(-float(m["fog_density"]) * d)
    ndv = (nrm * v).sum(-1, keepdim=True).clamp(min=0.0)
    rim = rim_color * torch.pow(1.0 - ndv, float(m["rim_power"]))
    return (f * (base + rim) + (1.0 - f) * fog_color).clamp(0.0, 1.0)


def frame(w, camv, sh, sc, material: dict) -> dict:
    """The frame from the world, the camera vector and the shadow state
    after this frame's update: ``image`` (H, W, 3) and ``layers``, the
    opaque layer's and the transparent layer's dicts of ``depth``,
    ``covered``, ``system`` (-1 where nothing is drawn), the G-buffer's
    ``position``, ``normal`` and ``albedo``, the default lit ``color`` and
    the ``shaded`` color after the fragment shader."""
    st, bank, cam, dev = sc.settings, sc.bank, sc.cam, camv.device
    if not st.fused:
        raise NotImplementedError("the user's systems are specified on the "
                                  "fused route")
    W, H, th, tw = st.width, st.height, st.tile_h, st.tile_w
    tx, ty = -(-W // tw), -(-H // th)
    pv = X.proj_view(camv, cam)
    allowed, front = draw_callback(w, camv, sc)
    mid_w = w["comps.model_id"]
    drawn = dict(w, **{"comps.model_id": torch.where(allowed, mid_w, -1)})
    tris = R.to_screen(R.triangles(drawn, sc, pv, camv[0:3], st.max_tris),
                       W, H)
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
    lights = R.spot_lights(w, st.max_spot)
    msys = model_systems(sc)
    tan, hand = R.tangents(tris)
    boost = D.EMISSIVE_BOOST * CALLBACK_BOOST
    # the texture budget of the fused route's lighting: tiles holding any
    # textured candidate come first, up to the budget
    ntiles = tx * ty
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

    def layer(win, dep, shadows, textured):
        """One layer: its G-buffer, owner and default lit color;
        ``textured``: the lighting's textured pixels (None: the layer is
        not textured, in the lighting or the G-buffer)."""
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
        ent_model = mid_w[tris["ent"][tri]]
        system = torch.where(cov, msys[ent_model.clamp(min=0)], -1)
        unlit = system == SYSTEM_SOURCES
        emis = torch.where(unlit, bank["emissive"][mat].clamp(min=1.0)
                           * boost, bank["emissive"][mat])
        spec_k = bank["specular"][mat]
        g_albedo, g_normal = albedo, n
        if textured is not None:
            tex = bank["texture"][mat]
            nmap = bank["normal_map"][mat]
            smp = R.sample(sc.atlas, tex, uv)
            pert = R.perturb(n, tan[tri], hand[tri],
                             R.sample(sc.atlas, nmap, uv))
            g_albedo = torch.where((tex >= 0)[..., None], smp, albedo)
            g_normal = torch.where((nmap >= 0)[..., None], pert, n)
            albedo = torch.where(((tex >= 0) & textured)[..., None], smp,
                                 albedo)
            n = torch.where(((nmap >= 0) & textured)[..., None], pert, n)
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
            spec = torch.where(ndl > 0.0, ndh ** R.SHININESS, 0.0) \
                * spec_k[..., None]
            s = atten * inten
            if shadows and factors is not None:
                for slot, ent in enumerate(sh["slot_entity"].tolist()):
                    if ent == li:
                        s = s * factors[slot][..., None]
            color = color + s * (w["comps.light_ambient"][li] * albedo
                                 + w["comps.light_diffuse"][li] * ndl * albedo
                                 + w["comps.light_specular"][li] * spec)
        color = torch.maximum(color, R.DIFFUSE_FLOOR * albedo)
        color = torch.where((emis > 0.0)[..., None], albedo * emis[..., None],
                            color)
        color = torch.where(cov[..., None], color, 0.0)
        mine = (system == SYSTEM_LIT)[..., None]
        shaded = torch.where(mine, fog_rim(color, pos, g_normal, camv[0:3],
                                           material), color)
        return {"depth": dep, "covered": cov, "system": system,
                "position": pos, "normal": g_normal, "albedo": g_albedo,
                "alpha": bank["alpha"][mat].clamp(0.0, 1.0), "color": color,
                "shaded": shaded}

    tex_px = R._untile_bool(textured_tile, tx, ty, th, tw, H, W)
    lo = layer(w_o, d_o, True, tex_px)
    lt = layer(w_t, d_t, False, None)
    bg = torch.where(front, R.starfield(camv, sc), 0.0)
    base = torch.where(lo["covered"][..., None], lo["shaded"], bg)
    in_front = (lt["covered"] & (d_t <= d_o))[..., None]
    a = torch.where(lt["covered"], lt["alpha"], 1.0)[..., None]
    image = torch.where(in_front, a * lt["shaded"] + (1.0 - a) * base,
                        base).clamp(0.0, 1.0)
    return {"image": image, "layers": (lo, lt)}
