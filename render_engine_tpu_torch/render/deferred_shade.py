"""The default route's shading stage: the atlas, the shadow maps' PCF factor
and Blinn-Phong of both layers over the tall G-buffers, packed for the
compose.

``render/frame.py`` ``_render_frame_tiled`` (the non-fused tiled path) calls
``deferred_shade`` after ``raster_pallas.gbuffers_tall``, which builds the
planes of every pixel (on a card one ``tall_gbuffer`` kernel for both
layers); the shading kernel reads them where a layer is covered. For CUDA
tensors it launches ``csrc/deferred_shade.cu``, one thread per pixel of
the tall layout; for CPU tensors it runs ``deferred_shade_reference``, the
plain version: ``texture_gbuffer`` per layer, ``shadows.make_shadow_factor``,
``lighting.shade`` per layer and one ``torch.cat``. The JAX package leaves
this route to XLA, so the kernel replaces no Pallas kernel. A frame with a
``shadow_factor`` callback (a Python function, which no kernel can call)
runs ``deferred_shade_reference`` on any device.

The kernel reads at most MAX_SLOTS shadow slots and stages at most
MAX_LIGHT_ROWS light rows in shared memory; ``check_reach`` refuses more
(the plain version, the fused route and a callback take any number).

Output: ``packed`` (rows, cols, 8) float32 = [lit rgb | t_lit rgb |
t_alpha | flags], flags = opaque covered + 2 * (transparent covered and in
front), in the layout ``raster_pallas._untile_tall`` takes; with
``gbuffer_planes`` also the two textured G-buffers, which render systems
with shading functions read. Where a pixel is empty its colors are 0; on the
kernel route the alpha is 0 where the transparent layer is empty, unless
``gbuffer_planes`` textures every pixel (the compose reads it only where
that layer is in front).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.render import lighting as L
from render_engine_tpu_torch.render import shadows as SHD
from render_engine_tpu_torch.render.geometry import (perturb_normal,
                                                     triangle_tangents)
from render_engine_tpu_torch.render.textures import sample_atlas
from render_engine_tpu_torch.utils import consts

MAX_SLOTS = 8  # shadow slots the kernel reads (csrc kMaxSlots)
MAX_LIGHT_ROWS = 2048  # light rows the kernel stages in shared memory
PACKED = 8
_P2 = ctypes.c_void_p * 2  # a pointer of each layer


def texture_gbuffer(g, ex, atlas, bank, batch):
    """The atlas on a non-fused G-buffer: the albedo, the spec, emissive
    and dissolve maps' red channel as multipliers of ``ex``'s planes (in
    place), and the normal map, in the winner triangle's tangent frame."""
    mat_safe = g.material.clamp(0, bank.mat_textures.shape[0] - 1).long()
    layer = bank.mat_texture[mat_safe]

    def multiplier(table):
        lay = table[mat_safe]
        red = sample_atlas(atlas, lay, ex["uv"])[..., 0]
        return torch.where(lay >= 0, red, 1.0)

    if bank.has_specular_maps():
        ex["specular"] = ex["specular"] * multiplier(bank.mat_texture_spec)
    if bank.has_emissive_maps():
        ex["emissive"] = ex["emissive"] * multiplier(bank.mat_texture_emis)
    if bank.has_dissolve_maps():
        ex["alpha"] = ex["alpha"] * multiplier(bank.mat_texture_diss)
    normal = g.normal
    if bank.has_normal_maps():
        nlayer = bank.mat_texture_norm[mat_safe]
        tri = g.tri_id.clamp(0, batch.budget - 1).long()
        tan, handed = triangle_tangents(batch)
        pert = perturb_normal(g.normal, tan[tri], handed[tri],
                              sample_atlas(atlas, nlayer, ex["uv"]))
        normal = torch.where((nlayer >= 0)[..., None], pert, g.normal)
    return dataclasses.replace(
        g, normal=normal,
        albedo=torch.where((layer >= 0)[..., None],
                           sample_atlas(atlas, layer, ex["uv"]), g.albedo))


def deferred_shade_reference(gbuf, extras, t_gbuf, t_extras, lights, bank,
                             camera_position, *, atlas=None, batch=None,
                             shadow_state=None, shadow_factor=None,
                             gbuffer_planes=False):
    """The plain version, on any device: ``deferred_shade``'s result.
    ``shadow_factor``: ``lighting.shade``'s callback for the opaque layer
    (the transparent layer takes none); without one, the factor of
    ``shadow_state``'s maps (``shadows.make_shadow_factor``), if given."""
    extras, t_extras = dict(extras), dict(t_extras)
    if shadow_factor is None and shadow_state is not None:
        shadow_factor = SHD.make_shadow_factor(
            shadow_state, None, {"dir": lights.dir_entity,
                                 "spot": lights.sp_entity,
                                 "point": lights.pt_entity})
    if atlas is not None:
        gbuf = texture_gbuffer(gbuf, extras, atlas, bank, batch)
        t_gbuf = texture_gbuffer(t_gbuf, t_extras, atlas, bank, batch)
    zeros = torch.zeros(gbuf.position.shape, device=gbuf.position.device)

    def shade(g, ex, factor):
        return L.shade(g, lights, bank, camera_position, background=zeros,
                       shadow_factor=factor, emissive_image=ex["emissive"],
                       specular_image=ex["specular"],
                       shininess_image=ex.get("shininess"))

    color = shade(gbuf, extras, shadow_factor)
    # the transparent layer without shadow lookups, as the reference draws
    t_lit = shade(t_gbuf, t_extras, None)
    t_front = t_gbuf.covered() & (t_gbuf.depth <= gbuf.depth)
    flags = gbuf.covered().to(torch.float32) + 2.0 * t_front.to(
        torch.float32)
    packed = torch.cat([color, t_lit, t_extras["alpha"][..., None],
                        flags[..., None]], dim=-1)
    return packed, (gbuf, t_gbuf) if gbuffer_planes else None


def check_reach(settings, slots):
    """Raise ``ValueError`` where the kernel cannot shade the default
    route's frames of ``settings`` with ``slots`` shadow slots: more than
    MAX_SLOTS slots, or more than MAX_LIGHT_ROWS light rows. The Engine
    asks at construction on a card; ``deferred_shade`` asks every call."""
    if settings.fused_shading:
        return
    if slots > MAX_SLOTS:
        raise ValueError(f"{slots} shadow slots exceed the {MAX_SLOTS} the "
                         "default route's shading kernel reads")
    rows = (settings.max_dir_lights + settings.max_point_lights
            + settings.max_spot_lights)
    if rows > MAX_LIGHT_ROWS:
        raise ValueError(f"{rows} light rows exceed the {MAX_LIGHT_ROWS} the "
                         "default route's shading kernel stages")


class DeferredArgs(ctypes.Structure):
    """csrc/deferred_shade.cu's ``DeferredArgs``, field for field."""
    _fields_ = [(n, _P2) for n in ("pos", "nrm", "alb", "mat", "tri",
                                   "depth", "uv", "emis", "spec", "shin")] \
        + [(n, ctypes.c_void_p) for n in (
            "t_alpha", "dir_direction", "dir_diffuse", "dir_specular",
            "dir_ambient", "dir_count", "dir_entity", "pt_position",
            "pt_diffuse", "pt_specular", "pt_ambient", "pt_atten",
            "pt_radius", "pt_count", "pt_entity", "sp_position",
            "sp_direction", "sp_diffuse", "sp_specular", "sp_ambient",
            "sp_atten", "sp_cutoff", "sp_count", "sp_entity", "cam", "maps",
            "light_mats", "slot_entity", "mat_textures", "tex_layer",
            "uv_rect", "layers", "tri_pos", "tri_uv", "out")] \
        + [(n, _P2) for n in ("alb_out", "nrm_out")] \
        + [(n, ctypes.c_int) for n in (
            "rows", "cols", "nd", "np", "ns", "n_slots", "res", "pcf_k",
            "n_mat", "n_tex", "atlas_size", "n_tri", "pos_st", "pos_sv",
            "uv_st", "uv_sv", "with_spec", "with_emis", "with_diss",
            "with_norm")] \
        + [("shin_const", ctypes.c_float)]


def _check_rows(t, name, shape, dev):
    """``kernels.check`` for a float32 table read at its own strides: the
    last one must be 1."""
    if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape:
        raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}, expected float32 {shape} on {dev}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: its last stride is not 1")


def _light_fields(lights, dev):
    """The light arrays' checked pointers, by ``DeferredArgs`` field."""
    f32, i32 = torch.float32, torch.int32
    nd = lights.dir_direction.shape[0]
    npt = lights.pt_position.shape[0]
    ns = lights.sp_position.shape[0]
    shapes = {"dir_direction": (nd, 3), "dir_diffuse": (nd, 3),
              "dir_specular": (nd, 3), "dir_ambient": (nd, 3),
              "dir_entity": (nd,), "pt_position": (npt, 3),
              "pt_diffuse": (npt, 3), "pt_specular": (npt, 3),
              "pt_ambient": (npt, 3), "pt_atten": (npt, 2),
              "pt_radius": (npt,), "pt_entity": (npt,),
              "sp_position": (ns, 3), "sp_direction": (ns, 3),
              "sp_diffuse": (ns, 3), "sp_specular": (ns, 3),
              "sp_ambient": (ns, 3), "sp_atten": (ns, 2),
              "sp_cutoff": (ns, 2), "sp_entity": (ns,), "dir_count": (),
              "pt_count": (), "sp_count": ()}
    out = {}
    for name, shape in shapes.items():
        t = getattr(lights, name)
        dt = i32 if name.endswith(("_entity", "_count")) else f32
        kernels.check(t, f"lights.{name}", dt, shape, dev)
        out[name] = t.data_ptr()
    return out, (nd, npt, ns)


def deferred_shade(gbuf, extras, t_gbuf, t_extras, lights, bank,
                   camera_position, *, atlas=None, batch=None,
                   shadow_state=None, gbuffer_planes=False):
    """Shade both layers of the tall G-buffers: ``(packed, textured)``,
    ``textured`` the two textured G-buffers with ``gbuffer_planes``, else
    None. ``shadow_state``: its maps shade the opaque layer (the PCF factor
    of the slots each light owns, at every ``pcf_scale``-th pixel of the
    tall layout). CPU tensors run the plain version; CUDA tensors launch
    csrc/deferred_shade.cu."""
    dev = gbuf.depth.device
    if dev.type == "cpu":
        return deferred_shade_reference(
            gbuf, extras, t_gbuf, t_extras, lights, bank, camera_position,
            atlas=atlas, batch=batch, shadow_state=shadow_state,
            gbuffer_planes=gbuffer_planes)

    f32, i32 = torch.float32, torch.int32
    check = kernels.check
    rows, cols = gbuf.depth.shape
    a = DeferredArgs()

    def plane(t, name, dt, width=None):
        shape = (rows, cols) if width is None else (rows, cols, width)
        check(t, name, dt, shape, dev)
        return t.data_ptr()

    spk = "shininess" in extras
    if spk != ("shininess" in t_extras):
        raise ValueError("one layer has a shininess plane and one not")
    for i, (g, ex) in enumerate(((gbuf, extras), (t_gbuf, t_extras))):
        layer = ("gbuf", "t_gbuf")[i]
        a.pos[i] = plane(g.position, f"{layer}.position", f32, 3)
        a.nrm[i] = plane(g.normal, f"{layer}.normal", f32, 3)
        a.alb[i] = plane(g.albedo, f"{layer}.albedo", f32, 3)
        a.mat[i] = plane(g.material, f"{layer}.material", i32)
        a.tri[i] = plane(g.tri_id, f"{layer}.tri_id", i32)
        a.depth[i] = plane(g.depth, f"{layer}.depth", f32)
        a.uv[i] = plane(ex["uv"], f"{layer} uv", f32, 2)
        a.emis[i] = plane(ex["emissive"], f"{layer} emissive", f32)
        a.spec[i] = plane(ex["specular"], f"{layer} specular", f32)
        a.shin[i] = (plane(ex["shininess"], f"{layer} shininess", f32)
                     if spk else None)
    a.t_alpha = plane(t_extras["alpha"], "t_gbuf alpha", f32)

    fields, (a.nd, a.np, a.ns) = _light_fields(lights, dev)
    for name, p in fields.items():
        setattr(a, name, p)
    if a.nd + a.np + a.ns > MAX_LIGHT_ROWS:
        raise ValueError(f"{a.nd + a.np + a.ns} light rows exceed the "
                         f"{MAX_LIGHT_ROWS} the default route's shading "
                         "kernel stages")
    cam = consts.on_device(camera_position, device=dev).reshape(3)
    check(cam, "camera_position", f32, (3,), dev)
    a.cam = cam.data_ptr()
    if bank.uniform_shininess() is None and not spk:
        raise ValueError("materials differ in shininess but the G-buffers "
                         "carry no shininess plane")
    a.shin_const = 0.0 if spk else float(bank.uniform_shininess())

    a.pcf_k = 1
    if shadow_state is not None:
        s, res = shadow_state.slots, shadow_state.resolution
        if s > MAX_SLOTS:
            raise ValueError(f"{s} shadow slots exceed the {MAX_SLOTS} the "
                             "default route's shading kernel reads")
        check(shadow_state.maps, "shadow maps", f32, (s, res, res), dev)
        check(shadow_state.light_mats, "light_mats", f32, (s, 4, 4), dev)
        check(shadow_state.slot_entity, "slot_entity", i32, (s,), dev)
        a.maps = shadow_state.maps.data_ptr()
        a.light_mats = shadow_state.light_mats.data_ptr()
        a.slot_entity = shadow_state.slot_entity.data_ptr()
        a.n_slots, a.res, a.pcf_k = s, res, shadow_state.pcf_scale

    if atlas is not None:
        n_mat = bank.mat_textures.shape[0]
        n_tex = atlas.num_textures
        nl, size = atlas.layers.shape[0], atlas.size
        check(bank.mat_textures, "bank.mat_textures", i32, (n_mat, 6), dev)
        check(atlas.tex_layer, "atlas.tex_layer", i32, (n_tex,), dev)
        check(atlas.uv_rect, "atlas.uv_rect", f32, (n_tex, 4), dev)
        check(atlas.layers, "atlas.layers", f32, (nl, size, size, 3), dev)
        a.mat_textures = bank.mat_textures.data_ptr()
        a.tex_layer = atlas.tex_layer.data_ptr()
        a.uv_rect = atlas.uv_rect.data_ptr()
        a.layers = atlas.layers.data_ptr()
        a.n_mat, a.n_tex, a.atlas_size = n_mat, n_tex, size
        a.with_spec = int(bank.has_specular_maps())
        a.with_emis = int(bank.has_emissive_maps())
        a.with_diss = int(bank.has_dissolve_maps())
        a.with_norm = int(bank.has_normal_maps())
        if a.with_norm:
            # the kernel takes the winner's tangent frame from its
            # positions and uvs (geometry.triangle_tangents), read in place
            n_tri = batch.budget
            for name, t, width in (("batch.world_pos", batch.world_pos, 3),
                                   ("batch.uv", batch.uv, 2)):
                _check_rows(t, name, (n_tri, 3, width), dev)
            a.tri_pos, a.tri_uv = (batch.world_pos.data_ptr(),
                                   batch.uv.data_ptr())
            a.pos_st, a.pos_sv = batch.world_pos.stride()[:2]
            a.uv_st, a.uv_sv = batch.uv.stride()[:2]
            a.n_tri = n_tri

    out = torch.empty((rows, cols, PACKED), dtype=f32, device=dev)
    a.out = out.data_ptr()
    textured = None
    if gbuffer_planes:
        planes = [torch.empty((rows, cols, 3), dtype=f32, device=dev)
                  for _ in range(4)]
        for i in range(2):
            a.alb_out[i] = planes[2 * i].data_ptr()
            a.nrm_out[i] = planes[2 * i + 1].data_ptr()
        textured = tuple(dataclasses.replace(g, albedo=planes[2 * i],
                                             normal=planes[2 * i + 1])
                         for i, g in enumerate((gbuf, t_gbuf)))
    a.rows, a.cols = rows, cols
    kernels.launch("launch_deferred_shade", "deferred_shade",
                   ctypes.byref(a), kernels.stream_ptr(dev))
    return out, textured
