"""The custom-shading hook's G-buffer on the fused route: both layers, and
only on the pixels a shading system owns.

``render/frame.py`` ``_fused_custom_shading`` calls ``custom_gbuffer`` once
a frame, when a render system has a fragment-shading function. For CUDA
tensors it launches ``csrc/custom_gbuffer.cu``, one thread per pixel of the
tall layout of both layers, which reads each owned pixel's winner row in
place; for CPU tensors it runs ``custom_gbuffer_reference``, the plain
version: per layer K2 over every tile (``resolve_attributes_reference``),
``raster_pallas._gbuffer_from_channels``, the material's albedo and normal
maps, the pixels' systems ``tri_sys[winner]``, then the fixed values on the
pixels that are not owned. The JAX package forms this G-buffer in XLA, so
the kernel replaces no Pallas kernel.

A pixel is owned (``owned_pixels``) when a triangle won it, it lies inside
the band's image, and the winner's system has a shading function
(``CompiledSystems.sys_shaded``). Elsewhere position, normal and albedo
are 0 and the material is ``MATERIAL_BACKGROUND``: ``shade_systems_color``
discards the function's output there, so those values change no pixel of
the image.

Output: for each layer ``(gbuf, px_sys)``, a ``GBuffer`` of (NT * th, tw)
planes (``depth`` and ``tri_id`` are views of the layer's depth and winner
planes) and the int32 per-pixel system plane.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render.gbuffer import (MATERIAL_BACKGROUND,
                                                    GBuffer)
from render_engine_tpu_torch.render.geometry import perturb_normal
from render_engine_tpu_torch.render.textures import sample_atlas

MAX_TILE_PIXELS = 1024  # one block a tile, one thread a pixel (csrc kMaxTile)
_P2 = ctypes.c_void_p * 2  # a pointer of each layer


def inside_image(nt, tiles_x, th, tw, width, rows, device):
    """(NT * th, tw) bool: the tall layout's pixels inside the band's image
    of ``width`` columns and ``rows`` rows."""
    px, py = RP._tall_pixel_centers(torch.arange(nt, device=device), tiles_x,
                                    th, tw)
    return (px < width) & (py < rows)


def owned_pixels(px_sys, winner, sys_shaded, inside):
    """The pixels a shading system owns: covered, ``inside`` the image and
    won by a triangle of a system with a shading function."""
    n = sys_shaded.shape[0]
    shading = sys_shaded[px_sys.clamp(0, n - 1).long()] != 0
    return (winner >= 0) & inside & (px_sys >= 0) & (px_sys < n) & shading


def _layer_chain(slot, depth, winner, textured, rows, inv_pv, bank, atlas,
                 px, py, *, width, h_total, y_off):
    """One layer's G-buffer on every pixel, as the hook formed it before
    the kernel: K2 over every tile, the G-buffer from its channels and,
    where ``textured``, the material's albedo and normal maps. Returns
    ``(gbuf, uv)``."""
    nt, th, tw = slot.shape
    res = RP.resolve_attributes_reference(slot, rows)
    ch = res.reshape(res.shape[0], nt * th, tw)
    gbuf, extras = RP._gbuffer_from_channels(
        ch, depth.reshape(nt * th, tw), winner.reshape(nt * th, tw), h_total,
        width, inv_pv, px=px, py=py, ndc_py=py + float(y_off))
    if atlas is not None and textured:
        mat_safe = gbuf.material.clamp(0, bank.mat_textures.shape[0]
                                       - 1).long()
        layer = bank.mat_texture[mat_safe]
        tex = sample_atlas(atlas, layer, extras["uv"])
        normal = gbuf.normal
        if bank.has_normal_maps():
            nlayer = bank.mat_texture_norm[mat_safe]
            nsamp = sample_atlas(atlas, nlayer, extras["uv"])
            pert = perturb_normal(gbuf.normal, extras["tangent"],
                                  extras["tangent_w"], nsamp)
            normal = torch.where((nlayer >= 0)[..., None], pert, gbuf.normal)
        gbuf = dataclasses.replace(
            gbuf, normal=normal,
            albedo=torch.where((layer >= 0)[..., None], tex, gbuf.albedo))
    return gbuf, extras["uv"]


def custom_gbuffer_reference(layers, rows, tri_sys, sys_shaded, inv_pv, bank,
                             atlas=None, *, tiles_x, width, h_total, h_local,
                             y_off):
    """The plain version, on any device: ``custom_gbuffer``'s result."""
    nt, th, tw = layers[0][0].shape
    dev = rows.device
    px, py = RP._tall_pixel_centers(torch.arange(nt, device=dev), tiles_x,
                                    th, tw)
    inside = inside_image(nt, tiles_x, th, tw, width, h_local, dev)
    out = []
    for slot, depth, winner, textured in layers:
        gbuf, _ = _layer_chain(slot, depth, winner, textured, rows, inv_pv,
                               bank, atlas, px, py, width=width,
                               h_total=h_total, y_off=y_off)
        wn = gbuf.tri_id
        px_sys = tri_sys[wn.clamp(0, tri_sys.shape[0] - 1).long()]
        own = owned_pixels(px_sys, wn, sys_shaded, inside)
        om = own[..., None]
        gbuf = dataclasses.replace(
            gbuf, position=torch.where(om, gbuf.position, 0.0),
            normal=torch.where(om, gbuf.normal, 0.0),
            albedo=torch.where(om, gbuf.albedo, 0.0),
            material=torch.where(own, gbuf.material, MATERIAL_BACKGROUND))
        out.append((gbuf, px_sys))
    return tuple(out)


class CustomArgs(ctypes.Structure):
    """csrc/custom_gbuffer.cu's ``CustomArgs``, field for field."""
    _fields_ = [(n, _P2) for n in ("slot", "winner", "depth")] \
        + [(n, ctypes.c_void_p) for n in (
            "rows", "tri_sys", "sys_shaded", "inv_pv", "mat_textures",
            "tex_layer", "uv_rect", "layers")] \
        + [(n, _P2) for n in ("pos", "nrm", "alb", "mat", "px_sys")] \
        + [(n, ctypes.c_int) for n in (
            "nt", "th", "tw", "tiles_x", "k", "a", "width", "h_total",
            "rows_in", "n_tri", "n_sys", "n_mat", "n_tex", "atlas_size",
            "ipv_s0", "ipv_s1", "with_norm")] \
        + [("textured", ctypes.c_int * 2), ("y_off", ctypes.c_float)]


def custom_gbuffer(layers, rows, tri_sys, sys_shaded, inv_pv, bank,
                   atlas=None, *, tiles_x, width, h_total, h_local, y_off):
    """Both layers' G-buffers for the custom-shading hook: a tuple of
    ``(gbuf, px_sys)``, opaque then transparent (module docstring).

    ``layers``: ``(slot, depth, winner, textured)`` of each layer, the
    (NT, th, tw) planes of K1 and whether the layer takes the atlas;
    ``rows`` (NT, K, A) the candidate rows; ``tri_sys`` (T,) int32 each
    triangle's system; ``sys_shaded`` (S,) int32; ``inv_pv`` (4, 4);
    ``width`` x ``h_total`` the whole image, the band's ``h_local`` rows
    from image row ``y_off``. CPU tensors run the plain version; CUDA
    tensors launch csrc/custom_gbuffer.cu."""
    dev = rows.device
    kw = dict(tiles_x=tiles_x, width=width, h_total=h_total, h_local=h_local,
              y_off=y_off)
    if dev.type == "cpu":
        return custom_gbuffer_reference(layers, rows, tri_sys, sys_shaded,
                                        inv_pv, bank, atlas, **kw)

    f32, i32 = torch.float32, torch.int32
    check = kernels.check
    if len(layers) != 2:
        raise ValueError(f"{len(layers)} layers, expected the opaque and the "
                         "transparent one")
    nt, th, tw = layers[0][0].shape
    if th * tw > MAX_TILE_PIXELS:
        raise ValueError(f"tiles of {th}x{tw} pixels exceed the "
                         f"{MAX_TILE_PIXELS} threads of the kernel's block")
    _, k, a = rows.shape
    with_norm = atlas is not None and bank.has_normal_maps()
    if a < (RP.N_ATTR_NORM if with_norm else 32):
        raise ValueError(f"rows of {a} channels lack the channels the "
                         "kernel reads")
    check(rows, "rows", f32, (nt, k, a), dev)
    n_tri, n_sys = tri_sys.shape[0], sys_shaded.shape[0]
    check(tri_sys, "tri_sys", i32, (n_tri,), dev)
    check(sys_shaded, "sys_shaded", i32, (n_sys,), dev)
    if n_tri < 1 or n_sys < 1:
        raise ValueError("no triangle or no system to look up")
    if inv_pv.device != dev or inv_pv.dtype != f32 or \
            tuple(inv_pv.shape) != (4, 4):
        raise ValueError(f"inv_pv: {inv_pv.dtype} {tuple(inv_pv.shape)} on "
                         f"{inv_pv.device}, expected float32 (4, 4) on {dev}")

    c = CustomArgs()
    for i, (slot, depth, winner, textured) in enumerate(layers):
        name = ("opaque", "transparent")[i]
        check(slot, f"{name} slot", i32, (nt, th, tw), dev)
        check(winner, f"{name} winner", i32, (nt, th, tw), dev)
        check(depth, f"{name} depth", f32, (nt, th, tw), dev)
        c.slot[i], c.winner[i], c.depth[i] = (
            slot.data_ptr(), winner.data_ptr(), depth.data_ptr())
        c.textured[i] = int(atlas is not None and bool(textured))
    c.rows, c.tri_sys, c.sys_shaded = (rows.data_ptr(), tri_sys.data_ptr(),
                                       sys_shaded.data_ptr())
    c.inv_pv = inv_pv.data_ptr()
    c.ipv_s0, c.ipv_s1 = inv_pv.stride()
    if atlas is not None:
        n_mat, n_tex = bank.mat_textures.shape[0], atlas.num_textures
        nl, size = atlas.layers.shape[0], atlas.size
        check(bank.mat_textures, "bank.mat_textures", i32, (n_mat, 6), dev)
        check(atlas.tex_layer, "atlas.tex_layer", i32, (n_tex,), dev)
        check(atlas.uv_rect, "atlas.uv_rect", f32, (n_tex, 4), dev)
        check(atlas.layers, "atlas.layers", f32, (nl, size, size, 3), dev)
        c.mat_textures = bank.mat_textures.data_ptr()
        c.tex_layer, c.uv_rect = (atlas.tex_layer.data_ptr(),
                                  atlas.uv_rect.data_ptr())
        c.layers = atlas.layers.data_ptr()
        c.n_mat, c.n_tex, c.atlas_size = n_mat, n_tex, size
        c.with_norm = int(with_norm)

    planes = nt * th, tw
    pos, nrm, alb = (torch.empty((2, *planes, 3), dtype=f32, device=dev)
                     for _ in range(3))
    mat, px_sys = (torch.empty((2, *planes), dtype=i32, device=dev)
                   for _ in range(2))
    for i in range(2):
        c.pos[i], c.nrm[i], c.alb[i] = (pos[i].data_ptr(), nrm[i].data_ptr(),
                                        alb[i].data_ptr())
        c.mat[i], c.px_sys[i] = mat[i].data_ptr(), px_sys[i].data_ptr()
    c.nt, c.th, c.tw, c.tiles_x, c.k, c.a = nt, th, tw, tiles_x, k, a
    c.width, c.h_total, c.rows_in = width, h_total, h_local
    c.n_tri, c.n_sys, c.y_off = n_tri, n_sys, float(y_off)
    kernels.launch("launch_custom_gbuffer", "custom_gbuffer",
                   ctypes.byref(c), kernels.stream_ptr(dev))
    return tuple(
        (GBuffer(depth=depth.reshape(planes), position=pos[i],
                 normal=nrm[i], albedo=alb[i], material=mat[i],
                 tri_id=winner.reshape(planes)), px_sys[i])
        for i, (_, depth, winner, _) in enumerate(layers))
