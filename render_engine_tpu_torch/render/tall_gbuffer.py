"""The default route's tall G-buffers: both layers' G-buffers and shading
planes on every pixel, from K1's planes and the candidate rows.

``raster_pallas.gbuffers_tall`` calls ``tall_gbuffer`` once a frame, after
K1's two-pass launch. For CUDA tensors it launches ``csrc/tall_gbuffer.cu``,
one thread per pixel of the tall layout of both layers, which reads each
covered pixel's winner row in place; for CPU tensors it runs
``tall_gbuffer_reference``, the plain version: per layer K2 over every tile
(``resolve_attributes_reference``), ``raster_pallas._gbuffer_from_channels``
and ``raster_pallas._shading_planes``. The JAX package leaves this route to
XLA, so the kernel replaces no Pallas kernel.

Where a layer is empty the planes hold the chain's values there: position,
normal, albedo and uv 0, ``MATERIAL_BACKGROUND``, emissive 0, alpha 1,
specular 1 and ``DEFAULT_SHININESS``. ``gbuffers_tall`` builds its rows
without the atlas (48 channels); the kernel takes rows of fewer than
``N_ATTR_NORM`` channels, whose plain version gives no tangent planes.

Output: ``(gbuf, extras, t_gbuf, t_extras)``, each ``GBuffer`` of (NT * th,
tw) planes (``depth`` and ``tri_id`` are views of the layer's K1 planes),
each ``extras`` holding ``uv``, ``emissive``, ``alpha``, ``specular`` and,
with packed (spec, Ns) rows, ``shininess``.
"""

from __future__ import annotations

import ctypes

import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.models.bank import DEFAULT_SHININESS
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render.gbuffer import GBuffer
from render_engine_tpu_torch.runtime import profiling as P

MAX_TILE_PIXELS = 1024  # one block a tile, one thread a pixel (csrc kMaxTile)
_P2 = ctypes.c_void_p * 2  # a pointer of each layer


def tall_gbuffer_reference(layers, rows, inv_pv, *, tiles_x, width, height,
                           spec_packed):
    """The plain version, on any device: ``tall_gbuffer``'s result."""
    nt, th, tw = layers[0][0].shape
    px, py = RP._tall_pixel_centers(torch.arange(nt, device=rows.device),
                                    tiles_x, th, tw)
    out = []
    for slot, depth, winner in layers:
        res = RP.resolve_attributes_reference(slot, rows)
        ch = res.reshape(res.shape[0], nt * th, tw)
        wn = winner.reshape(nt * th, tw)
        gbuf, extras = RP._gbuffer_from_channels(
            ch, depth.reshape(nt * th, tw), wn, height, width, inv_pv, px=px,
            py=py)
        out += [gbuf, {**extras, **RP._shading_planes(ch, wn, spec_packed)}]
    return tuple(out)


class TallArgs(ctypes.Structure):
    """csrc/tall_gbuffer.cu's ``TallArgs``, field for field."""
    _fields_ = [(n, _P2) for n in ("slot", "winner", "depth")] \
        + [(n, ctypes.c_void_p) for n in ("rows", "inv_pv")] \
        + [(n, _P2) for n in ("pos", "nrm", "alb", "mat", "uv", "emis",
                              "alpha", "spec", "shin")] \
        + [(n, ctypes.c_int) for n in (
            "nt", "th", "tw", "tiles_x", "k", "a", "width", "height",
            "ipv_s0", "ipv_s1", "spec_packed")] \
        + [("shin_default", ctypes.c_float)]


def tall_gbuffer(layers, rows, inv_pv, *, tiles_x, width, height,
                 spec_packed):
    """Both layers' tall G-buffers and shading planes (module docstring).

    ``layers``: ``(slot, depth, winner)`` of the opaque and the transparent
    layer, K1's (NT, th, tw) planes; ``rows`` (NT, K, A) the candidate
    rows; ``inv_pv`` (4, 4) inv(proj_view); ``width`` x ``height`` the
    image; ``spec_packed`` whether channel 34 holds packed (spec, Ns). CPU
    tensors run the plain version; CUDA tensors launch
    csrc/tall_gbuffer.cu."""
    dev = rows.device
    kw = dict(tiles_x=tiles_x, width=width, height=height,
              spec_packed=spec_packed)
    if dev.type == "cpu":
        return tall_gbuffer_reference(layers, rows, inv_pv, **kw)

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
    if not 35 <= a < RP.N_ATTR_NORM:
        raise ValueError(f"rows of {a} channels: the kernel reads channels "
                         f"0 to 34 and writes no tangent planes (fewer than "
                         f"{RP.N_ATTR_NORM} channels)")
    check(rows, "rows", f32, (nt, k, a), dev)
    if inv_pv.device != dev or inv_pv.dtype != f32 or \
            tuple(inv_pv.shape) != (4, 4):
        raise ValueError(f"inv_pv: {inv_pv.dtype} {tuple(inv_pv.shape)} on "
                         f"{inv_pv.device}, expected float32 (4, 4) on {dev}")

    c = TallArgs()
    for i, (slot, depth, winner) in enumerate(layers):
        name = ("opaque", "transparent")[i]
        check(slot, f"{name} slot", i32, (nt, th, tw), dev)
        check(winner, f"{name} winner", i32, (nt, th, tw), dev)
        check(depth, f"{name} depth", f32, (nt, th, tw), dev)
        c.slot[i], c.winner[i], c.depth[i] = (
            slot.data_ptr(), winner.data_ptr(), depth.data_ptr())
    c.rows, c.inv_pv = rows.data_ptr(), inv_pv.data_ptr()
    c.ipv_s0, c.ipv_s1 = inv_pv.stride()

    planes = nt * th, tw

    def alloc(*rest, dtype=f32):
        return torch.empty((2, *planes, *rest), dtype=dtype, device=dev)

    out = dict(pos=alloc(3), nrm=alloc(3), alb=alloc(3), mat=alloc(dtype=i32),
               uv=alloc(2), emis=alloc(), alpha=alloc(), spec=alloc())
    if spec_packed:
        out["shin"] = alloc()
    for name, t in out.items():
        getattr(c, name)[:] = (t[0].data_ptr(), t[1].data_ptr())
    c.nt, c.th, c.tw, c.tiles_x, c.k, c.a = nt, th, tw, tiles_x, k, a
    c.width, c.height = width, height
    c.spec_packed, c.shin_default = int(spec_packed), DEFAULT_SHININESS
    kernels.launch("launch_tall_gbuffer", "tall_gbuffer", ctypes.byref(c),
                   kernels.stream_ptr(dev))
    result = []
    for i, (_, depth, winner) in enumerate(layers):
        gbuf = GBuffer(depth=depth.reshape(planes), position=out["pos"][i],
                       normal=out["nrm"][i], albedo=out["alb"][i],
                       material=out["mat"][i], tri_id=winner.reshape(planes))
        extras = {"uv": out["uv"][i], "emissive": out["emis"][i],
                  "alpha": out["alpha"][i], "specular": out["spec"][i]}
        if spec_packed:
            extras["shininess"] = out["shin"][i]
        result += [gbuf, extras]
    return tuple(result)


def count_resolved(winners, kernel_route):
    """``gbuffer_tiles_resolved`` of a traced program: the tiles of the
    layers' (NT, th, tw) ``winners`` in which a candidate row was read, on
    the kernel route those holding a covered pixel, on the plain route
    every tile (K2 over every tile). The layers' counts add up."""
    for wn in winners:
        nt = wn.shape[0]
        P.count("gbuffer_tiles_resolved",
                (wn.reshape(nt, -1) >= 0).any(dim=1).sum(dtype=torch.int64)
                if kernel_route else torch.full((), nt, dtype=torch.int64,
                                                device=wn.device))
