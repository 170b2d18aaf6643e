"""The custom-shading hook's G-buffer, ``render/custom_gbuffer.py``, on the
CPU, where ``custom_gbuffer`` runs its plain version
(``custom_gbuffer_reference``); the kernel, csrc/custom_gbuffer.cu, is held
to that version on the card by ``chip_smoke.py`` (phase 8).

The scene: tests/deferred_scenes.py's "featured" frame at 200x44 (two tile
columns, the last 72 pixels wide, and a last tile row 4 rows high, so
partial tiles hold pixels outside the image) on the fused route, with a
shading system over the cubes (an albedo map and a normal map) and the
glass pane (a dissolve map, so K3 textures the transparent layer) and an
unshaded one over the emissive star.

* On every owned pixel the plain version's planes equal the hook's chain
  as it stood before the kernel (K2 over every tile,
  ``_gbuffer_from_channels``, the albedo and normal-map taps,
  ``tri_sys[winner]``), textured and not, with and without normal maps,
  on the opaque and the transparent layer, at ``y_off`` 0 and a band's.
* Every other pixel holds the fixed values, and the system plane is the
  chain's everywhere.
* A frame shaded from these planes equals, to the bit, the frame shaded
  from the unmasked chain.
* The counting helper gives the owned tiles on the kernel route and every
  tile on the plain route.
* ``CompiledSystems.sys_shaded``; nothing is launched on the CPU; the
  wrapper's checks (meta tensors reach them, as a card's would); the ctypes
  ``CustomArgs`` against the C struct's offsets from g++.
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest
import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.render import custom_gbuffer as CG
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import raster_pallas as RPT
from render_engine_tpu_torch.render import render_system as RST
from render_engine_tpu_torch.render.geometry import perturb_normal
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT
from render_engine_tpu_torch.render.textures import sample_atlas
from render_engine_tpu_torch.runtime import profiling as P

import c_struct_layout
import deferred_scenes as DSC
from test_torch_frame import RASTER
from torch_threads import one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc",
                    "custom_gbuffer.cu")
WIDTH, HEIGHT = 200, 44
BAND_Y_OFF, BAND_H_TOTAL = 24.0, 96  # a band of rows 24 to 67 of 96


def tint(sp):
    """A shading function that reads every plane of ``ShadeParam``."""
    mat = (sp.material.to(torch.float32) + 1.0)[..., None] * 0.1
    return (0.5 * sp.base_color + 0.2 * sp.albedo * (sp.normal + 1.0)
            + 0.001 * sp.position + mat
            + 0.05 * sp.depth[..., None]).clamp(0.0, 1.0)


def _scene(shade=tint):
    w, bank, cam, atlas = DSC.featured(DSC.torch_packages(),
                                       aspect=WIDTH / HEIGHT)
    cube, star, pane = 0, 1, 2
    systems = RST.compile_systems((
        RST.RenderSystemBuilder("shaded").with_models(cube, pane)
        .with_fragment_shading(shade).build(),
        RST.RenderSystemBuilder("glow").with_models(star).build()), bank)
    settings = FT.RenderSettings(width=WIDTH, height=HEIGHT, max_tris=256,
                                 fused_shading=True, raster=RCT(**RASTER),
                                 max_point_lights=4)
    return dict(world=w, camera=cam, bank=bank, settings=settings,
                atlas=atlas, systems=systems)


def _render(sc):
    return FT.render_frame(sc["world"], sc["camera"], sc["bank"],
                           sc["settings"], atlas=sc["atlas"],
                           systems=sc["systems"])


@pytest.fixture(scope="module")
def call():
    """The frame's ``custom_gbuffer`` call: its arguments and result."""
    sc = _scene()
    calls = []
    real = CG.custom_gbuffer

    def keep(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    CG.custom_gbuffer = keep
    try:
        _render(sc)
    finally:
        CG.custom_gbuffer = real
    (c,) = calls
    return c


class _NoNormalMaps:
    """A bank whose materials carry no normal map."""

    def __init__(self, bank):
        self._bank = bank
        self.mat_textures = bank.mat_textures.clone()
        self.mat_textures[:, 3] = -1

    @property
    def mat_texture_norm(self):
        return self.mat_textures[:, 3]

    def has_normal_maps(self):
        return False

    def __getattr__(self, name):
        return getattr(self._bank, name)


def chain(slot, depth, winner, textured, rows, tri_sys, inv_pv, bank, atlas,
          *, tiles_x, width, h_total, y_off):
    """One layer's G-buffer and system plane as the hook formed them before
    the kernel, on every pixel."""
    nt, th, twd = slot.shape
    res = RPT.resolve_attributes_pallas(slot, rows)
    ch = res.reshape(res.shape[0], nt * th, twd)
    d_t = depth.reshape(nt * th, twd)
    wn_t = winner.reshape(nt * th, twd)
    px, py = RPT._tall_pixel_centers(torch.arange(nt), tiles_x, th, twd)
    gbuf, extras = RPT._gbuffer_from_channels(
        ch, d_t, wn_t, h_total, width, inv_pv, px=px, py=py,
        ndc_py=py + float(y_off))
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
    px_sys = tri_sys[wn_t.clamp(0, tri_sys.shape[0] - 1).long()]
    return gbuf, px_sys


def _owned(px_sys, winner, sys_shaded, kw):
    nt, th, tw = winner.shape
    inside = CG.inside_image(nt, kw["tiles_x"], th, tw, kw["width"],
                             kw["h_local"], winner.device)
    return CG.owned_pixels(px_sys, winner.reshape(nt * th, tw), sys_shaded,
                           inside)


PLANES = ("position", "normal", "albedo", "material")


@pytest.mark.parametrize("band", [False, True], ids=["y_off_0", "band"])
@pytest.mark.parametrize("normal_maps", [True, False],
                         ids=["normal_maps", "no_normal_maps"])
@pytest.mark.parametrize("textured", [True, False],
                         ids=["textured", "untextured"])
@pytest.mark.parametrize("layer", [0, 1], ids=["opaque", "transparent"])
def test_owned_pixels_are_the_chains(call, layer, textured, normal_maps,
                                     band):
    a, kw, _ = call
    layers, rows, tri_sys, sys_shaded, inv_pv, bank, atlas = a
    if not normal_maps:
        bank = _NoNormalMaps(bank)
    if band:
        kw = dict(kw, y_off=BAND_Y_OFF, h_total=BAND_H_TOTAL)
    layers = tuple((s, d, w, textured) for s, d, w, _ in layers)
    got, px_sys = CG.custom_gbuffer(layers, rows, tri_sys, sys_shaded,
                                    inv_pv, bank, atlas, **kw)[layer]
    want, want_sys = chain(*layers[layer], rows, tri_sys, inv_pv, bank,
                           atlas, tiles_x=kw["tiles_x"], width=kw["width"],
                           h_total=kw["h_total"], y_off=kw["y_off"])
    own = _owned(want_sys, layers[layer][2], sys_shaded, kw)
    assert int(own.sum()) > 50
    assert torch.equal(px_sys, want_sys)
    for name in PLANES:
        assert torch.equal(getattr(got, name)[own],
                           getattr(want, name)[own]), name
    assert got.depth is not None and torch.equal(got.depth, want.depth)
    assert torch.equal(got.tri_id, want.tri_id)
    # the case is not vacuous: the maps and the band change owned pixels
    if layer == 0 and textured and normal_maps:
        plain = chain(*layers[0][:3], False, rows, tri_sys, inv_pv, bank,
                      atlas, tiles_x=kw["tiles_x"], width=kw["width"],
                      h_total=kw["h_total"], y_off=kw["y_off"])[0]
        assert not torch.equal(want.albedo[own], plain.albedo[own])
        assert not torch.equal(want.normal[own], plain.normal[own])
    if band:
        flat = chain(*layers[layer], rows, tri_sys, inv_pv, bank, atlas,
                     tiles_x=kw["tiles_x"], width=kw["width"],
                     h_total=HEIGHT, y_off=0.0)[0]
        assert not torch.equal(want.position[own], flat.position[own])


@pytest.mark.parametrize("layer", [0, 1], ids=["opaque", "transparent"])
def test_other_pixels_hold_the_fixed_values(call, layer):
    a, kw, out = call
    layers, _, _, sys_shaded, *_ = a
    gbuf, px_sys = out[layer]
    own = _owned(px_sys, layers[layer][2], sys_shaded, kw)
    covered = gbuf.tri_id >= 0
    # the unshaded star covers opaque pixels; partial tiles hold pixels
    # outside the image
    assert bool((covered & ~own).any()) == (layer == 0)
    nt, th, tw = layers[layer][0].shape
    inside = CG.inside_image(nt, kw["tiles_x"], th, tw, WIDTH, HEIGHT, "cpu")
    assert bool((~inside).any())
    for name in ("position", "normal", "albedo"):
        assert torch.equal(getattr(gbuf, name)[~own],
                           torch.zeros_like(getattr(gbuf, name)[~own]))
    assert bool((gbuf.material[~own] == -1).all())
    assert bool((gbuf.material[own] >= 0).all())


@pytest.mark.parametrize("shade", ["tint", "fog_rim"])
def test_the_frame_is_the_unmasked_chains(shade, monkeypatch):
    """Shaded from the masked planes or from the unmasked chain, the frame
    is the same to the bit."""
    from render_engine_tpu_torch.demo import user_systems as U

    fn = {"tint": tint, "fog_rim": U.fog_rim}[shade]
    sc = _scene(fn)
    if shade == "fog_rim":
        lit = dataclasses.replace(sc["systems"].src[0], uniforms=tuple(
            (k, v) for k, v in U.MATERIAL.items()))
        sc["systems"] = RST.compile_systems((lit, sc["systems"].src[1]),
                                            sc["bank"])
    masked = _render(sc)

    def unmasked(layers, rows, tri_sys, sys_shaded, inv_pv, bank, atlas,
                 *, h_local, **kw):
        return tuple(chain(*la, rows, tri_sys, inv_pv, bank, atlas, **kw)
                     for la in layers)

    monkeypatch.setattr(CG, "custom_gbuffer", unmasked)
    full = _render(sc)
    assert torch.equal(masked, full)
    sc["systems"] = RST.compile_systems(
        (dataclasses.replace(sc["systems"].src[0],
                             shade=lambda sp: sp.base_color),
         sc["systems"].src[1]), sc["bank"])
    assert not torch.equal(masked, _render(sc))  # the function shows


@pytest.mark.parametrize("kernel_route", [True, False],
                         ids=["kernel", "plain"])
def test_counting_helper(kernel_route):
    """Hand-made masks of 5 tiles: owned pixels in tiles 1 and 3."""
    nt, th, tw = 5, 2, 4
    owned = torch.zeros((nt * th, tw), dtype=torch.bool)
    owned[1 * th, 0] = owned[1 * th + 1, 3] = owned[3 * th, 2] = True
    marks = P.ProgramMarks(False, "frame")
    with marks.recording():
        FT._count_custom(owned, nt, kernel_route)
        FT._count_custom(owned[:, :1], nt, kernel_route)  # a second layer
    c = marks.counters()
    assert c["custom_tiles_owned"] == 2 + 1
    assert c["custom_pixels"] == 3 + 1
    assert c["custom_tiles_resolved"] == (3 if kernel_route else 2 * nt)


def test_sys_shaded_flags_the_shading_systems(call):
    _, bank, *_ = DSC.featured(DSC.torch_packages())
    b = RST.RenderSystemBuilder
    cs = RST.compile_systems((b("a").with_models(0).build(),
                              b("b").with_models(1).with_fragment_shading(
                                  tint).build(),
                              b("c").with_models(2).build()), bank)
    assert cs.sys_shaded.dtype == torch.int32
    assert cs.sys_shaded.tolist() == [0, 1, 0]
    assert RST.compile_systems((), bank).sys_shaded.tolist() == [0]
    # dataclasses.replace makes the flags anew from the new systems
    again = dataclasses.replace(cs, src=cs.src[1:])
    assert again.sys_shaded.tolist() == [1, 0]
    assert call[0][3].tolist() == [1, 0]


def test_no_launch_on_the_cpu():
    kernels.reset_launch_counts()
    _render(_scene())
    assert not any(kernels.LAUNCHES.values())


# ------------------------------------------------------ the argument checks
class _MetaBank:
    """A bank whose material texture table lies on the meta device."""

    def __init__(self, bank):
        self._bank = bank
        self.mat_textures = bank.mat_textures.to("meta")

    def __getattr__(self, name):
        return getattr(self._bank, name)


def _meta(x):
    if isinstance(x, torch.Tensor):
        return x.to("meta")
    if isinstance(x, tuple):
        return tuple(_meta(v) for v in x)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _meta(getattr(x, f.name)) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    return x


def _meta_call(call, **change):
    a, kw, _ = call
    a = [_MetaBank(x) if i == 5 else _meta(x) for i, x in enumerate(a)]
    for i, fn in change.items():
        a[int(i[1:])] = fn(a[int(i[1:])])
    return a, kw


def _in_layer(i, j, fn):
    return lambda layers: tuple(
        tuple(fn(v) if (li, vi) == (i, j) else v
              for vi, v in enumerate(la)) for li, la in enumerate(layers))


@pytest.mark.parametrize("change,error,match", [
    (dict(a0=_in_layer(0, 0, lambda t: t.long())), TypeError,
     "opaque slot"),
    (dict(a0=_in_layer(1, 2, lambda t: t[:-1])), ValueError,
     "transparent winner: shape"),
    (dict(a0=_in_layer(1, 1, lambda t: t.transpose(1, 2).contiguous()
                       .transpose(1, 2))), ValueError, "not contiguous"),
    (dict(a0=lambda layers: layers[:1]), ValueError, "1 layers"),
    (dict(a1=lambda t: t[..., :24]), ValueError, "channels"),
    (dict(a1=lambda t: t.double()), TypeError, "rows"),
    (dict(a2=lambda t: t.long()), TypeError, "tri_sys"),
    (dict(a3=lambda t: t.bool()), TypeError, "sys_shaded"),
    (dict(a4=lambda t: t[:3]), ValueError, "inv_pv"),
])
def test_wrapper_checks_raise(call, change, error, match):
    a, kw = _meta_call(call, **change)
    kernels.reset_launch_counts()
    with pytest.raises(error, match=match):
        CG.custom_gbuffer(*a, **kw)
    assert kernels.LAUNCHES["custom_gbuffer"] == 0


def test_wrapper_refuses_tiles_larger_than_a_block(call):
    a, kw = _meta_call(call)
    big = tuple((torch.empty((1, 16, 128), dtype=s.dtype, device="meta"),) * 3
                + (t,) for s, _, _, t in a[0])
    with pytest.raises(ValueError, match="threads"):
        CG.custom_gbuffer(big, *a[1:], **kw)


# ------------------------------------------------- the argument structure
def test_args_structure_matches_the_kernels():
    """g++'s offsetof of every field of the source's struct equals the
    ctypes structure's, and so do the sizes."""
    names, got, size = c_struct_layout.offsets(CSRC, "CustomArgs")
    assert [n for n, _ in CG.CustomArgs._fields_] == names
    offsets = [getattr(CG.CustomArgs, n).offset for n in names]
    assert got + [size] == offsets + [ctypes.sizeof(CG.CustomArgs)]
    assert np.all(np.diff(offsets) > 0)
