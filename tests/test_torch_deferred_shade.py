"""The default route's shading stage, ``render/deferred_shade.py``, on the
CPU, where ``deferred_shade`` runs its plain version
(``deferred_shade_reference``); tests/test_torch_default_route.py holds
the default-route frames of these scenes to the JAX package's.

* The packed rows the compose reads, on the scenes of
  tests/deferred_scenes.py: "featured" (every texture role, two shininess
  values); "lit" with six shadow slots (a directional light's map, a spot
  light's and four cube faces of a point light) at ``pcf_scale`` 1 and 3,
  32 and 44 rows high (not multiples of 3, with tiles 8 high, so the PCF
  blocks cross tile rows) and 128 and 200 wide (two tile columns in the
  tall layout), its light tables with dead rows of every kind; render
  systems with a fragment-shading function (the textured G-buffers come
  along). Colors 0 where a layer is empty, flags = opaque covered + 2 *
  (transparent covered and in front), the transparent alpha where that
  layer is in front.
* Every shadowed light shades pixels of its own; the dissolve map reaches
  the alpha.
* A ``shadow_factor`` callback takes the plain version on any device.
* The wrapper's argument checks (meta tensors reach them, as a card's
  would): a wrong dtype, shape or a non-contiguous plane raises, and so do
  too many shadow slots or light rows; nothing is launched.
  ``check_reach``, which the Engine asks on a card, refuses the same.
* ``LAUNCHES["deferred_shade"]`` stays 0 on the CPU.
* ``DeferredArgs`` (ctypes) lays out its fields as csrc/deferred_shade.cu's
  struct does (offsets from g++).
"""

import ctypes
import dataclasses
import os

import numpy as np
import pytest
import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.render import deferred_shade as DS
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import lighting as L
from render_engine_tpu_torch.render import render_system as RST
from render_engine_tpu_torch.render import shadows as SHT
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT

import c_struct_layout
import deferred_scenes as DSC
import test_torch_render_systems as TRS
from test_torch_frame import RASTER, TORCH_PK
from torch_threads import one_torch_thread  # noqa: F401

CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc",
                    "deferred_shade.cu")


# ------------------------------------------------------------ the scenes
def _default(width=128, height=32, **kw):
    return FT.RenderSettings(width=width, height=height, max_tris=256,
                             fused_shading=False, raster=RCT(**RASTER),
                             **kw)


def _featured():
    w, bank, cam, atlas = DSC.featured(TORCH_PK)
    return dict(world=w, camera=cam, bank=bank,
                settings=_default(max_point_lights=4), atlas=atlas)


def lit_maps(world, camera, bank, pcf_scale):
    """The lit scene's shadow state after LIT_SLOTS updates."""
    sh = SHT.create_shadow_state(resolution=64, budget=DSC.LIT_SLOTS,
                                 pcf_scale=pcf_scale)
    for _ in range(DSC.LIT_SLOTS):
        sh = SHT.render_shadow_map(sh, world, camera, bank, max_tris=256,
                                   raster_cfg=RCT(**RASTER))
    return sh


def _lit(pcf_scale, width, height, extra_points):
    """The lit scene with its six slots; ten point-light rows, so the
    shadowed head of four and a chunk of six."""
    w, bank, cam, atlas = DSC.lit(TORCH_PK, width / height, extra_points)
    sh = lit_maps(w, cam, bank, pcf_scale)
    assert sh.slot_entity.tolist() == [0, 1, 2, 2, 2, 2]
    return dict(world=w, camera=cam, bank=bank, atlas=atlas,
                settings=_default(width, height, max_point_lights=10),
                shadow_state=sh)


def _systems():
    wt, bt, ct, cube, star = TRS.scene(TRS.TORCH_PK)
    sys_t = RST.compile_systems((
        RST.RenderSystemBuilder("n").with_models(cube)
        .write_uniform("tone", 0.8).with_fragment_shading(TRS.fancy).build(),
        RST.RenderSystemBuilder("s").with_models(star).build()), bt)
    s = dataclasses.replace(TRS.settings(), fused_shading=False)
    return dict(world=wt, camera=ct, bank=bt, settings=s, systems=sys_t)


SCENES = {
    "featured": _featured,
    "shadows-k1": lambda: _lit(1, 128, 32, 7),
    "shadows-k3": lambda: _lit(3, 128, 32, 7),
    "shadows-k3-200x44": lambda: _lit(3, 200, 44, 2),
    "systems": _systems,
}


def _render(sc, **kw):
    args = dict(sc, **kw)
    return FT.render_frame(args.pop("world"), args.pop("camera"),
                           args.pop("bank"), args.pop("settings"), **args)


def _calls(sc, monkeypatch, **kw):
    """The frame and the ``deferred_shade`` calls it made, each
    ``(args, kwargs, (packed, textured))``."""
    calls = []
    real = DS.deferred_shade

    def keep(*a, **k):
        out = real(*a, **k)
        calls.append((a, k, out))
        return out

    monkeypatch.setattr(DS, "deferred_shade", keep)
    return _render(sc, **kw), calls


@pytest.mark.parametrize("name", list(SCENES))
def test_packed_rows_are_what_the_compose_reads(name, monkeypatch):
    sc = SCENES[name]()
    img, calls = _calls(sc, monkeypatch)
    assert len(calls) == 1
    (gbuf, _, t_gbuf, t_extras, *_), _, (packed, textured) = calls[0]
    assert packed.shape == gbuf.depth.shape + (DS.PACKED,)
    cov, t_cov = gbuf.tri_id >= 0, t_gbuf.tri_id >= 0
    front = t_cov & (t_gbuf.depth <= gbuf.depth)
    assert torch.equal(packed[..., 7], cov.float() + 2.0 * front.float())
    assert not packed[..., 0:3][~cov].any()
    assert not packed[..., 3:6][~t_cov].any()
    assert (packed[..., 0:3][cov].amax(dim=-1) > 0).all()
    alpha = packed[..., 6][front]
    assert ((alpha >= 0) & (alpha <= 1)).all()
    assert torch.equal(alpha, t_extras["alpha"][front]) == (
        name != "featured")  # the dissolve map multiplies it
    assert (textured is not None) == (name == "systems")
    assert float(img.max()) > 0.25
    if "shadow_state" in sc:  # the maps shade the frame
        assert not torch.equal(img, _render(sc, shadow_state=None))


def test_dead_light_rows_are_in_the_table():
    sc = SCENES["shadows-k3"]()
    s = sc["settings"]
    lights = L.extract_lights(sc["world"], max_dir=s.max_dir_lights,
                              max_point=s.max_point_lights,
                              max_spot=s.max_spot_lights)
    assert (int(lights.dir_count), lights.dir_direction.shape[0]) == (1, 4)
    assert (int(lights.pt_count), lights.pt_position.shape[0]) == (8, 10)
    assert (int(lights.sp_count), lights.sp_position.shape[0]) == (1, 16)
    # each shadowed light shades pixels of its own
    sh = sc["shadow_state"]
    bare = _render(sc, shadow_state=None)
    for ent in (0, 1, 2):
        keep = sh.slot_entity == ent
        one = dataclasses.replace(
            sh, maps=sh.maps[keep], light_mats=sh.light_mats[keep],
            slot_entity=sh.slot_entity[keep], slot_face=sh.slot_face[keep])
        assert not torch.equal(_render(sc, shadow_state=one), bare)
    assert (_render(sc) <= bare + 1e-6).all()


def test_transparent_layer_and_dissolve_reach_the_alpha(monkeypatch):
    _, calls = _calls(_featured(), monkeypatch)
    packed = calls[0][2][0]
    front = packed[..., 7] >= 2.0
    assert front.any()
    alpha = packed[..., 6][front]
    assert (alpha < 0.4).any() and (alpha > 0.0).all()


def test_a_shadow_callback_takes_the_plain_version(monkeypatch):
    sc = SCENES["shadows-k3"]()
    s = sc["settings"]

    def factor(kind, i, pos):  # shade the left half
        return torch.where(pos[..., 0:1] < 64.0, 0.5, 1.0)

    def no_kernel(*a, **kw):
        raise AssertionError("the kernel's wrapper ran with a callback")

    bare = _render(sc, shadow_state=None)
    monkeypatch.setattr(DS, "deferred_shade", no_kernel)
    got = FT.render_frame(sc["world"], sc["camera"], sc["bank"], s,
                          atlas=sc["atlas"], shadow_factor=factor)
    assert not torch.equal(got, bare)
    # a callback wins over the maps
    assert torch.equal(got, FT.render_frame(
        sc["world"], sc["camera"], sc["bank"], s, atlas=sc["atlas"],
        shadow_state=sc["shadow_state"], shadow_factor=factor))
    with pytest.raises(AssertionError, match="callback"):
        _render(sc)


def test_no_launch_on_the_cpu():
    kernels.reset_launch_counts()
    for build in SCENES.values():
        _render(build())
    assert kernels.LAUNCHES["deferred_shade"] == 0
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
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{
            f.name: _meta(getattr(x, f.name)) for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)})
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x


@pytest.fixture(scope="module")
def meta_call():
    """One default-route call's arguments (featured scene, with the six
    shadow slots of the lit scene's maps) moved to the meta device."""
    sc = _featured()
    calls = []
    real = DS.deferred_shade
    DS.deferred_shade = lambda *a, **kw: calls.append((a, kw)) or real(
        *a, **kw)
    try:
        _render(sc, shadow_state=SCENES["shadows-k3"]()["shadow_state"])
    finally:
        DS.deferred_shade = real
    (a, kw), = calls
    a = [_MetaBank(x) if i == 5 else _meta(x) for i, x in enumerate(a)]
    return a, {k: _meta(v) for k, v in kw.items()}


def _with(a, kw, what, value):
    a, kw = list(a), dict(kw)
    layer, field = what
    if layer in (0, 2):
        a[layer] = dataclasses.replace(a[layer], **{field: value(
            getattr(a[layer], field))})
    elif layer in (1, 3):
        a[layer] = dict(a[layer], **{field: value(a[layer][field])})
    elif layer == 4:
        a[4] = dataclasses.replace(a[4], **{field: value(getattr(a[4],
                                                                 field))})
    return a, kw


@pytest.mark.parametrize("what,value,error,match", [
    ((0, "position"), lambda t: t.double(), TypeError, "gbuf.position"),
    ((2, "tri_id"), lambda t: t.long(), TypeError, "t_gbuf.tri_id"),
    ((1, "uv"), lambda t: t[..., :1], ValueError, "uv: shape"),
    ((3, "emissive"), lambda t: t[:-1], ValueError, "emissive: shape"),
    ((0, "normal"), lambda t: t.transpose(0, 1).contiguous().transpose(0, 1),
     ValueError, "not contiguous"),
    ((3, "alpha"), lambda t: t.t().contiguous().t(), ValueError,
     "not contiguous"),
    ((4, "pt_position"), lambda t: t.double(), TypeError, "pt_position"),
    ((4, "sp_count"), lambda t: t.reshape(1), ValueError, "sp_count"),
])
def test_wrapper_checks_raise(meta_call, what, value, error, match):
    a, kw = _with(*meta_call, what, value)
    kernels.reset_launch_counts()
    with pytest.raises(error, match=match):
        DS.deferred_shade(*a, **kw)
    assert kernels.LAUNCHES["deferred_shade"] == 0


def test_wrapper_refuses_more_slots_than_the_kernel_reads(meta_call):
    a, kw = meta_call
    sh = SHT.create_shadow_state(resolution=8, budget=DS.MAX_SLOTS + 1,
                                 device="meta")
    with pytest.raises(ValueError, match="shadow slots"):
        DS.deferred_shade(*a, **dict(kw, shadow_state=sh))


def test_wrapper_refuses_more_light_rows_than_the_kernel_stages(meta_call):
    a, kw = meta_call
    a = list(a)
    lights = a[4]
    n = DS.MAX_LIGHT_ROWS + 1 - (lights.dir_direction.shape[0]
                                 + lights.sp_position.shape[0])
    a[4] = dataclasses.replace(lights, **{
        f: torch.empty((n,) + getattr(lights, f).shape[1:],
                       dtype=getattr(lights, f).dtype, device="meta")
        for f in ("pt_position", "pt_diffuse", "pt_specular", "pt_ambient",
                  "pt_atten", "pt_radius", "pt_entity")})
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="light rows"):
        DS.deferred_shade(*a, **kw)
    assert kernels.LAUNCHES["deferred_shade"] == 0


def test_check_reach_refuses_what_the_kernel_cannot_shade():
    s = FT.RenderSettings()
    DS.check_reach(s, DS.MAX_SLOTS)
    with pytest.raises(ValueError, match="shadow slots"):
        DS.check_reach(s, DS.MAX_SLOTS + 1)
    wide = dataclasses.replace(
        s, max_point_lights=DS.MAX_LIGHT_ROWS - s.max_dir_lights
        - s.max_spot_lights + 1)
    with pytest.raises(ValueError, match="light rows"):
        DS.check_reach(wide, 0)
    # the fused route does not run the kernel
    fused = dataclasses.replace(wide, fused_shading=True)
    DS.check_reach(fused, DS.MAX_SLOTS + 1)


def test_wrapper_refuses_a_missing_shininess_plane(meta_call):
    a, kw = meta_call
    a = list(a)
    assert "shininess" in a[1]  # the featured scene's two exponents
    a[1] = {k: v for k, v in a[1].items() if k != "shininess"}
    with pytest.raises(ValueError, match="shininess plane"):
        DS.deferred_shade(*a, **kw)


# ------------------------------------------------- the argument structure
def test_args_structure_matches_the_kernels():
    """g++'s offsetof of every field of the source's struct equals the
    ctypes structure's, and so do the sizes."""
    names, got, size = c_struct_layout.offsets(CSRC, "DeferredArgs")
    assert [n for n, _ in DS.DeferredArgs._fields_] == names
    offsets = [getattr(DS.DeferredArgs, n).offset for n in names]
    assert got + [size] == offsets + [ctypes.sizeof(DS.DeferredArgs)]
    assert np.all(np.diff(offsets) > 0)
