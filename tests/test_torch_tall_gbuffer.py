"""The default route's tall G-buffers, ``render/tall_gbuffer.py``, on the
CPU, where ``tall_gbuffer`` runs its plain version
(``tall_gbuffer_reference``); the kernel, csrc/tall_gbuffer.cu, is held to
that version on the card by ``chip_smoke.py`` (phase 16).

The scene: tests/deferred_scenes.py's "featured" frame at 200x44 (two tile
columns, the last 72 pixels wide, and a last tile row 4 rows high) on the
default route; both layers are covered (the cubes and the star, the glass
pane).

* The planes of both layers equal, on every pixel and under every key,
  the chain ``raster_pallas.gbuffers_tall`` ran before the kernel (K2 over
  every tile, ``_gbuffer_from_channels``, ``_shading_planes``), with
  uniform and packed shininess and rows of 48 and 56 channels; where a
  layer is empty they hold the fixed values the kernel writes there.
* The frame's own call, and ``gbuffers_tall``'s result, are that chain's.
* The counting helper gives the tiles holding a covered pixel on the
  kernel route and every tile on the plain route; a traced frame keeps
  the count apart from the drop counters.
* Nothing is launched on the CPU; the wrapper's checks (meta tensors reach
  them, as a card's would); the ctypes ``TallArgs`` against the C struct's
  offsets from g++; the kernel's name holds none of the benchmark's kernel
  rows' profiler names.
"""

import ctypes
import dataclasses
import glob
import os
import re

import numpy as np
import pytest
import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.demo.space_scene import build_space_engine
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.render import frame as FT
from render_engine_tpu_torch.render import raster_pallas as RPT
from render_engine_tpu_torch.render import tall_gbuffer as TG
from render_engine_tpu_torch.render.raster_jnp import RasterConfig as RCT
from render_engine_tpu_torch.runtime import profiling as P

import c_struct_layout
import deferred_scenes as DSC
from test_torch_frame import RASTER
from torch_threads import one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(os.path.dirname(kernels.__file__), "csrc")
WIDTH, HEIGHT = 200, 44
SMALL = dict(width=128, height=32, capacity=128, num_asteroids=10,
             max_tris=2048)
# where a layer is empty: the chain's values (K2 reads zeros there)
EMPTY = {"position": 0.0, "normal": 0.0, "albedo": 0.0, "material": -1,
         "uv": 0.0, "emissive": 0.0, "alpha": 1.0, "specular": 1.0,
         "shininess": 64.0}


class _UniformShininess:
    """A bank whose materials share one specular exponent."""

    def __init__(self, bank):
        self._bank = bank

    def uniform_shininess(self):
        return 32.0

    def __getattr__(self, name):
        return getattr(self._bank, name)


def _settings():
    return FT.RenderSettings(width=WIDTH, height=HEIGHT, max_tris=256,
                             fused_shading=False, raster=RCT(**RASTER),
                             max_point_lights=4)


@pytest.fixture(scope="module")
def scene():
    w, bank, cam, atlas = DSC.featured(DSC.torch_packages(),
                                       aspect=WIDTH / HEIGHT)
    return dict(world=w, bank=bank, camera=cam, atlas=atlas)


@pytest.fixture(scope="module")
def inputs(scene):
    """``(layers, rows, inv_pv, kw)`` of the tall G-buffers of the scene's
    frame for each (shininess, channels): K1's planes of both layers and
    the candidate rows, ``_packed_tri_table`` with the atlas cut to the
    channels."""
    s = _settings()
    cfg = s.raster
    batch = FT.frame_inputs(scene["world"], scene["camera"], scene["bank"],
                            s)["batch"]
    tiles_x, tiles_y = -(-WIDTH // cfg.tile_w), -(-HEIGHT // cfg.tile_h)
    tri_class = RPT._tri_class(batch)
    cand, counts = RPT._candidate_table(batch, cfg, tiles_x, tiles_y,
                                        tri_class)
    d, w, sl, td, tw_, ts = RPT._launch(batch, HEIGHT, WIDTH, cfg, tri_class,
                                        two_pass=True, cand=cand,
                                        counts=counts)
    inv_pv = T.inv44(scene["camera"].proj_view())
    out = {}
    for shin in ("uniform", "packed"):
        bank = scene["bank"]
        if shin == "uniform":
            bank = _UniformShininess(bank)
        table = RPT._packed_tri_table(batch, bank, tri_class,
                                      atlas=scene["atlas"])
        assert table.shape[1] == RPT.N_ATTR_NORM
        for a in (RPT.N_ATTR_BASE, RPT.N_ATTR):
            rows = RPT._gather_candidate_rows(table[:, :a].contiguous(),
                                              cand)
            out[shin, a] = (((sl, d, w), (ts, td, tw_)), rows, inv_pv,
                            dict(tiles_x=tiles_x, width=WIDTH, height=HEIGHT,
                                 spec_packed=shin == "packed"))
    return out


def chain(layers, rows, inv_pv, *, tiles_x, width, height, spec_packed):
    """Both layers' planes as ``gbuffers_tall`` formed them before the
    kernel: K2 over every tile, the G-buffer and the shading planes from
    its channels."""
    nt, th, tw = layers[0][0].shape
    px, py = RPT._tall_pixel_centers(torch.arange(nt), tiles_x, th, tw)
    out = []
    for slot, depth, winner in layers:
        ch = RPT.resolve_attributes_pallas(slot, rows).reshape(-1, nt * th,
                                                                tw)
        wn = winner.reshape(nt * th, tw)
        gbuf, extras = RPT._gbuffer_from_channels(
            ch, depth.reshape(nt * th, tw), wn, height, width, inv_pv, px=px,
            py=py)
        out += [gbuf, {**extras, **RPT._shading_planes(ch, wn, spec_packed)}]
    return tuple(out)


def _planes(gbuf, extras):
    """Every plane of a layer by name, the G-buffer's first."""
    return {**{f.name: getattr(gbuf, f.name)
               for f in dataclasses.fields(gbuf)}, **extras}


def _assert_same(got, want):
    for g, w in zip(got, want):
        if isinstance(w, dict):
            assert list(g) == list(w)
            for k in w:
                assert g[k].dtype == w[k].dtype, k
                assert torch.equal(g[k], w[k]), k
        else:
            for f in dataclasses.fields(w):
                assert torch.equal(getattr(g, f.name),
                                   getattr(w, f.name)), f.name


@pytest.mark.parametrize("channels", [RPT.N_ATTR_BASE, RPT.N_ATTR])
@pytest.mark.parametrize("shininess", ["uniform", "packed"])
@pytest.mark.parametrize("layer", [0, 1], ids=["opaque", "transparent"])
def test_planes_are_the_chains(inputs, layer, shininess, channels):
    layers, rows, inv_pv, kw = inputs[shininess, channels]
    kernels.reset_launch_counts()
    got = TG.tall_gbuffer(layers, rows, inv_pv, **kw)
    assert not any(kernels.LAUNCHES.values())
    want = chain(layers, rows, inv_pv, **kw)
    g, w = got[2 * layer:2 * layer + 2], want[2 * layer:2 * layer + 2]
    _assert_same(g, w)
    keys = {"uv", "emissive", "alpha", "specular"}
    keys |= {"shininess"} if shininess == "packed" else set()
    assert set(g[1]) == keys
    # the kernel's fixed values where the layer is empty, its rows read
    # only where it is covered
    slot, _, winner = layers[layer]
    assert torch.equal(winner >= 0, slot >= 0)
    planes = _planes(*g)
    empty = planes["tri_id"] < 0
    covered = ~empty
    assert int(covered.sum()) > 50 and bool(empty.any())
    for name, value in EMPTY.items():
        if name in planes:
            v = planes[name][empty]
            assert torch.equal(v, torch.full_like(v, value)), name
    # the case is not vacuous: the rows' channels reach the planes
    for name in ("position", "normal", "albedo", "uv"):
        assert bool((planes[name][covered] != 0).any()), name
    if layer == 0:
        assert bool((planes["specular"][covered] != 1).any())
        if shininess == "packed":
            assert bool((planes["shininess"][covered] != 64).any())


def test_partial_tiles_and_both_layers_are_covered(inputs):
    """The last tile column is 72 pixels wide and the last tile row 4 rows
    high, so tiles hold pixels outside the image; both layers are
    covered."""
    layers, _, _, kw = inputs["packed", RPT.N_ATTR_BASE]
    nt, th, tw = layers[0][0].shape
    assert (kw["tiles_x"] * tw, -(-HEIGHT // th) * th) == (256, 48)
    px, py = RPT._tall_pixel_centers(torch.arange(nt), kw["tiles_x"], th, tw)
    assert bool(((px > WIDTH) | (py > HEIGHT)).any())
    for _, _, winner in layers:
        assert bool((winner >= 0).any())


@pytest.fixture(scope="module")
def call(scene):
    """The default-route frame's ``tall_gbuffer`` call: its arguments and
    result."""
    calls = []
    real = TG.tall_gbuffer

    def keep(*a, **kw):
        out = real(*a, **kw)
        calls.append((a, kw, out))
        return out

    TG.tall_gbuffer = keep
    try:
        kernels.reset_launch_counts()
        FT.render_frame(scene["world"], scene["camera"], scene["bank"],
                        _settings(), atlas=scene["atlas"])
        assert not any(kernels.LAUNCHES.values())
    finally:
        TG.tall_gbuffer = real
    (c,) = calls
    return c


def test_the_frames_call_is_the_chains(call):
    a, kw, out = call
    _assert_same(out, chain(*a, **kw))
    assert kw["spec_packed"] and a[1].shape[2] == RPT.N_ATTR_BASE
    assert "shininess" in out[1] and "shininess" in out[3]


def test_render_gbuffers_untiles_the_wrappers_planes(scene, call,
                                                    monkeypatch):
    """``render_gbuffers_pallas`` goes through the wrapper once and
    untiles its planes to the image."""
    calls = []
    real = TG.tall_gbuffer

    def spy(*a, **kw):
        calls.append(real(*a, **kw))
        return calls[-1]

    monkeypatch.setattr(TG, "tall_gbuffer", spy)
    s = _settings()
    batch = FT.frame_inputs(scene["world"], scene["camera"], scene["bank"],
                            s)["batch"]
    got = RPT.render_gbuffers_pallas(batch, scene["bank"], HEIGHT, WIDTH,
                                     s.raster,
                                     proj_view=scene["camera"].proj_view())
    (tall,) = calls
    _assert_same(tall, call[2])  # the frame's own planes
    th, tw = s.raster.tile_h, s.raster.tile_w
    tiles = (-(-HEIGHT // th), -(-WIDTH // tw), th, tw, HEIGHT, WIDTH)
    for g, t in zip(got, tall):
        for name, plane in _planes(g, {}).items() if not isinstance(
                g, dict) else g.items():
            want = getattr(t, name) if not isinstance(t, dict) else t[name]
            assert torch.equal(plane, RPT._untile_tall(want, *tiles)), name


# ------------------------------------------------------------ the counter
@pytest.mark.parametrize("kernel_route", [True, False],
                         ids=["kernel", "plain"])
def test_counting_helper(kernel_route):
    """Hand-made winner planes of 5 tiles: covered pixels in tiles 1 and 3
    of the opaque layer, tile 4 of the transparent one."""
    nt, th, tw = 5, 2, 4
    opaque = torch.full((nt, th, tw), -1, dtype=torch.int32)
    trans = opaque.clone()
    opaque[1, 0, 0] = opaque[1, 1, 3] = opaque[3, 0, 2] = 7
    trans[4, 1, 1] = 2
    marks = P.ProgramMarks(False, "frame")
    with marks.recording():
        TG.count_resolved((opaque, trans), kernel_route)
    assert marks.counters() == {
        "gbuffer_tiles_resolved": 3 if kernel_route else 2 * nt}


def test_a_traced_frame_counts_every_tile_on_the_cpu(scene):
    marks = P.ProgramMarks(False, "frame")
    with marks.recording():
        FT.render_frame(scene["world"], scene["camera"], scene["bank"],
                        _settings(), atlas=scene["atlas"])
        P.end()
    nt = -(-WIDTH // 128) * -(-HEIGHT // 8)
    c = marks.counters()
    assert c["gbuffer_tiles_resolved"] == 2 * nt
    fused = P.ProgramMarks(False, "frame")
    with fused.recording():
        FT.render_frame(scene["world"], scene["camera"], scene["bank"],
                        dataclasses.replace(_settings(), fused_shading=True),
                        atlas=scene["atlas"])
        P.end()
    assert "gbuffer_tiles_resolved" not in fused.counters()


def test_the_engines_report_keeps_it_apart_from_the_drops():
    eng = build_space_engine(device="cpu", **SMALL)
    eng.config.record_history = False
    eng.config.render = dataclasses.replace(eng.config.render,
                                            fused_shading=False)
    eng.finalize_scene()
    eng.set_tracing(True)
    eng.frame(None, 1.0 / 60.0)
    c = eng.trace_report()["counters"]
    nt = -(-SMALL["width"] // 128) * -(-SMALL["height"] // 8)
    assert c["gbuffer_tiles_resolved"] == 2 * nt
    assert set(c["render_drops"]) == {"triangle_budget_dropped",
                                      "tile_candidate_dropped"}
    assert "gbuffer_tiles_resolved" not in eng.drop_stats()


# ------------------------------------------------------ the argument checks
def _meta(x):
    return x.to("meta") if isinstance(x, torch.Tensor) else x


def _meta_call(call, layers=None, rows=None, inv_pv=None):
    (lay, r, ipv), kw, _ = call
    lay = tuple(tuple(_meta(t) for t in la) for la in lay)
    return ((lay if layers is None else layers(lay)),
            _meta(r) if rows is None else rows(_meta(r)),
            _meta(ipv) if inv_pv is None else inv_pv(_meta(ipv))), kw


def _in_layer(i, j, fn):
    return lambda layers: tuple(
        tuple(fn(v) if (li, vi) == (i, j) else v
              for vi, v in enumerate(la)) for li, la in enumerate(layers))


@pytest.mark.parametrize("change,error,match", [
    (dict(layers=_in_layer(0, 0, lambda t: t.long())), TypeError,
     "opaque slot"),
    (dict(layers=_in_layer(1, 2, lambda t: t[:-1])), ValueError,
     "transparent winner: shape"),
    (dict(layers=_in_layer(1, 1, lambda t: t.transpose(1, 2).contiguous()
                           .transpose(1, 2))), ValueError, "not contiguous"),
    (dict(layers=lambda layers: layers[:1]), ValueError, "1 layers"),
    (dict(layers=lambda layers: tuple(
        (torch.empty((1, 16, 128), dtype=s.dtype, device="meta"),) * 3
        for s, _, _ in layers)), ValueError, "threads"),
    (dict(rows=lambda t: t[..., :24]), ValueError, "channels"),
    (dict(rows=lambda t: torch.cat([t, t[..., :16]], dim=-1)), ValueError,
     "64 channels"),
    (dict(rows=lambda t: t.double()), TypeError, "rows"),
    (dict(inv_pv=lambda t: t[:3]), ValueError, "inv_pv"),
])
def test_wrapper_checks_raise(call, change, error, match):
    a, kw = _meta_call(call, **change)
    kernels.reset_launch_counts()
    with pytest.raises(error, match=match):
        TG.tall_gbuffer(*a, **kw)
    assert kernels.LAUNCHES["tall_gbuffer"] == 0


# ------------------------------------------- the argument structure, names
def test_args_structure_matches_the_kernels():
    """g++'s offsetof of every field of the source's struct equals the
    ctypes structure's, and so do the sizes."""
    src = os.path.join(CSRC, "tall_gbuffer.cu")
    names, got, size = c_struct_layout.offsets(src, "TallArgs")
    assert [n for n, _ in TG.TallArgs._fields_] == names
    offsets = [getattr(TG.TallArgs, n).offset for n in names]
    assert got + [size] == offsets + [ctypes.sizeof(TG.TallArgs)]
    assert np.all(np.diff(offsets) > 0)


def test_kernel_name_claims_no_benchmark_row():
    """The benchmark counts a device row under the kernel row whose
    profiler name it holds; the new kernel's name holds none of them."""
    src = open(os.path.join(CSRC, "tall_gbuffer.cu")).read()
    names = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\(\w+\)\s+)?"
                       r"(\w+)\s*\(", src)
    rows = []
    for path in glob.glob(os.path.join(REPO, "port_bench", "kernels",
                                       "*.py")):
        rows += re.findall(r'^PROFILER_NAME = "([^"]+)"', open(path).read(),
                           re.M)
    assert names == ["tall_gbuffer_kernel"]
    assert {"tile_raster_kernel", "resolve_kernel", "fused_shade_kernel",
            "deferred_shade_kernel"} <= set(rows)
    assert not [r for r in rows if r in names[0]]


def test_both_gbuffer_kernels_share_the_interpolation():
    for name in ("tall_gbuffer.cu", "custom_gbuffer.cu"):
        src = open(os.path.join(CSRC, name)).read()
        assert '#include "gbuffer_interp.cuh"' in src, name
        assert "interpolate(" in src and "inv_area" not in src, name
