"""Render systems: user pipelines bound to sets of models, compiled to data.

Port of ``render_engine_tpu/render/render_system.py``. A ``RenderSystem``
binds a set of bank models to raster and lighting behaviour;
``compile_systems`` turns systems into per-model routing and per-system
shading rows folded into the one fused pass. A system may also carry

* a per-frame draw callback ``fn(DrawParam)``: it decides which of the
  system's instances draw this frame (``draw_models``, filtered by sortable
  bucket and gated by ``when=``), writes per-frame uniform values and may
  toggle the skybox; only what it draws renders for its system;
* a fragment-shading function ``fn(ShadeParam) -> rgb`` that replaces the
  default deferred shading on its system's pixels, opaque and transparent,
  on the fused path (a hook after K3 over K2's full-frame resolve) and on
  the golden path.

Both callbacks are part of the Engine's frame programs: on a card they
run while the program is captured (and its warm-ups) and never again, as
the JAX package traces them once; the graph replays the device work they
did. So per-frame values reach a callback only through ``inputs`` (the
packed input vector), the world, the camera and uniforms that are tensors,
never through Python state read at call time: a Python number, a bool or
a Python branch is a constant of the captured program. Conditions and
uniform values may be tensors; they are folded with ``torch.where`` /
``&`` and never read back. A callback must not read a tensor's value on
the host (``.item()``, ``bool``, ``if`` on a tensor) or upload one
(``torch.tensor`` / ``torch.as_tensor`` of host data on the card): a
capture refuses both. A number that has to become a tensor goes through
``utils.consts.on_device``, which uploads it once. On the CPU the programs
run eagerly, and the callbacks every frame.
``render_frame_systems`` is the golden multi-system renderer: one G-buffer
per system, depth-merged, one lighting pass.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.render import lighting as L
from render_engine_tpu_torch.render import skybox as SB
from render_engine_tpu_torch.render.gbuffer import GBuffer
from render_engine_tpu_torch.utils.consts import const, on_device


@dataclasses.dataclass(frozen=True)
class RenderSystem:
    name: str
    model_ids: tuple
    lit: bool = True
    emissive_boost: float = 1.0
    casts_lov: bool = True
    uniforms: tuple = ()
    draw: object = None  # fn(DrawParam) -> None, every frame
    shade: object = None  # fn(ShadeParam) -> (..., 3) rgb


class RenderSystemBuilder:
    def __init__(self, name: str):
        self._name = name
        self._models: list[int] = []
        self._lit = True
        self._emissive_boost = 1.0
        self._lov = True
        self._uniforms: list[tuple] = []
        self._draw = None
        self._shade = None

    def with_models(self, *model_ids: int) -> "RenderSystemBuilder":
        self._models.extend(int(m) for m in model_ids)
        return self

    def with_lighting(self, lit: bool = True) -> "RenderSystemBuilder":
        self._lit = lit
        return self

    def with_emissive_boost(self, boost: float) -> "RenderSystemBuilder":
        self._emissive_boost = float(boost)
        return self

    def with_levels_of_view(self, enabled: bool) -> "RenderSystemBuilder":
        self._lov = enabled
        return self

    def write_uniform(self, name: str, value) -> "RenderSystemBuilder":
        if not isinstance(name, str) or not name:
            raise TypeError("uniform name must be a non-empty string")
        if not isinstance(value, (int, float, tuple)):
            raise TypeError(
                f"uniform {name!r}: unsupported type {type(value).__name__}")
        self._uniforms.append((name, value))
        return self

    def with_fragment_shading(self, fn) -> "RenderSystemBuilder":
        """Custom fragment shading ``fn(ShadeParam) -> rgb`` for this
        system's pixels, on both layers and on every path."""
        if not callable(fn):
            raise TypeError("fragment shading function must be callable")
        self._shade = fn
        return self

    def with_draw_function(self, fn) -> "RenderSystemBuilder":
        """Per-frame draw callback ``fn(DrawParam) -> None``."""
        if not callable(fn):
            raise TypeError("draw function must be callable")
        self._draw = fn
        return self

    def build(self) -> RenderSystem:
        if not self._models:
            raise ValueError(f"render system {self._name!r}: no models bound")
        return RenderSystem(name=self._name, model_ids=tuple(self._models),
                            lit=self._lit,
                            emissive_boost=self._emissive_boost,
                            casts_lov=self._lov,
                            uniforms=tuple(self._uniforms),
                            draw=self._draw, shade=self._shade)


RECOGNIZED_UNIFORMS = {"albedo_tint": tuple, "alpha_scale": float,
                       "emissive_boost": float}


@dataclasses.dataclass(frozen=True)
class CompiledSystems:
    """model_system (M,) int32: the system drawing each model (-1 none);
    sys_table (S, 6) f32 [unlit, boost, tint rgb, alpha_scale]; sys_lov
    (S,) f32 casts_lov per system; src: the source ``RenderSystem``
    records, which carry the callbacks (() for converted systems);
    sys_shaded (max(len(src), 1),) int32, made from ``src`` with the
    tables: 1 where a system has a fragment-shading function, so that a
    captured frame finds the shading systems' pixels without an
    upload."""

    model_system: torch.Tensor
    sys_table: torch.Tensor
    sys_lov: torch.Tensor
    names: tuple
    src: tuple = ()
    sys_shaded: torch.Tensor = dataclasses.field(init=False, repr=False,
                                                 compare=False)

    def __post_init__(self):
        flags = [int(s.shade is not None) for s in self.src] or [0]
        object.__setattr__(self, "sys_shaded", torch.tensor(
            flags, dtype=torch.int32, device=self.model_system.device))

    def has_draw_callbacks(self) -> bool:
        return any(s.draw is not None for s in self.src)

    def has_shade_callbacks(self) -> bool:
        return any(s.shade is not None for s in self.src)


def compile_systems(systems, bank) -> CompiledSystems:
    systems = tuple(systems)
    nm = bank.num_models
    model_system = np.full(nm, -1, np.int32)
    table = np.zeros((max(len(systems), 1), 6), np.float32)
    lov = np.ones(max(len(systems), 1), np.float32)
    lov_table = bank.lov_table.cpu().numpy()
    for s, sys_ in enumerate(systems):
        boost = float(sys_.emissive_boost)
        tint = (1.0, 1.0, 1.0)
        alpha_scale = 1.0
        for name, value in sys_.uniforms:
            if name not in RECOGNIZED_UNIFORMS:
                if sys_.shade is not None:
                    continue  # read by the system's ShadeParam.uniforms
                raise ValueError(_unknown_uniform(sys_, name))
            if name == "albedo_tint":
                tint = tuple(float(v) for v in value)
            elif name == "alpha_scale":
                alpha_scale = float(value)
            else:
                boost *= float(value)
        table[s] = [0.0 if sys_.lit else 1.0, boost, *tint, alpha_scale]
        lov[s] = 1.0 if sys_.casts_lov else 0.0
        for m in sys_.model_ids:
            if not 0 <= m < nm:
                raise ValueError(f"render system {sys_.name!r}: model id {m} "
                                 "not in bank")
            if model_system[m] >= 0 and model_system[m] != s:
                raise ValueError(f"model {m} bound to two render systems")
            model_system[m] = s
            for variant in lov_table[m]:
                if model_system[variant] < 0:
                    model_system[variant] = s
    dev = bank.device
    return CompiledSystems(model_system=torch.as_tensor(model_system,
                                                        device=dev),
                           sys_table=torch.as_tensor(table, device=dev),
                           sys_lov=torch.as_tensor(lov, device=dev),
                           names=tuple(s.name for s in systems),
                           src=systems)


def _unknown_uniform(system: RenderSystem, name: str) -> str:
    return (f"render system {system.name!r}: unknown uniform {name!r} "
            f"(recognized: {sorted(RECOGNIZED_UNIFORMS)}; other names need "
            "a with_fragment_shading consumer)")


def entity_shade_attrs(world: World, systems: CompiledSystems,
                       sys_table=None) -> torch.Tensor:
    """(CAP, 6) per-entity shading rows from each entity's model's system
    (identity row for unrouted entities). ``sys_table`` replaces the
    compiled table with this frame's rows (``DrawParam`` uniform writes)."""
    table = systems.sys_table if sys_table is None else sys_table
    mid = world["model_id"]
    ms = systems.model_system[mid.clamp(
        0, systems.model_system.shape[0] - 1).long()]
    rows = table[ms.clamp(0, table.shape[0] - 1).long()]
    identity = const((0.0, 1.0, 1.0, 1.0, 1.0, 1.0), device=world.device)
    return torch.where(((ms >= 0) & (mid >= 0))[:, None], rows, identity)


class DrawParam:
    """What a draw callback gets: the world, camera and this frame's inputs
    to read, and the calls that decide the frame: ``draw_models``,
    ``draw_skybox``, ``write_uniform``. Draws become instance masks and
    uniform writes become this frame's shading rows, both folded into the
    one fused pass. Captured once with the frame program (see the module
    notes): per-frame values come from ``input``, the world and the camera
    as tensors; a Python value is the captured program's constant."""

    def __init__(self, system: RenderSystem, world: World, camera, inputs,
                 bank):
        self.world = world
        self.camera = camera
        self.input = inputs  # InputState of tensors, or None
        self._system = system
        self._bound = frozenset(int(m) for m in system.model_ids)
        self._bank = bank
        self._mask = torch.zeros(world.capacity, dtype=torch.bool,
                                 device=world.device)
        self._uniform_writes: list[tuple] = []
        self.skybox: object = None  # None = leave as configured

    def get_ecs(self) -> World:
        return self.world

    def get_camera(self):
        return self.camera

    def get_input_history(self):
        return self.input

    def draw_models(self, *model_ids, sortable=None, when=None):
        """Draw this frame's instances of ``model_ids`` (bound to this
        system). ``sortable``: an int or an iterable of sortable bucket
        values; only instances in those buckets draw. ``when``: a bool or a
        bool tensor scalar gating the whole call."""
        name = self._system.name
        if not model_ids:
            raise ValueError(f"render system {name!r}: draw_models needs at "
                             "least one model id")
        mid = self.world["model_id"]
        m = torch.zeros_like(self._mask)
        for model in model_ids:
            model = int(model)
            if model not in self._bound:
                raise ValueError(
                    f"render system {name!r}: cannot draw model {model} — "
                    f"not bound to this system (bound: "
                    f"{sorted(self._bound)})")
            m = m | (mid == model)
        if sortable is not None:
            if isinstance(sortable, (int, float)):
                sortable = (int(sortable),)
            sm = torch.zeros_like(self._mask)
            for bucket in sortable:
                sm = sm | (self.world["sortable"] == int(bucket))
            m = m & sm
        if when is not None:
            m = m & _bool(when, m.device)
        self._mask = self._mask | m

    def draw_skybox(self, on=True):
        """Toggle the skybox for this frame; ``on`` may be a bool tensor."""
        self.skybox = on

    def write_uniform(self, name: str, value):
        """Write a per-frame uniform value (a number, a tuple or a tensor).
        Unknown names raise unless this system has a fragment-shading
        function, whose ``ShadeParam.uniforms`` takes any name."""
        if name not in RECOGNIZED_UNIFORMS and self._system.shade is None:
            raise ValueError(_unknown_uniform(self._system, name))
        self._uniform_writes.append((name, value))


@dataclasses.dataclass(frozen=True)
class DrawContext:
    """One frame's result of the draw callbacks. ``allowed``: bool[CAP]
    instance gate (None = static routing only); ``sys_table``: this frame's
    (S, 6) shading rows (None = the compiled ones); ``skybox_on``: a bool or
    bool tensor (None = the configured background); ``uniform_writes``:
    per system, {name: value} of this frame's ``write_uniform`` calls."""

    allowed: object = None
    sys_table: object = None
    skybox_on: object = None
    uniform_writes: tuple = ()


def _f32(value, device):
    """A uniform as a float32 tensor on ``device``: a number or a tuple is
    a device constant, uploaded once, so inside a captured program it is
    the value the program was captured with (``consts.on_device``)."""
    return on_device(value, torch.float32, device)


def _bool(value, device):
    """A gate (a bool or a bool tensor) as a bool tensor on ``device``."""
    if isinstance(value, torch.Tensor):
        return value.to(device=device, dtype=torch.bool)
    return on_device(bool(value), torch.bool, device)


def run_draw_callbacks(systems: CompiledSystems, world: World, camera,
                       inputs, bank) -> DrawContext:
    """Call every system's draw callback for this frame and fold the
    results. Entities of systems without a callback stay statically routed;
    entities of a system with one draw only if it drew them this frame."""
    if not systems.has_draw_callbacks():
        return DrawContext()
    dev = world.device
    mid = world["model_id"]
    ent_sys = systems.model_system[mid.clamp(
        0, systems.model_system.shape[0] - 1).long()]
    allowed = torch.ones(world.capacity, dtype=torch.bool, device=dev)
    sys_table = systems.sys_table
    skybox_on = None
    uniform_writes = [{} for _ in systems.src]
    for s, sys_ in enumerate(systems.src):
        if sys_.draw is None:
            continue
        dp = DrawParam(sys_, world, camera, inputs, bank)
        sys_.draw(dp)
        allowed = torch.where(ent_sys == s, dp._mask, allowed)
        if dp.skybox is not None:
            skybox_on = dp.skybox
        uniform_writes[s] = dict(dp._uniform_writes)
        if dp._uniform_writes:
            row = sys_table[s]
            boost, tint, alpha_scale = row[1], row[2:5], row[5]
            for name, value in dp._uniform_writes:
                if name == "albedo_tint":
                    tint = _f32(value, dev).reshape(3)
                elif name == "alpha_scale":
                    alpha_scale = _f32(value, dev)
                elif name == "emissive_boost":
                    # replaces the build-time uniform: row[1] already folds
                    # it in, so multiplying row[1] would apply it twice
                    boost = sys_.emissive_boost * _f32(value, dev)
            new_row = torch.cat([row[0:1], boost.reshape(1), tint,
                                 alpha_scale.reshape(1)])
            sys_table = torch.cat([sys_table[:s], new_row[None],
                                   sys_table[s + 1:]])
    return DrawContext(allowed=allowed, sys_table=sys_table,
                       skybox_on=skybox_on,
                       uniform_writes=tuple(uniform_writes))


@dataclasses.dataclass(frozen=True)
class ShadeParam:
    """Per-pixel inputs of a fragment-shading function: the G-buffer
    contract and the default-shaded color. Every image-shaped field has the
    path's pixel layout as leading shape, (H, W) on the golden path and the
    tall (NT * th, tw) on the fused one; the function works elementwise and
    returns ``base_color``'s shape. ``uniforms`` hold the values as they
    were given: a number becomes a tensor through
    ``utils.consts.on_device`` (an upload inside a captured program is
    refused)."""

    position: torch.Tensor  # (..., 3) world-space position
    normal: torch.Tensor  # (..., 3) world-space normal
    albedo: torch.Tensor  # (..., 3) material or texture albedo
    depth: torch.Tensor  # (...,) NDC depth
    material: torch.Tensor  # (...,) int32 material id
    covered: torch.Tensor  # (...,) bool: a triangle won this pixel
    base_color: torch.Tensor  # (..., 3) default deferred shading result
    camera: object
    lights: object  # lighting.LightArrays
    uniforms: dict  # this system's uniform values, static and per-frame


def triangle_system_ids(batch, world: World,
                        systems: CompiledSystems) -> torch.Tensor:
    """(max_tris,) int32 render-system index per triangle: triangle ->
    entity -> model -> system, the routing the raster used."""
    ent = batch.entity.clamp(0, world.capacity - 1).long()
    mid = world["model_id"][ent]
    return systems.model_system[mid.clamp(
        0, systems.model_system.shape[0] - 1).long()]


def _run_shade(system: RenderSystem, gbuf: GBuffer, covered, color, camera,
               lights, uniforms) -> torch.Tensor:
    sp = ShadeParam(position=gbuf.position, normal=gbuf.normal,
                    albedo=gbuf.albedo, depth=gbuf.depth,
                    material=gbuf.material, covered=covered,
                    base_color=color, camera=camera, lights=lights,
                    uniforms=uniforms)
    out = _f32(system.shade(sp), color.device)
    if out.shape != color.shape:
        raise ValueError(
            f"render system {system.name!r}: fragment shading returned "
            f"shape {tuple(out.shape)}, expected {tuple(color.shape)}")
    return out


def shade_systems_color(color, gbuf, px_sys, covered, camera, lights,
                        systems: CompiledSystems,
                        uniform_writes=None) -> torch.Tensor:
    """Run each shading system's function over its own pixels (``px_sys``:
    per-pixel system index); other pixels keep the default result. Shared
    by the golden path and the fused path's hook."""
    for s, sys_ in enumerate(systems.src):
        if sys_.shade is None:
            continue
        uniforms = dict(sys_.uniforms)
        if uniform_writes:
            uniforms.update(uniform_writes[s])
        out = _run_shade(sys_, gbuf, covered, color, camera, lights,
                         uniforms)
        color = torch.where(((px_sys == s) & covered)[..., None], out, color)
    return color


def apply_custom_shading(color, gbuf, winner, batch, world: World, camera,
                         lights, systems: CompiledSystems,
                         draw_ctx) -> torch.Tensor:
    """Custom shading on image-layout buffers: pixel ownership is winner
    triangle -> entity -> model -> system."""
    if systems is None or not systems.has_shade_callbacks():
        return color
    tri_sys = triangle_system_ids(batch, world, systems)
    px_sys = tri_sys[winner.clamp(0, batch.budget - 1).long()]
    return shade_systems_color(
        color, gbuf, px_sys, winner >= 0, camera, lights, systems,
        None if draw_ctx is None else draw_ctx.uniform_writes)


def _system_instance_mask(world: World, system: RenderSystem
                          ) -> torch.Tensor:
    mid = world["model_id"]
    mask = torch.zeros_like(mid, dtype=torch.bool)
    for m in system.model_ids:
        mask = mask | (mid == m)
    return mask


def _merge_gbuffers(a: GBuffer, b: GBuffer) -> GBuffer:
    """Depth-merge two G-buffers (one shared G-buffer across systems)."""
    closer = (b.tri_id >= 0) & ((b.depth < a.depth) | (a.tri_id < 0))
    cm = closer[..., None]
    return GBuffer(depth=torch.where(closer, b.depth, a.depth),
                   position=torch.where(cm, b.position, a.position),
                   normal=torch.where(cm, b.normal, a.normal),
                   albedo=torch.where(cm, b.albedo, a.albedo),
                   material=torch.where(closer, b.material, a.material),
                   tri_id=torch.where(closer, b.tri_id, a.tri_id))


def render_frame_systems(world: World, camera, bank, systems: tuple,
                         settings, *, cubemap=None, atlas=None,
                         shadow_state=None, inputs=None) -> torch.Tensor:
    """Golden multi-system render: each system rasters its model set (its
    draw callback's submissions, when it has one) with its own LoV, tint and
    unlit knobs; the G-buffers depth-merge; one lighting pass shades the
    union; each system's transparent layer blends over it. ``systems`` are
    ``RenderSystem`` records, not compiled."""
    from render_engine_tpu_torch.render.geometry import (
        build_triangle_batch, to_screen)
    from render_engine_tpu_torch.render.raster_jnp import (
        rasterize_depth_winner, resolve_gbuffer)

    h, w = settings.height, settings.width
    dev = world.device
    gbuf = unlit_mask = boost = sys_img = None
    trans_layers = []
    skybox_on = None
    uniform_values = []
    with_diss = atlas is not None and bank.has_dissolve_maps()
    for s_idx, sys_ in enumerate(systems):
        writes: dict = {}
        if sys_.draw is not None:
            dp = DrawParam(sys_, world, camera, inputs, bank)
            sys_.draw(dp)
            imask = dp._mask
            writes = dict(dp._uniform_writes)
            if dp.skybox is not None:
                skybox_on = dp.skybox
        else:
            imask = _system_instance_mask(world, sys_)
        uniforms = dict(sys_.uniforms)
        uniforms.update(writes)
        uniform_values.append(uniforms)
        sys_boost_val = sys_.emissive_boost * _f32(
            uniforms.get("emissive_boost", 1.0), dev)
        sys_tint = _f32(uniforms.get("albedo_tint", (1.0, 1.0, 1.0)),
                        dev).reshape(3)
        alpha_scale = _f32(uniforms.get("alpha_scale", 1.0), dev)

        batch = to_screen(build_triangle_batch(
            world, bank, camera, max_tris=settings.max_tris,
            instance_mask=imask, apply_lov=sys_.casts_lov), w, h)
        depth, winner = rasterize_depth_winner(batch, h, w, settings.raster,
                                               ~batch.transparent)
        g = resolve_gbuffer(batch, bank, depth, winner, atlas=atlas)
        g = dataclasses.replace(g, albedo=g.albedo * sys_tint)
        covered = g.tri_id >= 0
        sys_unlit = covered & (not sys_.lit)
        sys_boost = torch.where(covered, sys_boost_val, 1.0)
        sys_tag = torch.where(covered, s_idx, -1)
        if gbuf is None:
            gbuf, unlit_mask, boost, sys_img = (g, sys_unlit, sys_boost,
                                                sys_tag)
        else:
            closer = covered & ((depth < gbuf.depth) | (gbuf.tri_id < 0))
            unlit_mask = torch.where(closer, sys_unlit, unlit_mask)
            boost = torch.where(closer, sys_boost, boost)
            sys_img = torch.where(closer, sys_tag, sys_img)
            gbuf = _merge_gbuffers(gbuf, g)
        t_depth, t_winner = rasterize_depth_winner(
            batch, h, w, settings.raster, batch.transparent)
        t_diss = None
        if with_diss:
            tg, t_diss = resolve_gbuffer(batch, bank, t_depth, t_winner,
                                         atlas=atlas, with_dissolve=True)
        else:
            tg = resolve_gbuffer(batch, bank, t_depth, t_winner, atlas=atlas)
        tg = dataclasses.replace(tg, albedo=tg.albedo * sys_tint)
        trans_layers.append((s_idx, tg, t_depth, t_winner, alpha_scale,
                             t_diss))

    lights = L.extract_lights(world, max_dir=settings.max_dir_lights,
                              max_point=settings.max_point_lights,
                              max_spot=settings.max_spot_lights)
    shadow_factor = None
    if shadow_state is not None:
        from render_engine_tpu_torch.render.shadows import make_shadow_factor

        shadow_factor = make_shadow_factor(
            shadow_state, world,
            {"dir": lights.dir_entity, "spot": lights.sp_entity,
             "point": lights.pt_entity})

    clear = _f32(settings.clear_color, dev)
    if cubemap is not None:
        background = SB.sample_cubemap(
            cubemap, SB.pixel_ray_directions(camera, h, w))
    else:
        background = clear.expand(h, w, 3)
    if skybox_on is not None:
        background = torch.where(_bool(skybox_on, dev), background, clear)

    color = L.shade(gbuf, lights, bank, camera.position,
                    background=background, shadow_factor=shadow_factor)
    # per-system unlit / emissive-boost override
    color = torch.where(unlit_mask[..., None],
                        gbuf.albedo * boost[..., None], color)
    covered_any = gbuf.tri_id >= 0
    for s_idx, sys_ in enumerate(systems):
        if sys_.shade is None:
            continue
        out = _run_shade(sys_, gbuf, covered_any, color, camera, lights,
                         uniform_values[s_idx])
        color = torch.where(((sys_img == s_idx) & covered_any)[..., None],
                            out, color)

    for s_idx, t_gbuf, t_depth, t_winner, alpha_scale, t_diss \
            in trans_layers:
        t_lit = L.shade(t_gbuf, lights, bank, camera.position,
                        background=color, shadow_factor=shadow_factor)
        if systems[s_idx].shade is not None:
            t_cov = t_gbuf.tri_id >= 0
            out_t = _run_shade(systems[s_idx], t_gbuf, t_cov, t_lit, camera,
                               lights, uniform_values[s_idx])
            t_lit = torch.where(t_cov[..., None], out_t, t_lit)
        mat = t_gbuf.material.clamp(0, bank.mat_alpha.shape[0] - 1).long()
        alpha = (bank.mat_alpha[mat][..., None] * alpha_scale).clamp(0.0, 1.0)
        if t_diss is not None:
            alpha = alpha * t_diss[..., None]
        in_front = (t_winner >= 0) & (t_depth <= gbuf.depth)
        color = torch.where(in_front[..., None],
                            alpha * t_lit + (1.0 - alpha) * color, color)
    return color.clamp(0.0, 1.0)
