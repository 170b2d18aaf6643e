"""The Engine: owns world, camera and bank on one device; drives frames
through captured programs.

Port of ``render_engine_tpu/runtime/engine.py``: ``finalize_scene``,
``frame()`` (the step, then the shadow-map update, then the render of the
stepped state with the updated maps), ``step``, ``update_shadows``,
``render`` / ``render_only``, ``reset``, the bursts ``run_frames`` and
``run_frames_rendered``, the recorded config events
(``set_draw_distances``, ``set_window``), history recording with
``flush_history`` (runtime/history.py; replayed by runtime/replay.py),
``drop_stats`` with ``render_drop_stats``, and ``fps_stats``; and, with
``set_tracing(True)``, spans inside the captured programs and around the
calls (``trace_report``, ``export_spans``; ``runtime/profiling.py``).

The programs. The JAX package compiles the step (``_step``), the render
(``_render``, ``_render_shadowed``) and the whole frame (``_frame_fused``:
step, shadow-map update and render) into XLA programs over donated world
and shadow buffers; per-frame values cross the boundary as one packed f32
input vector and the (8,) camera vector, so a frame is one dispatch.
``_build_step`` and ``_build_render`` build the same programs here, as
functions over a ``ProgramState``: static buffers for the world columns,
the camera vector, the shadow maps and tables, the packed inputs, the drop
counters and the image. A program reads them and copies its results back
into them (JAX's donation). On a CUDA device each program is captured once
as a ``torch.cuda.CUDAGraph`` and replayed every frame: a frame is one
pinned, non-blocking copy of ``InputState.pack_with_dt`` and the shadow
slot into the packed buffer, the replays, and a clone of the image. On
the CPU the same functions run eagerly. There is no other route on the
card: a program that cannot be captured raises.

What a program may depend on. A graph replays the device work it saw at
capture: Python values read while the program was built or captured (the
camera's and the render settings' static fields, a number a draw callback
writes) are constants of that program. Per-frame values reach a program
only through the packed input vector, the shadow slot beside it and the
camera vector; draw callbacks and custom shading functions are captured
once, as JAX traces them once (``render/render_system.py``). The shadow
schedule runs on the host (``render/shadows.py``): its interval gate picks
the program (``"skip"`` or ``"map"``), and the round-robin slot a map
frame refreshes reaches the graph as data, as JAX's device cursor does.

Invalidation, as the JAX package re-jits: a new step, bank or camera
configuration (``finalize_scene``, ``set_window``, ``set_draw_distances``)
drops every program; a new render configuration (``set_skybox``,
``set_atlas``, ``set_render_systems``, a changed ``config.render`` or
``compiled_systems``) drops the programs that render. ``reset`` keeps them
all unless the settings it restores differ. ``set_tracing`` drops them all
(the marks are part of a graph), and the next calls capture them again.
``captured_programs`` lists the keys of the programs held.

Tracing. With ``set_tracing(True)`` the programs are captured with their
marks (``profiling.mark``: the spans ``step`` and its four stages,
``shadows``, ``render`` and its stages, ``store``, inside the frame
program's ``frame``) and their counters (the render's drop counters and,
with custom shading on the fused route, its three), and every call records
host spans (``engine.frame`` or the call's name; inside it ``engine.trace``,
``engine.record``, ``engine.feed``, ``engine.shadow_decision``,
``engine.launch`` for each replay, tagged with the program's key, and
``engine.clone``), an anchor event where its input copy starts and a tail
event after its last work. ``trace_report`` synchronizes once and returns
the calls held and the counters. With tracing off (the default) the
programs are the same graphs without the marks, and a call records only
its start and end (``fps_stats``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import time

import numpy as np
import torch

from render_engine_tpu_torch import kernels
from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.logic import kinematics as K
from render_engine_tpu_torch.logic.step import (STEP_DROP_KEYS, make_step,
                                                pack_drop_stats,
                                                unpack_drop_stats)
from render_engine_tpu_torch.logic.types import (NUM_KEYS, PACKED_INPUT_LEN,
                                                 InputState)
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.math.camera import Camera, CameraBuilder
from render_engine_tpu_torch.models.bank import ModelBank, ModelBankBuilder
from render_engine_tpu_torch.render import deferred_shade as DS
from render_engine_tpu_torch.render import lighting as LG
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render import shade_pallas as SP
from render_engine_tpu_torch.render import shadows as SH
from render_engine_tpu_torch.render.frame import (WORK_COUNTERS,
                                                  RenderSettings,
                                                  render_frame,
                                                  shadow_tile_overflow)
from render_engine_tpu_torch.render.geometry import (build_triangle_batch,
                                                     to_screen)
from render_engine_tpu_torch.render.raster_jnp import _bin_triangles
from render_engine_tpu_torch.runtime import profiling as P
from render_engine_tpu_torch.runtime.config import EngineConfig
from render_engine_tpu_torch.runtime.history import HistoryLog
from render_engine_tpu_torch.utils import consts

_CAMERA_EVENT_KEYS = ("draw_distance", "near", "far", "fov_y")
_CAMERA_STATIC = ("fov_y", "aspect", "near", "far", "draw_distance",
                  "projection_kind", "ortho_half_extent", "movement_factor")
_STAGING = 4  # pinned input buffers in flight
# the snapshots (Engine.world, .camera, .shadow_state) each program changes
_WRITES = {"step": ("world", "camera"),
           "frame": ("world", "camera", "shadow"),
           "render_shadowed": ("shadow",), "shadows": ("shadow",),
           "render": ()}
_OFF = contextlib.nullcontext()


@dataclasses.dataclass
class ProgramState:
    """The buffers every program reads and writes in place (the JAX
    package's donated arguments): ``world``'s columns, the camera vector
    ``camv`` (8,), the shadow tables ``shadow`` (maps, light_mats,
    slot_entity, slot_face; None without shadows), this frame's ``packed``
    inputs, the camera vector ``view`` a render-only program draws
    through, the step's ``drops`` (6,) int32, the last ``image`` and the
    (1,) ``slot`` a map frame refreshes (0 where a caller gives none)."""

    world: W.World
    camv: torch.Tensor
    shadow: tuple | None
    packed: torch.Tensor
    view: torch.Tensor
    drops: torch.Tensor
    image: torch.Tensor | None = None
    slot: torch.Tensor | None = None

    def __post_init__(self):
        if self.slot is None:
            self.slot = torch.zeros(1, device=self.packed.device)

    def clone(self) -> "ProgramState":
        def c(t):
            return None if t is None else t.clone()
        return ProgramState(
            world=self.world.clone(), camv=c(self.camv),
            shadow=(None if self.shadow is None
                    else tuple(t.clone() for t in self.shadow)),
            packed=c(self.packed), view=c(self.view), drops=c(self.drops),
            image=c(self.image), slot=c(self.slot))


def _store(dst: torch.Tensor, src: torch.Tensor):
    if dst is not src:
        dst.copy_(src)


def _store_world(dst: W.World, src: W.World):
    _store(dst.alive, src.alive)
    _store(dst.comp_mask, src.comp_mask)
    for name, col in dst.comps.items():
        _store(col, src.comps[name])


def _store_shadow(st: ProgramState, sh):
    """A shadow update's tables into the static buffers (None: no
    shadows)."""
    if sh is not None:
        for dst, src in zip(st.shadow, (sh.maps, sh.light_mats,
                                        sh.slot_entity, sh.slot_face)):
            _store(dst, src)


def _same_layout(a, b) -> bool:
    return (a.shape == b.shape and a.dtype == b.dtype
            and a.device == b.device)


def _camera_meta(camera: Camera) -> tuple:
    """The camera's static configuration: constants of every program."""
    return tuple((k, getattr(camera, k)) for k in _CAMERA_STATIC)


def _same(a: tuple, b) -> bool:
    """Element-wise: the same object, or an equal plain value (tensors and
    other objects by identity)."""
    return b is not None and len(a) == len(b) and all(
        x is y or (type(x) is type(y)
                   and isinstance(x, (int, float, str, tuple,
                                      RenderSettings)) and x == y)
        for x, y in zip(a, b))


@contextlib.contextmanager
def _sync_errors():
    """Raise, with its line, on any operation that waits for the device."""
    before = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(before)


def _packed(inputs: InputState) -> np.ndarray:
    """``pack_with_dt`` of host or tensor inputs (dt 0: a render reads
    none)."""
    def host(v):
        return v.cpu().numpy() if isinstance(v, torch.Tensor) else v
    return InputState(keys=host(inputs.keys),
                      mouse_delta=host(inputs.mouse_delta),
                      rng_seed=int(host(inputs.rng_seed)),
                      prev_keys=host(inputs.prev_keys)).pack_with_dt(0.0)


class _Program:
    """One program: ``run`` replays its graph (or, on the CPU, runs its
    function); ``launches`` are the kernel launches its capture counted,
    added to ``kernels.LAUNCHES`` on every replay; ``keep`` holds the
    cached constants its graph reads; ``marks`` its spans and counters
    (``profiling.ProgramMarks``; None with tracing off)."""

    def __init__(self, run, launches: dict, keep: list, seconds: float,
                 marks: P.ProgramMarks | None = None):
        self.run, self.launches, self.keep = run, launches, keep
        self.seconds, self.marks = seconds, marks
        # a traced graph's second capture, replayed in turn with this one
        self.twin: _Program | None = None

    def __call__(self):
        self.run()
        for k, n in self.launches.items():
            kernels.LAUNCHES[k] += n


def capture_program(fn, state: ProgramState, pool,
                    error_mode: str = "global",
                    marks: P.ProgramMarks | None = None) -> _Program:
    """``fn(state)`` captured as a CUDA graph over ``state``'s buffers in
    the graph pool ``pool``, after two warm-up runs on a side stream over a
    copy of the state (the first builds the kernels and uploads the cached
    constants; the second, like the capture, runs with every operation
    that waits for the device raising). The kernel launches the capture
    counted are the program's; warm-up and capture add none to
    ``kernels.LAUNCHES``. ``error_mode`` is ``torch.cuda.graph``'s
    ``capture_error_mode``. ``marks``: the program's marks, recorded into
    the graph as timing events (the warm-up runs record none).

    A graph destroyed while another is being captured invalidates that
    capture, and a dropped engine's graphs are freed by the garbage
    collector (its programs' closures refer to the engine). So the
    collector runs before the capture and is off during it."""
    t0 = time.perf_counter()
    device = state.camv.device
    counted = dict(kernels.LAUNCHES)
    scratch = state.clone()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn(scratch)
        with _sync_errors():
            fn(scratch)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    keep: list = []
    mark = dict(kernels.LAUNCHES)
    gc.collect()
    collecting = gc.isenabled()
    gc.disable()
    try:
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode=error_mode):
            with _sync_errors(), consts.holding(keep), P.recording(marks):
                fn(state)
    finally:
        if collecting:
            gc.enable()
    launches = {k: n - mark.get(k, 0)
                for k, n in kernels.LAUNCHES.items()
                if n != mark.get(k, 0)}
    # warm-up and capture run nothing of the frame
    kernels.LAUNCHES.update(counted)
    return _Program(graph.replay, launches, keep, time.perf_counter() - t0,
                    marks)


def shadow_schedule(tick: int, cursor: int, interval: int, shadow):
    """One frame of the shadow schedule of the tables ``shadow`` on the
    host, as ``render/shadows.py``'s ``render_shadow_map`` advances it:
    ``(decision, slot, tick, cursor)``, the decision None without shadows,
    ``"skip"`` where the interval gate skips, else ``"map"``."""
    if shadow is None:
        return None, 0, tick, cursor
    if interval > 1 and tick % interval != 0:
        return "skip", 0, tick + 1, cursor
    return "map", cursor % shadow[2].shape[0], tick + 1, cursor + 1


def config_step(cfg: EngineConfig):
    """The world tick of a configuration: ``make_step`` with its entity
    types and its budgets, as the Engine steps its world."""
    return make_step(
        tuple(cfg.entity_types),
        logic_radius=cfg.logic_radius, spawn_budget=cfg.spawn_budget,
        collision_budget=cfg.collision_budget,
        collision_pairs=cfg.collision_pairs,
        collision_large_budget=cfg.collision_large_budget)


class Engine:
    def __init__(self, config: EngineConfig, camera: Camera | None = None,
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        if self.device.type == "cuda":
            # the default route's shading kernel reads at most so many
            # shadow slots and light rows: refuse more now, not at the
            # first frame
            DS.check_reach(config.render, config.shadow_slots
                           if config.enable_shadows else 0)
        self.world_config = W.WorldConfig(
            capacity=config.capacity, world_min=config.world_min,
            world_length=config.world_length,
            section_length=config.section_length, registry=config.registry)
        dev = self.device
        self.bank: ModelBank | None = None
        self._step_fn = None  # no programs before finalize_scene
        self._views: dict = {}
        # the packed inputs, then the shadow slot, in one buffer; its host
        # side: on a card a ring of pinned buffers, each copied to the
        # device buffer once; on the CPU the buffer's own memory
        self._stage = []
        self._stage_at = 0
        n = PACKED_INPUT_LEN
        if dev.type == "cuda":
            self._stage = [(torch.zeros(n + 1).pin_memory(),
                            torch.cuda.Event()) for _ in range(_STAGING)]
            self._inbox = torch.zeros(n + 1, device=dev)
        else:
            self._packed_host = np.zeros(n + 1, np.float32)
            self._inbox = torch.from_numpy(self._packed_host)
        self._state = ProgramState(
            world=W.create_world(self.world_config, dev),
            camv=torch.zeros(8, device=dev), shadow=None,
            packed=self._inbox[:n], view=torch.zeros(8, device=dev),
            drops=torch.zeros(len(STEP_DROP_KEYS), dtype=torch.int32,
                              device=dev), slot=self._inbox[n:])
        # the per-counter max over a burst (runs outside the programs)
        self._burst_drops = torch.zeros_like(self._state.drops)
        self._cam_template: Camera | None = None
        self.camera = (camera or CameraBuilder().build()).to(dev)
        # the shadow schedule's host integers (render/shadows.py)
        self._sh_cursor = self._sh_tick = 0
        self._sh_config = None  # (resolution, pcf_scale)
        self._programs: dict = {}
        self._baked = (None, None)
        self._pool = None
        self.bank_builder = (
            ModelBankBuilder(lov_fractions=tuple(config.lov_fractions))
            if config.lov_fractions is not None else ModelBankBuilder())
        self.cubemap = None
        self.atlas = None
        self.compiled_systems = None
        self.history = HistoryLog()
        self.frame_index = 0
        self._prev_keys = np.zeros(NUM_KEYS, bool)
        self._last_drops = None
        # the host start and end of the last frames (fps_stats)
        self._frame_calls = P.CallRing()
        self._tracing = False
        self._trace: P.FrameTracer | None = None
        if config.build_scene is not None:
            config.build_scene(self)
        self.finalize_scene()

    # -- the state the programs hold ---------------------------------------
    def _view(self, name: str, make):
        """A snapshot of the static buffers, kept until a program or a
        setter changes what it shows (a caller may keep it across frames;
        the next frame writes the buffers in place)."""
        v = self._views.get(name)
        if v is None:
            v = self._views[name] = make()
        return v

    @property
    def world(self) -> W.World:
        """A copy of the world in the static buffers."""
        return self._view("world", self._state.world.clone)

    @world.setter
    def world(self, value: W.World):
        cur = self._state.world
        cols = [("alive", cur.alive, value.alive),
                ("comp_mask", cur.comp_mask, value.comp_mask)] + [
            (k, c, value.comps.get(k)) for k, c in cur.comps.items()]
        if len(value.comps) == len(cur.comps) and all(
                v is not None and _same_layout(c, v) for _, c, v in cols):
            for _, c, v in cols:
                c.copy_(v)
        else:  # another layout: new buffers, and the programs go stale
            self._state.world = value.clone()
        self._views.pop("world", None)
        self._refresh_programs()

    @property
    def camera(self) -> Camera:
        """The engine camera: its static configuration and a copy of the
        camera vector."""
        return self._view("camera", lambda: self._cam_template
                          .apply_serialized(self._state.camv.clone()))

    @camera.setter
    def camera(self, value: Camera):
        value = value.to(self.device)
        self._cam_template = value
        self._state.camv.copy_(value.serialize())
        self._views.pop("camera", None)
        self._refresh_programs()

    @property
    def shadow_state(self) -> SH.ShadowState | None:
        """A copy of the shadow state: the tables in the static buffers and
        the schedule's host integers."""
        b = self._state.shadow
        if b is None:
            return None
        return self._view("shadow", lambda: self._shadow_view(
            tuple(t.clone() for t in b), self._sh_cursor, self._sh_tick))

    @shadow_state.setter
    def shadow_state(self, value: SH.ShadowState | None):
        if value is None:
            self._state.shadow = self._sh_config = None
        else:
            new = (value.maps, value.light_mats, value.slot_entity,
                   value.slot_face)
            cur = self._state.shadow
            if cur is not None and all(_same_layout(c, v)
                                       for c, v in zip(cur, new)):
                for c, v in zip(cur, new):
                    c.copy_(v)
            else:
                self._state.shadow = tuple(t.clone() for t in new)
            self._sh_cursor, self._sh_tick = value.cursor, value.tick
            self._sh_config = (value.resolution, value.pcf_scale)
        self._views.pop("shadow", None)
        self._refresh_programs()

    def _shadow_view(self, tables, cursor=0, tick=0) -> SH.ShadowState:
        res, pcf = self._sh_config
        return SH.ShadowState(*tables, cursor=cursor, tick=tick,
                              resolution=res, pcf_scale=pcf)

    # -- scene setup -------------------------------------------------------
    def spawn(self, count: int, **components):
        self.world, idx = W.spawn_host(self.world, count, **components)
        return idx

    def set_skybox(self, cubemap):
        self.cubemap = cubemap
        self._refresh_programs()

    def set_atlas(self, atlas):
        self.atlas = atlas
        self._refresh_programs()

    def set_render_systems(self, systems):
        self.config.render_systems = systems
        self._refresh_programs()

    def finalize_scene(self):
        """Freeze the model bank, refresh every AABB, take the history
        baseline, compile the render systems and the step, create the
        shadow state, snapshot the initial state and build the programs
        (captured lazily, at their first frame)."""
        if self.bank is None:
            if not self.bank_builder._models:
                from render_engine_tpu_torch.models import primitives

                self.bank_builder.add_model("__placeholder__",
                                            primitives.cube(1.0))
            self.bank = self.bank_builder.finalize(self.device)
        w = self._state.world
        self.world = K.refresh_transforms(w, self.bank.aabb_min,
                                          self.bank.aabb_max, w.alive)
        # the baseline is the refreshed world: the Player uses it verbatim
        self._start_history()
        cfg = self.config
        self._step_fn = config_step(cfg)
        self.compiled_systems = None
        rs = cfg.render_systems
        if rs is not None:
            from render_engine_tpu_torch.render.render_system import (
                compile_systems)

            if callable(rs):
                rs = rs(self.bank)
            self.compiled_systems = compile_systems(tuple(rs), self.bank)
        self.shadow_state = (SH.create_shadow_state(
            cfg.shadow_resolution, budget=cfg.shadow_slots,
            pcf_scale=cfg.shadow_pcf_scale, device=self.device)
            if cfg.enable_shadows else None)
        self._initial_state = (self.world, self.camera, self.shadow_state,
                               cfg.render)
        self._refresh_programs()

    def _start_history(self):
        self.history = HistoryLog()
        if self.config.record_history:
            self.history.set_baseline(
                self._state.world, self.camera,
                meta={"engine": "render_engine_tpu_torch",
                      "capacity": self.config.capacity})

    def reset(self):
        """Back to the post-finalize state at frame zero: world, camera
        (its draw distances too), shadow state and render settings, with a
        fresh history baseline. The programs stay; those whose settings
        the restore changes are captured again."""
        w0, c0, s0, r0 = self._initial_state
        self.config.render = r0
        self.world = w0
        self.camera = c0
        self.shadow_state = s0
        self._start_history()
        self.frame_index = 0
        self._prev_keys = np.zeros(NUM_KEYS, bool)
        self._frame_calls = P.CallRing()
        self._last_drops = None

    # -- mid-run config changes, recorded and replayed before the frame
    # they preceded --------------------------------------------------------
    def apply_config_event(self, event: dict):
        cam = {k: float(v) for k, v in event.items()
               if k in _CAMERA_EVENT_KEYS}
        camera = self.camera
        if cam:
            camera = dataclasses.replace(camera, **cam)
        if "window" in event:
            w, h = (int(v) for v in event["window"])
            self.config.render = dataclasses.replace(self.config.render,
                                                     width=w, height=h)
            camera = dataclasses.replace(camera, aspect=w / h)
        self.camera = camera

    def _change_config(self, event: dict):
        self.apply_config_event(event)
        if self.config.record_history:
            self.history.record_event(event)

    def set_draw_distances(self, *, draw_distance=None, near=None, far=None,
                           fov_y=None):
        """Change the camera's draw distances mid-run (recorded)."""
        self._change_config({k: float(v) for k, v in (
            ("draw_distance", draw_distance), ("near", near), ("far", far),
            ("fov_y", fov_y)) if v is not None})

    def set_window(self, width: int, height: int):
        """Change the render resolution and the camera's aspect mid-run
        (recorded). The step reads the aspect through the camera's
        frustum, so every program is captured again."""
        self._change_config({"window": [int(width), int(height)]})

    # -- the programs --------------------------------------------------------
    def _deps(self):
        """What the step programs and the render programs bake in."""
        c = self.config
        st = self._state
        step = (self._step_fn, self.bank, _camera_meta(self._cam_template),
                st.world, torch.are_deterministic_algorithms_enabled(),
                self._tracing)
        render = step + (c.render, self.cubemap, self.atlas,
                         self.compiled_systems, c.render_systems,
                         c.shadow_max_tris, c.shadow_lov_bias,
                         c.shadow_caster_mask,
                         st.shadow and st.shadow[0], self._sh_config)
        return step, render

    def _refresh_programs(self):
        """Drop the programs whose baked configuration changed and build
        their functions again (the JAX package re-jits)."""
        if self._step_fn is None:
            return
        step, render = self._deps()
        if not _same(step, self._baked[0]):
            self._programs.clear()
            self._build_step()
            self._build_render()
        elif not _same(render, self._baked[1]):
            for key in [k for k in self._programs if k[0] != "step"]:
                del self._programs[key]
            self._build_render()
        self._baked = (step, render)

    @property
    def captured_programs(self) -> frozenset:
        """The keys of the programs held: ``("step",)``, ``("frame",
        v)``, ``("render_shadowed", v)``, ``("shadows", "map")`` and
        ``("render", camera configuration, with inputs)``, where ``v`` is
        the shadow schedule's decision: None without shadows, ``"skip"``
        or ``"map"``, one program each whatever the slot count. Programs
        whose configuration changed are dropped first."""
        self._refresh_programs()
        return frozenset(self._programs)

    def _build_step(self):
        """The step program ``_step``: one tick of the world and the
        camera vector, with the step's drop counters."""
        step, bank, cam0 = self._step_fn, self.bank, self._cam_template

        def advance(st):
            P.mark("step")
            camera = cam0.apply_serialized(st.camv)
            inputs, dt = InputState.unpack_with_dt(st.packed)
            world, camera, stats = step(st.world, camera, inputs, dt,
                                        bank.aabb_min, bank.aabb_max)
            return world, camera, inputs, pack_drop_stats(stats)

        def step_only(st):
            world, camera, _, drops = advance(st)
            P.mark("store")
            _store_world(st.world, world)
            _store(st.camv, camera.serialize())
            _store(st.drops, drops)
            P.end()

        self._advance = advance
        self._step = step_only

    def _build_render(self):
        """The programs that render: ``_render`` (the current state through
        a camera vector, the maps as they are), ``_render_shadowed`` (after
        a step: the shadow update, then the render), ``_update_shadow``
        (the update alone) and ``_frame_fused`` (step, update and render).
        They render through ``render_frame``, on the route the settings
        pick: K3 with ``fused_shading=True``, else the tall G-buffers of
        every tile and the shading stage (the JAX package's default). Allocates the
        static image at the settings' size."""
        bank, settings = self.bank, self.config.render
        cubemap, atlas, systems = self.cubemap, self.atlas, \
            self.compiled_systems
        cfg, cam0, advance = self.config, self._cam_template, self._advance
        shadowed = self._state.shadow is not None
        self._state.image = torch.zeros((settings.height, settings.width, 3),
                                        device=self.device)

        def update(st, decision, world, camera):
            """The shadow state after this frame's update: ``decision`` is
            the schedule's (``"map"`` refreshes the slot ``st.slot``)."""
            if not shadowed:
                return None
            sh = self._shadow_view(st.shadow, cursor=st.slot)
            if decision != "map":
                return sh
            return SH._render_shadow_map_now(
                sh, world, camera, bank, max_tris=cfg.shadow_max_tris,
                lov_bias=cfg.shadow_lov_bias,
                caster_mask=cfg.shadow_caster_mask)

        def draw(world, camera, sh, inputs):
            P.mark("render")
            return render_frame(
                world, camera, bank, settings, cubemap=cubemap, atlas=atlas,
                shadow_state=sh, systems=systems, inputs=inputs)

        def render_view(st, meta, with_inputs):
            camera = dataclasses.replace(cam0, **dict(meta))
            inputs = (InputState.unpack_with_dt(st.packed)[0]
                      if with_inputs else None)
            img = draw(st.world, camera.apply_serialized(st.view),
                       update(st, "skip", None, None), inputs)
            P.mark("store")
            st.image.copy_(img)
            P.end()

        def render_shadowed(st, decision):
            camera = cam0.apply_serialized(st.camv)
            P.mark("shadows")
            sh = update(st, decision, st.world, camera)
            img = draw(st.world, camera, sh,
                       InputState.unpack_with_dt(st.packed)[0])
            P.mark("store")
            st.image.copy_(img)
            _store_shadow(st, sh)
            P.end()

        def update_shadow(st, decision):
            P.mark("shadows")
            sh = update(st, decision, st.world, cam0.apply_serialized(st.camv))
            P.mark("store")
            _store_shadow(st, sh)
            P.end()

        def frame_fused(st, decision):
            world, camera, inputs, drops = advance(st)
            P.mark("shadows")
            sh = update(st, decision, world, camera)
            img = draw(world, camera, sh, inputs)
            P.mark("store")
            _store_world(st.world, world)
            _store(st.camv, camera.serialize())
            _store(st.drops, drops)
            _store_shadow(st, sh)
            st.image.copy_(img)
            P.end()

        self._shadow_update = update
        self._render = render_view
        self._render_shadowed = render_shadowed
        self._update_shadow = update_shadow
        self._frame_fused = frame_fused

    def program_function(self, key: tuple):
        """The function of the program ``key`` (see ``captured_programs``):
        ``fn(state)`` reads and writes a ``ProgramState``. Called directly
        it runs eagerly (the card's references)."""
        self._refresh_programs()
        name, *args = key
        fn = {"step": self._step, "frame": self._frame_fused,
              "render_shadowed": self._render_shadowed,
              "shadows": self._update_shadow, "render": self._render}[name]
        return lambda st: fn(st, *args)

    def _capture(self, key: tuple) -> _Program:
        """Build the program ``key``: on the CPU its function; on a card a
        graph captured after two warm-up runs on a side stream over a copy
        of the state (the first builds the kernels and uploads the cached
        constants; the second, like the capture, runs with every operation
        that waits for the device raising)."""
        fn = self.program_function(key)
        # the frame program's marks lie inside a span over all of them
        marks = (P.ProgramMarks(self.device.type == "cuda",
                                "frame" if key[0] == "frame" else None)
                 if self._tracing else None)
        if self.device.type != "cuda":
            if marks is None:
                return _Program(lambda: fn(self._state), {}, [], 0.0)

            def run():
                with marks.recording():
                    fn(self._state)
            return _Program(run, {}, [], 0.0, marks)
        if not self._programs:
            # a private pool lives while a graph uses it: the programs
            # share one, and a new one follows the last program dropped
            self._pool = torch.cuda.graph_pool_handle()
        with torch.cuda.device(self.device):
            prog = capture_program(fn, self._state, self._pool, marks=marks)
            if marks is not None:
                # traced: a second graph with events of its own, replayed
                # in turn with the first, so that a call's events are read
                # while the next call runs (profiling.FrameTracer)
                twin = capture_program(
                    fn, self._state, self._pool,
                    marks=P.ProgramMarks(True, marks.root))
                prog.twin, twin.twin = twin, prog
                prog.seconds = twin.seconds = prog.seconds + twin.seconds
        return prog

    def _program(self, key: tuple):
        """The program ``key``, captured at its first use."""
        self._refresh_programs()
        prog = self._programs.get(key)
        if prog is None:
            prog = self._programs[key] = self._capture(key)
        return prog

    def _replay(self, key: tuple):
        prog = self._program(key)
        tr = self._trace if self._tracing else None
        if tr is None:
            prog()
        else:
            if prog.twin is not None:
                prog = self._programs[key] = prog.twin
            tr.before_replay(prog.marks)
            with tr.host("engine.launch", key):
                tr.anchor()
                prog()
            tr.replayed(key, prog.marks)
        for name in _WRITES[key[0]]:
            self._views.pop(name, None)

    def capture(self, key: tuple):
        """Capture the program ``key`` (see ``captured_programs``) now, as
        its first use would, without running it: a caller that will need
        it later (a replay that continues live past its recording's end)
        keeps the capture out of its frames. A program dropped since (a
        configuration change, ``set_tracing``) is captured again at its
        next use, or by calling this again."""
        self._program(key)

    def capture_seconds(self) -> dict:
        """Seconds each held program took to warm up and capture."""
        return {k: p.seconds for k, p in self._programs.items()}

    def _feed(self, packed: np.ndarray, slot: int = 0):
        """The packed inputs and shadow slot into the static buffer: on a
        card one non-blocking copy from a pinned buffer of a small ring (a
        buffer is written again only after its last copy ran)."""
        tr = self._trace if self._tracing else None
        if tr is not None:
            tr.anchor()
        row = np.append(packed, np.float32(slot))
        if not self._stage:
            self._packed_host[:] = row
            return
        self._stage_at = (self._stage_at + 1) % len(self._stage)
        buf, copied = self._stage[self._stage_at]
        if tr is not None and not copied.query():
            tr.feed_waits += 1  # the engine's only wait for the device
        copied.synchronize()
        buf.numpy()[:] = row
        self._inbox.copy_(buf, non_blocking=True)
        copied.record(torch.cuda.current_stream(self.device))

    def _shadow_decision(self):
        """This frame's shadow decision and slot, advancing the host's
        schedule (``shadow_schedule``)."""
        self._views.pop("shadow", None)
        decision, slot, self._sh_tick, self._sh_cursor = shadow_schedule(
            self._sh_tick, self._sh_cursor,
            self.config.shadow_update_interval, self._state.shadow)
        return decision, slot

    # -- tracing -------------------------------------------------------------
    def set_tracing(self, on: bool):
        """Spans inside the programs and around the calls, off by default
        (module docstring). Switching drops every program; the next calls
        capture them again, with their marks or without. Switching on
        starts a new record; switching off keeps the last one for
        ``trace_report``."""
        on = bool(on)
        if on == self._tracing:
            return
        self._tracing = on
        if on:
            self._trace = P.FrameTracer(self.device)
        self._refresh_programs()

    @property
    def tracer(self) -> P.FrameTracer | None:
        """The recorder of the calls while tracing is on, else None: a
        caller above the engine (``runtime/replay.py``'s ``Player``) opens
        its own calls around the engine's in it and tallies its counters
        there."""
        return self._trace if self._tracing else None

    def _call(self, kind: str, t0: int | None = None):
        """A block that is one traced call ``kind`` (host span, anchor,
        tail) and yields the tracer; with tracing off, nothing and None."""
        return self._trace.call(kind, t0) if self._tracing else _OFF

    def trace_report(self) -> dict:
        """Synchronizes once and returns what tracing recorded: ``frames``,
        every call the ring holds (``profiling.call_dict``: host spans with
        their parents and self times; device spans with their parents,
        programs and self times; the launch, busy, gap and cycle times and
        the idle put down to host spans), and ``counters``: the calls, those
        not read back (``unread``), the input copies that waited for the
        device (``feed_waits``), the kernel launches, the programs held
        (``captures``, ``capture_s``), the step's six drop counters as the
        last step left them (``step_drops``) and the render's
        ``triangle_budget_dropped`` and ``tile_candidate_dropped`` (with
        per-tile light lists on the fused route also ``light_tile_overflow``)
        as the last traced program that renders left them (``render_drops``,
        read from the graph: no geometry runs again); with light lists,
        ``tile_light_pairs`` (the (tile, light) pairs of the frame's lists,
        which K3's list loop walks), read the same way; and, where that
        program shades a system's pixels on the fused route,
        ``custom_tiles_resolved`` (the tiles resolved for the shading
        functions, both layers: on a
        card those in which the G-buffer kernel read a candidate row, on
        the CPU every tile), ``custom_tiles_owned`` (those holding an owned
        pixel of a shading system, counted per layer) and ``custom_pixels``
        (those pixels, both layers), read the same way; where it renders
        on the non-fused route, ``gbuffer_tiles_resolved`` (the tiles of
        both layers in which the G-buffer kernel read a candidate row, those
        holding a covered pixel; on the CPU every tile); and the tallies of
        a caller above the engine (``tracer``: a ``Player``'s
        ``replayed_frames``, ``detached_renders`` and ``live_frames``)."""
        tr = self._trace
        if tr is None:
            return {"frames": [], "counters": {}}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        tr.poll()
        program = self._program_counters()
        counters = {
            "frames": tr.calls, "unread": tr.unread,
            "feed_waits": tr.feed_waits,
            "launches": dict(kernels.LAUNCHES),
            "captures": len(self._programs),
            "capture_s": float(sum(self.capture_seconds().values())),
            "step_drops": unpack_drop_stats(self._state.drops),
            "render_drops": self._render_counters(program)}
        counters.update({k: program[k] for k in WORK_COUNTERS
                         if k in program})
        counters.update(tr.tallies)
        return {"frames": tr.frames(), "counters": counters}

    def _program_counters(self) -> dict:
        """The counters of the last traced call that ran a program, from its
        last program that keeps any (the render's), read from its graph;
        {} where it has none."""
        last = self._trace and self._trace.last
        for _, marks, *_ in reversed(last.programs if last else []):
            if marks.counts:
                return marks.counters()
        return {}

    def _render_counters(self, program: dict | None = None) -> dict:
        """The drop counters among ``program`` (``_program_counters()``
        where None)."""
        if program is None:
            program = self._program_counters()
        return {k: v for k, v in program.items()
                if k not in WORK_COUNTERS}

    def export_spans(self, path: str) -> dict:
        """``trace_report()`` written to ``path`` as JSON lines (the
        counters, then one line a call); returns the report."""
        report = self.trace_report()
        P.export_lines(path, report)
        return report

    # -- frame loop ----------------------------------------------------------
    def step(self, inputs: InputState, dt: float):
        """Advance the world one tick (no render). ``inputs``: host inputs
        with their ``prev_keys`` as the caller sets them."""
        with self._call("engine.step") as tr:
            with tr.host("engine.feed") if tr else _OFF:
                self._feed(inputs.pack_with_dt(dt))
            self._replay(("step",))
        self._last_drops = self._state.drops

    def update_shadows(self):
        """One shadow-map update of the current state (the interval gate
        and the round-robin schedule run on the host; a skipped update
        launches nothing, a map update writes the slot and replays)."""
        with self._call("engine.update_shadows"):
            decision, slot = self._shadow_decision()
            if decision == "map":
                self._state.slot.fill_(slot)
                self._replay(("shadows", "map"))

    def render(self, camera=None, inputs: InputState | None = None
               ) -> torch.Tensor:
        """Render the current state, through ``camera`` (the engine's by
        default), with the current shadow maps, which this does not update:
        (H, W, 3) float32 linear color. ``inputs``: the frame's inputs
        (host or tensor form), for the render systems' draw callbacks."""
        st = self._state
        with self._call("engine.render") as tr:
            if tr is not None:
                tr.anchor()
            if camera is None:
                camera = self._cam_template
                st.view.copy_(st.camv)
            else:
                st.view.copy_(camera.serialize())
            if inputs is not None:
                self._feed(_packed(inputs))
            self._replay(("render", _camera_meta(camera), inputs is not None))
            with tr.host("engine.clone") if tr else _OFF:
                return st.image.clone()

    # the JAX package's name (detached-camera replay views)
    render_only = render

    def _advance_frame(self, inputs, dt, render, advance, clone=False):
        """One frame's programs; the image stays in the static buffer, and
        with ``clone`` a copy of it is returned (else None)."""
        if advance not in (None, "fused", "step"):
            raise ValueError(f"advance must be None, 'fused' or 'step', "
                             f"not {advance!r}")
        t0 = time.perf_counter_ns()
        with self._call("engine.frame", t0) as tr:
            image = self._frame_programs(tr, inputs, dt, render, advance,
                                         clone)
        self._frame_calls.add(t0, time.perf_counter_ns())
        return image

    def _frame_programs(self, tr, inputs, dt, render, advance, clone):
        inputs = inputs if inputs is not None else InputState.idle(
            seed=self.frame_index)
        fused = advance == "fused" or (advance is None and bool(render))
        with tr.host("engine.record") if tr else _OFF:
            if self.config.record_history:
                self.history.record_frame(inputs, dt, fused=fused)
            # last frame's keys ride along as prev_keys: derived from the
            # stream, so replay rebuilds them
            inputs = inputs.with_prev(self._prev_keys)
            self._prev_keys = np.asarray(inputs.keys, bool)
        decision, slot = None, 0
        if fused or render:
            with tr.host("engine.shadow_decision") if tr else _OFF:
                decision, slot = self._shadow_decision()
        # one transfer: the step, the draw callbacks and the shadow update
        # read the same packed vector, live and in a replay
        with tr.host("engine.feed") if tr else _OFF:
            self._feed(inputs.pack_with_dt(dt), slot)
        if fused:
            self._replay(("frame", decision))
        else:
            self._replay(("step",))
            if render:
                self._replay(("render_shadowed", decision))
        self._last_drops = self._state.drops
        self.frame_index += 1
        if not clone:
            return None
        with tr.host("engine.clone") if tr else _OFF:
            return self._state.image.clone()

    def frame(self, inputs: InputState | None = None, dt: float = 1.0 / 60.0,
              render: bool = True, advance: str | None = None):
        """Advance one frame: the step, then the shadow-map update if
        ``render`` or ``advance == "fused"``, then (``render``) the render
        of the stepped state. Returns a fresh image or None.

        ``advance`` is the JAX package's choice of program: ``"fused"``
        (the frame program: step, shadow update and render; the image is
        dropped without ``render``) or ``"step"`` (the step program, plus
        the updating render program if ``render``); None means fused
        exactly when rendering. It is recorded with the frame's raw inputs
        so that logs replay in either package through the same programs.

        The image is not waited for (``fps_stats``: the intervals between
        calls are what the caller's loop achieves)."""
        return self._advance_frame(inputs, dt, render, advance,
                                   clone=bool(render))

    def _burst(self, inputs_list, dts, renders, advance):
        if len(inputs_list) != len(dts):
            raise ValueError(f"{len(inputs_list)} inputs for {len(dts)} dts")
        acc = self._burst_drops
        acc.zero_()
        for inputs, dt, render in zip(inputs_list, dts, renders):
            self._advance_frame(inputs, dt, render, advance)
            # the per-counter max over the burst: an overflow in the
            # middle of it stays visible
            torch.maximum(acc, self._state.drops, out=acc)
        if len(dts):
            self._last_drops = acc
        return self._state.image.clone() if renders and renders[-1] \
            else None

    def _step_many(self, inputs_list, dts, render_last: bool = False):
        """The JAX package's step burst: the step program frame by frame,
        the last one followed by the updating render with
        ``render_last``."""
        n = len(dts)
        return self._burst(inputs_list, dts,
                           [render_last and i == n - 1 for i in range(n)],
                           "step")

    def _frames_scan(self, inputs_list, dts):
        """The JAX package's rendered burst: the frame program for every
        frame; the last image is returned."""
        return self._burst(inputs_list, dts, [True] * len(dts), None)

    def run_frames(self, inputs_list, dts, render_last: bool = False):
        """Step many frames, recorded (when recording) as step frames. With
        ``render_last`` the last one also updates the shadow maps and
        renders; returns its image, else None. Drop counters are the
        per-counter max over the frames."""
        return self._step_many(inputs_list, dts, render_last)

    def run_frames_rendered(self, inputs_list, dts):
        """Step, update the shadows and render every one of many frames;
        returns the last image. For unrecorded runs: it refuses to run
        while recording."""
        if self.config.record_history:
            raise RuntimeError("run_frames_rendered is for unrecorded runs; "
                               "recorded frames go through frame()")
        return self._frames_scan(inputs_list, dts)

    def flush_history(self) -> str | None:
        """Write the history log to ``config.history_dir`` when recording;
        returns the npz path, or None."""
        if self.config.record_history:
            return self.history.write_to_disk(self.config.history_dir)
        return None

    # -- stats ---------------------------------------------------------------
    def fps_stats(self) -> dict:
        """The rate the caller's loop achieves over the last frames
        (``profiling.RING``): ``mean_ms`` and ``p50_ms`` of the intervals
        from one frame's call to the next (the first left out: it holds
        the captures), ``fps`` their mean's inverse, ``dispatch_ms`` the
        mean host time from a call to its return (the device's work is
        not waited for), ``frames`` since the last ``reset`` and
        ``drops``; {} before the first frame."""
        t = self._frame_calls.times()
        if not len(t):
            return {}
        out = {"frames": self._frame_calls.n,
               "dispatch_ms": float((t[:, 1] - t[:, 0]).mean() / 1e6)}
        iv = np.diff(t[:, 0]) / 1e6
        iv = iv[1:] if len(iv) > 1 else iv
        if len(iv):
            out.update(mean_ms=float(iv.mean()),
                       p50_ms=float(np.median(iv)),
                       fps=float(1e3 / max(iv.mean(), 1e-9)))
        out["drops"] = self.drop_stats()
        return out

    def drop_stats(self) -> dict:
        """Budget-overflow counters. The step's six are the step program's
        own (``ProgramState.drops``, written by the graph, read back
        here). The render's are ``render_drop_stats``, which runs the
        frame's geometry and binning again for the current state; with
        tracing on and a last call that rendered, ``triangle_budget_dropped``
        and ``tile_candidate_dropped`` (and with light lists on the fused
        route ``light_tile_overflow``) come instead from its program (the
        graph keeps them, ``trace_report``'s ``render_drops``), and the
        re-run gives the others."""
        out = {}
        if self._last_drops is not None:
            out.update(unpack_drop_stats(self._last_drops))
        out.update(self.render_drop_stats())
        if self._tracing:
            out.update(self._render_counters())
        return out

    def render_drop_stats(self) -> dict:
        """Triangle-budget, tile-candidate, texture-tile, light-list and
        shadow overflow of the current state, by re-running the frame's
        geometry and binning (and, with shadows, the next update's shadow
        batch and binning and the main raster for the per-slot PCF
        budget). The texture-tile and light-list counters are reported on
        the tiled backends whichever shading they take, as the JAX package
        reports them (only the fused route applies those budgets), and not
        on ``backend="jnp"``. A diagnostic
        off the frame's path: it launches K1 once with shadows and reads
        the counters back once."""
        if self.bank is None:
            return {}
        s = self.config.render
        cfg = s.raster
        world, camera, bank = self._state.world, self.camera, self.bank
        batch = to_screen(build_triangle_batch(
            world, bank, camera, max_tris=s.max_tris,
            systems=self.compiled_systems), s.width, s.height)
        tiles_x = -(-s.width // cfg.tile_w)
        tiles_y = -(-s.height // cfg.tile_h)
        tri_class = RP._tri_class(batch)
        cand, counts, cand_dropped = RP._candidate_table(
            batch, cfg, tiles_x, tiles_y, tri_class, with_dropped=True)
        out = {"triangle_budget_dropped":
               (batch.total_requested - s.max_tris).clamp(min=0),
               "tile_candidate_dropped": cand_dropped}
        tiled_path = s.backend != "jnp"
        if self.atlas is not None and tiled_path:
            # textured-candidate tiles beyond texture_tile_budget render
            # untextured (a candidate-level superset of textured winners)
            ttb = max(1, int(round(tiles_x * tiles_y
                                   * s.texture_tile_budget)))
            tex = bank.mat_texture[batch.material.clamp(
                0, bank.mat_texture.shape[0] - 1).long()] >= 0
            tri_tex = tex & batch.valid
            tex_cand = ((cand >= 0) & tri_tex[cand.clamp(
                0, batch.budget - 1).long()]).any(dim=1)
            out["texture_tile_overflow"] = (
                tex_cand.sum(dtype=torch.int32) - ttb).clamp(min=0)
        if s.light_tile_budget > 0 and tiled_path:
            # the selection does not depend on depth, so this reproduces
            # the render's exact counts
            lights = LG.extract_lights(
                world, max_dir=s.max_dir_lights, max_point=s.max_point_lights,
                max_spot=s.max_spot_lights)
            ltab, n_live = SP.pack_lights(
                lights, s.max_dir_lights + s.max_point_lights
                + s.max_spot_lights)
            out["light_tile_overflow"] = SP.select_tile_lights(
                ltab, n_live, camera.position, T.inv44(camera.proj_view()),
                tiles_x, tiles_y, cfg.tile_h, cfg.tile_w, s.width, s.height,
                0.0, s.light_tile_budget)[2]
        sh = None if self._state.shadow is None else self._shadow_view(
            self._state.shadow, self._sh_cursor, self._sh_tick)
        if sh is not None:
            c = self.config
            # the batch the NEXT update would rasterize (same schedule)
            _, _, light, face, do_render = SH.choose_light(sh, world,
                                                           camera.position)
            spv = SH.light_proj_view(world, light, face=face)
            sbatch = SH.shadow_batch(world, camera, bank, spv,
                                     max_tris=c.shadow_max_tris,
                                     lov_bias=c.shadow_lov_bias,
                                     caster_mask=c.shadow_caster_mask)
            out["shadow_triangle_dropped"] = (
                sbatch.total_requested - c.shadow_max_tris).clamp(min=0)
            # casters the light camera cannot see (junk without a light)
            out["shadow_caster_outside_volume"] = torch.where(
                do_render, SH.casters_outside_volume(world, light, spv), 0)
            scfg = SH.shadow_raster_cfg(c.shadow_max_tris)
            res = c.shadow_resolution
            out["shadow_tile_candidate_dropped"] = _bin_triangles(
                to_screen(sbatch, res, res), scfg, -(-res // scfg.tile_w),
                -(-res // scfg.tile_h))[-1]
            d, wn, *_ = RP._launch(batch, s.height, s.width, cfg, tri_class,
                                   two_pass=True, cand=cand, counts=counts)
            out["shadow_tile_overflow"] = shadow_tile_overflow(
                sh, d, wn, tiles_x, cfg.tile_h, cfg.tile_w, s.width,
                s.height, T.inv44(camera.proj_view()), 0.0,
                s.shadow_tile_budget)
        vals = torch.stack([v.to(torch.int64).reshape(())
                            for v in out.values()]).tolist()
        return dict(zip(out, vals))
