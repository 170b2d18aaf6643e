"""The multi-card frame as programs: the partitioned step and the band
render captured as CUDA graphs over NCCL.

Port of what the JAX package's multichip dry run compiles
(``__graft_entry__.dryrun_multichip``: ``jax.jit(full_frame,
in_shardings=(world_sharding, rep, rep, rep))``, the step followed by
``render_frame_sharded``, and the scale phase's sharded step), in the
form of the Engine's programs (``runtime/engine.py``): functions over a
``ProgramState`` of static buffers, captured once at first use and
replayed every frame.

Each rank's state holds this rank's ``capacity / n`` rows of every world
column (``shard_world``), the camera vector, the packed inputs with dt and
the shadow slot (fed as the Engine feeds them), the shadow tables, the
step counters and the gathered image. Two program kinds:

* ``("step",)``: the partitioned step (``shard_step``) of this rank's
  rows; the stepped rows, the camera and the counters are written back;
* ``("frame", decision)``: the partitioned step, the whole world gathered
  (``gather_world``), the shadow update for this frame's decision, this
  rank's band (``render_frame_sharded``) and the bands joined
  (``gather_image``). The decision is the Engine's shadow schedule (None
  without shadows, ``"skip"`` or ``"map"``; a map frame's slot is fed as
  data), as for ``Engine``'s ``("frame", decision)`` programs.

On a CUDA mesh the programs are captured (``capture_program``, the
Engine's capture: two warm-ups on a side stream over a copy of the state,
every operation of this thread that waits for the device raising) and
only replayed:
there is no eager route on the card, and a program that cannot be
captured raises. The NCCL collectives (DTensor's functional all-gathers
and all-reduces, the world's and the image's all-gathers) are recorded
into the graphs. On a CPU mesh (gloo) the same functions run eagerly. A
CUDA mesh over gloo is refused (``GLOO_CUDA_REFUSED``).

Every rank must replay the same programs in the same order, since each
graph holds collectives. The decision and slot come from host integers
every rank advances alike, so the ranks agree by construction; the first
use of each program checks it with one ``all_gather_object`` of its key.

The Engine's tracing (``Engine.set_tracing``) has no counterpart here: these
captures arm no marks, so the marks in the shared step, shadow and render
functions (``runtime/profiling.py``) return at once.

What a program may depend on is what the Engine's may (its module
docstring): per-frame values reach it only through the packed inputs,
the shadow slot and the camera vector. DTensor's host-side sharding
propagation runs at capture only; a replay repeats its device work.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from render_engine_tpu_torch.ecs.world import World
from render_engine_tpu_torch.logic.step import pack_drop_stats
from render_engine_tpu_torch.logic.types import InputState
from render_engine_tpu_torch.parallel.mesh import (Mesh, gather_world,
                                                   shard_world)
from render_engine_tpu_torch.parallel.render import (gather_image,
                                                     render_frame_sharded)
from render_engine_tpu_torch.parallel.step import shard_step
from render_engine_tpu_torch.runtime import engine as E

# why a CUDA mesh over gloo is refused: a probe of each collective in 2
# processes on one H100, torch 2.11 (its findings are in PERF.md)
GLOO_CUDA_REFUSED = (
    "gloo moves CUDA tensors through torch.distributed's all_gather_into_"
    "tensor, all_reduce, all_gather and all_gather_object and the "
    "functional all_reduce, but the functional all-gather DTensor issues "
    "(_c10d_functional's all_gather_into_tensor and its wait_tensor) ends "
    "the rank with SIGSEGV on CUDA tensors; the multi-rank evidence is the "
    "CPU tests (2, 4 and 8 gloo ranks) and scripts/multigpu_torch.py under "
    "torchrun on 4 cards")


class ShardedPrograms:
    """The partitioned step and the sharded frame of ``eng`` over
    ``mesh``, from ``eng``'s current state.

    ``eng`` (an ``Engine`` built alike on every rank, on ``mesh.device``)
    lends its configuration: the step, the bank, the camera's static
    fields, the render settings, the skybox, the atlas, the render systems
    and the shadow configuration, as they are when this is made (make a
    new one after changing them). The state is this object's own: frames
    here do not move ``eng``, which stays usable as the single-device
    reference, and the two share only the packed input buffer, which
    each fills before each of its replays. The bands render through the
    fused tiled path whatever ``fused_shading`` says (``render_frame_band``),
    so the frame equals ``Engine.frame`` of an engine with
    ``fused_shading=True`` (the demo's setting), as the JAX package's dry
    run compares them (``__graft_entry__.py:142``)."""

    def __init__(self, eng, mesh: Mesh):
        if mesh.device.type == "cuda" and \
                dist.get_backend(mesh.group) != "nccl":
            raise RuntimeError("a CUDA mesh needs NCCL: "
                               f"{GLOO_CUDA_REFUSED}")
        if eng.device.type != mesh.device.type:
            raise ValueError(f"the engine is on {eng.device}, the mesh's "
                             f"rank on {mesh.device}")
        eng._refresh_programs()  # the closures of its current settings
        self.eng, self.mesh = eng, mesh
        st = eng._state
        self._state = E.ProgramState(
            world=shard_world(st.world, mesh).clone(), camv=st.camv.clone(),
            shadow=st.shadow and tuple(t.clone() for t in st.shadow),
            packed=st.packed, view=st.view.clone(), drops=st.drops.clone(),
            image=st.image.clone(), slot=st.slot)
        self._sh_tick, self._sh_cursor = eng._sh_tick, eng._sh_cursor
        self._prev_keys = eng._prev_keys.copy()
        self.frame_index = eng.frame_index
        self._programs: dict = {}
        self._pool = None
        self._build()

    def _build(self):
        eng, mesh = self.eng, self.mesh
        stepped = shard_step(eng._step_fn, mesh)
        bank, cam0 = eng.bank, eng._cam_template
        settings = eng.config.render
        cubemap, atlas, systems = eng.cubemap, eng.atlas, \
            eng.compiled_systems
        update = eng._shadow_update

        def advance(st):
            camera = cam0.apply_serialized(st.camv)
            inputs, dt = InputState.unpack_with_dt(st.packed)
            rows, camera, stats = stepped(st.world, camera, inputs, dt,
                                          bank.aabb_min, bank.aabb_max)
            return rows, camera, inputs, pack_drop_stats(stats)

        def store(st, rows, camera, drops):
            E._store_world(st.world, rows)
            E._store(st.camv, camera.serialize())
            E._store(st.drops, drops)

        def step(st):
            rows, camera, _, drops = advance(st)
            store(st, rows, camera, drops)

        def frame(st, decision):
            rows, camera, inputs, drops = advance(st)
            world = gather_world(rows, mesh)
            sh = update(st, decision, world, camera)
            band = render_frame_sharded(
                world, camera, bank, settings, mesh, cubemap=cubemap,
                atlas=atlas, shadow_state=sh, systems=systems,
                inputs=inputs)
            img = gather_image(band, mesh, settings.height)
            store(st, rows, camera, drops)
            E._store_shadow(st, sh)
            st.image.copy_(img)

        self._step, self._frame = step, frame

    # -- the programs ------------------------------------------------------
    def program_function(self, key: tuple):
        """The function of the program ``key`` (``("step",)`` or
        ``("frame", decision)``): ``fn(state)`` reads and writes a
        ``ProgramState`` of this rank's rows. Called directly it runs
        eagerly (the card's reference)."""
        name, *args = key
        fn = {"step": self._step, "frame": self._frame}[name]
        return lambda st: fn(st, *args)

    def _capture(self, key: tuple) -> E._Program:
        fn = self.program_function(key)
        if self.mesh.device.type != "cuda":
            return E._Program(lambda: fn(self._state), {}, [], 0.0)
        with torch.cuda.device(self.mesh.device):
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            # ProcessGroupNCCL's watchdog thread queries the events of the
            # eager collectives (the warm-ups', the key check's) on its own
            # thread; the global mode forbids a potentially unsafe call in
            # any thread while this one captures. Thread-local keeps every
            # check on the capturing thread.
            return E.capture_program(fn, self._state, self._pool,
                                     error_mode="thread_local")

    def _replay(self, key: tuple):
        prog = self._programs.get(key)
        if prog is None:
            keys = [None] * self.mesh.size
            dist.all_gather_object(keys, key, group=self.mesh.group)
            if any(k != key for k in keys):
                raise RuntimeError(f"the ranks would run different "
                                   f"programs: {keys}")
            prog = self._programs[key] = self._capture(key)
        prog()

    @property
    def captured_programs(self) -> frozenset:
        """The keys of the programs held."""
        return frozenset(self._programs)

    def capture_seconds(self) -> dict:
        """Seconds each held program took to warm up and capture."""
        return {k: p.seconds for k, p in self._programs.items()}

    # -- frames ------------------------------------------------------------
    def step(self, inputs: InputState, dt: float):
        """Advance the world one tick, partitioned (no render).
        ``inputs``: host inputs with their ``prev_keys`` as the caller sets
        them, alike on every rank."""
        self.eng._feed(inputs.pack_with_dt(dt))
        self._replay(("step",))

    def frame(self, inputs: InputState | None = None,
              dt: float = 1.0 / 60.0) -> torch.Tensor:
        """One frame, as ``Engine.frame`` gives it: the partitioned step,
        the shadow update, the bands rendered and joined. Returns a fresh
        (H, W, 3) image, the whole frame on every rank. ``inputs`` alike
        on every rank (idle, seeded by the frame index, by default); the
        last frame's keys ride along as ``prev_keys``."""
        inputs = inputs if inputs is not None else InputState.idle(
            seed=self.frame_index)
        inputs = inputs.with_prev(self._prev_keys)
        self._prev_keys = np.asarray(inputs.keys, bool)
        decision, slot, self._sh_tick, self._sh_cursor = E.shadow_schedule(
            self._sh_tick, self._sh_cursor,
            self.eng.config.shadow_update_interval, self._state.shadow)
        self.eng._feed(inputs.pack_with_dt(dt), slot)
        self._replay(("frame", decision))
        self.frame_index += 1
        return self._state.image.clone()

    # -- the state, read outside the programs --------------------------------
    @property
    def rows(self) -> World:
        """A copy of this rank's rows of the world."""
        return self._state.world.clone()

    @property
    def world(self) -> World:
        """The whole world on every rank (an all-gather: every rank calls
        it together)."""
        return gather_world(self._state.world, self.mesh).clone()

    @property
    def camera(self):
        return self.eng._cam_template.apply_serialized(
            self._state.camv.clone())

    @property
    def drops(self) -> torch.Tensor:
        """The last step's (6,) int32 drop counters (``unpack_drop_stats``
        names them)."""
        return self._state.drops.clone()

    @property
    def shadow_state(self):
        sh = self._state.shadow
        return None if sh is None else self.eng._shadow_view(
            tuple(t.clone() for t in sh), self._sh_cursor, self._sh_tick)
