#!/usr/bin/env python3
"""Drive the PyTorch + CUDA port (render_engine_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase catches its own):
  1. build   compile csrc/*.cu (one nvcc per source, in parallel, sm_90a)
             into one library and time it;
  2. kernels run the space scene at 1920x1080 with shadows (1024^2 maps,
             2 slots, an update every 3 frames) to its fourth frame, which
             renders a shadow map with both slots mapped; keep the inputs of
             every K1 call of that frame (the one-pass shadow raster, then
             the two-pass main raster), of K2 (resolve) and of K3 (fused
             shade with the shadow-slot factors), then run each kernel and
             its plain PyTorch version on them on the card: K1 (both modes)
             and K2 must match exactly, K3 within 1e-5; time each;
  3. frame   the same state, shadow maps included, rendered through the
             kernels and through the plain versions must agree (the image
             within 1e-5), and Engine.render() must leave the shadow state
             as it was;
  4. small   the 128x32 / 10-asteroid engine, 4 frames on the card against
             the same frames on the CPU (plain versions), without shadows
             and with them (128^2 maps, 6 slots, an update every frame):
             world columns, camera, every drop counter, the shadow state
             and the image as the CPU parity tests hold them;
  5. slice   build_space_engine at 1920x1080, 10,000 asteroids, capacity
             16384, max_tris 16384, with the demo's shadow defaults; 3
             warm-up and 30 timed frames (torch.cuda.synchronize per frame);
             each frame must launch K1 twice when its update renders a map
             (host tick % 3 == 0) and once otherwise, K2 and K3 once, and
             give a finite (1080,1920,3) image; then all 13 drop counters
             (6 step, 7 render) must be 0. Frames are not recorded here.
  6. replay  frames timed with recording off and on in turns (off, on,
             on, off); then, under torch.use_deterministic_algorithms(True),
             the same engine records 12 frames (rendered, step-only and
             one fused frame without an image, a draw-distance change
             before frame 6, a 2^32-1 seed), flushes the log (timed) and
             loads it; a second full-size engine replays it with each
             frame's live render flag: world hashes, launches per frame and
             the images of the rendered frames must equal the live run's,
             and the shadow state and draw distance at the end too. Then a
             replay with the detached camera (Esc, then W and a mouse
             turn): the same hashes, finite images unlike the live ones;
             then past the end, Up (one live frame, paused) and Right
             (RUN). Then, with deterministic algorithms off, 10,000
             headline frames recorded headless (each followed by the
             engine's shadow update), flushed, loaded and replayed on a
             fresh engine with the detached camera, every frame rendered,
             each Player.step after warm-up under sync debug mode
             "error": the world hash after every frame and the shadow
             state at the end equal the live run's, and no program is
             captured after warm-up.
  7. lights  the many-lights configuration: 1280x720, 200 asteroids, 256
             point lights made from a seed (radii 40 to 90), 268 light-table
             rows, light_tile_budget 96, two render systems. K1 (both
             modes) and K2 on a frame's inputs against their plain versions
             (exact) and the frame through kernels against plain versions
             (1e-5); K3 with the frame's per-tile light lists against its
             plain version (1e-5) and the loop over every light (equal); the
             frame at budget 96 against budget 0 (torch.equal while
             light_tile_overflow is 0); all 14 drop counters 0; launches a
             frame; K3's items a tile and a block and its critical path
             (the most light iterations of one thread) with one block a
             tile and with a block for every 256 pixels; K3 with every
             pixel covered in both layers and 96-entry lists against its
             plain version (1e-5); times of K3 with lists, dense and all
             covered (in turns with --earlier), of select_tile_lights, and
             ms/frame in turns budget 0, 96, 96, 0.
  8. custom  the 1080p/10k engine again with a fragment-shading function on
             the lit system and a draw callback on the light sources: the
             hook's G-buffer kernel (custom_gbuffer, both layers in one
             launch) against its plain version on every pixel of both
             layers, with its time, bound and the plain version's time; K2
             over every tile of a layer (531 MB, the plain version's first
             step, no longer launched on this frame) on the same slot plane
             against its plain version (exact) and one torch.gather; the
             frame through kernels against plain versions; pixels the
             shading system does not own equal the frame without it;
             launches a frame (custom_gbuffer one, K2 one, over the
             textured tiles only); ms/frame with and without the function
             in turns; peak device memory.
  9. golden  a 256x144 engine with a cubemap skybox: the golden path
             (backend="jnp") against the fused path on the card, and the
             card against the CPU.
  10. configs the benchmark configurations of
             benchmarks/run_benchmarks_torch.py at their full scene size,
             with frame counts cut (the lights configuration is phase 7's):
             scene at 800x600 (7 tile columns, the last one 32 pixels wide:
             K1 in both modes, K2 and K3 on a frame's inputs against their
             plain versions, and the frame through kernels against plain
             versions); asteroids (10,000 under a thrusting patrol,
             collision_large_budget 64: all 13 drop counters 0, a finite
             image); tick (a 100,000-entity world, capacity 131,072: the
             entities alive, the step counters, the device time of the
             step's random draws in a graph, a rendered frame at max_tris
             49152 with K1, K2 and K3 against their plain versions, peak
             device memory); playback (300 step frames recorded and replayed bit
             for bit, two steps past the end, 10 recorded 1080p frames).
             Each prints its JSON line.
  11. bands  (run right after phase 3, as phase 12) the captured frame of
             phase 2 (1080p, 10,000 asteroids, both shadow slots mapped)
             in 4 bands of tile rows through parallel.render_frame_band,
             one after another on the card: each band launches K1, K2 and
             K3 once; K1, K2 and K3 on band 2's inputs against their plain
             versions (exact, exact, 1e-5); the bands joined equal to
             render_frame at tile budgets 1.0 (torch.equal), and at the
             headline's budgets, where a band's budget counts its own
             tiles, within the JAX package's limits (max diff below 0.03,
             at most 0.5% of pixels beyond 1e-6); then a one-rank NCCL
             group (a file:// store in the build directory) through
             make_mesh, scripts/multigpu_torch.sharded_frame (the
             partitioned step of the rank's rows, the world gathered,
             render_frame_sharded) and gather_image, whose
             image and world hash must equal Engine.frame's (torch.equal),
             and shard_world / gather_world's world hash; ms of 4 bands
             against one frame in turns, as a record. The engine's state
             (history and frame times included) is put back.
  12. nonfused the same frame through the non-fused tiled path (a
             shadow_factor callback: the one the golden path builds from
             the shadow maps): K1 once, the tall G-buffer kernel once over
             every tile of both layers, no K2, no K3;
             the frame through kernels against plain versions (1e-5) and
             against the fused frame at tile budgets 1.0: 99.5% of pixels
             within 1e-2 and median 0; without shadows max diff below
             0.05; with shadows at pcf_scale 1 at most 1e-5 of the pixels
             at 0.05 or more, none beyond 1/9, and each where the two
             routes' PCF factors differ on the card (fused: camera NDC
             through one composed matrix; non-fused: the unprojected world
             position), the routes also computed on the host's CPU from
             the same depth as a record; peak device memory; the render's
             ms against the fused one in turns.
  13. programs the Engine's captured programs (CUDA graphs over its
             static buffers, fed by the packed input vector) against the
             same programs' functions run eagerly from the same state
             (``Eager``), step by step: world hash, image (torch.equal),
             shadow state, step counters and kernel launches equal. On the
             headline (27 frames, every fifth a step frame and the updating
             render, one of 4.5 s that fires the mine spawner; run_frames
             with the last frame rendered; run_frames_rendered; render();
             render_only through a detached camera; step()), the
             unshadowed frame on the same routes, custom shading,
             lights-720p-256, scene-800x600 and tick-100k's step. Warm-up
             and capture run with every operation that waits for the
             device raising (the Engine's own rule). Prints the programs
             captured, their capture seconds, the graph pool's MiB,
             ms/frame graphed against eager in turns, and a profile of each:
             host API launches and device kernels a frame, device time and
             busy share, with K1, K2 and K3 counted in the trace equal to
             the launch counts.
  14. partitioned the partitioned step (parallel.shard_step: the tick
             on DTensors sharded by entity) on a one-rank NCCL group
             against the Engine's captured step, frame by frame: the
             headline world (1080p engine, 10,000 asteroids, capacity
             16384) for 8 step frames, one of 4.5 s that fires the mine
             spawner, and tick-100k's world (capacity 131,072) for 3
             steps; every column, the world hash, the camera and the 6
             step counters equal (torch.equal), no kernel launched; the
             partitioned step's eager ms against the captured step's in
             turns, as a record. A line first says why no 2 gloo ranks
             share the card (GLOO_CUDA_REFUSED: the functional
             all-gather DTensor issues crashes on CUDA tensors under
             gloo; PERF.md).
  15. mesh  the partitioned step and the sharded frame as programs
             (parallel.ShardedPrograms: CUDA graphs captured over NCCL) on
             the one-rank NCCL group of phases 11 and 14, against the
             Engine's captured programs: the headline's 8 step frames (one
             of 4.5 s that fires the mine spawner) and tick-100k's 3 steps,
             every column, the world hash, the camera and the 6 counters
             equal (torch.equal), no kernel launched; then, at tile budgets
             1.0, interval x slots + 1 = 7 frames of the captured sharded
             frame against Engine.frame (image torch.equal, world hash,
             shadow state and K1 / K2 / K3 launches each frame equal; every
             kernel of the path launched), and an eighth frame's program
             function run eagerly through the plain versions against its
             replay (image within 1e-5, world and shadow tables equal); the
             collectives a step and a frame (CommDebugMode), capture
             seconds, graph pool MiB, and ms in turns: the captured
             partitioned step against the Engine's captured step and the
             step's function run eagerly, the captured sharded frame
             against Engine.frame. On one rank DTensor issues no
             collective: the multi-rank capture is scripts/
             multigpu_torch.py's on 4 cards.
  16. default-route the JAX package's default render route,
             RenderSettings(fused_shading=False), through the Engine's
             captured programs at the headline's size (build_space_engine
             at 1080p with 10,000 asteroids and the demo's shadows, the
             setting made the engine's initial one): the native OBJ parser
             loaded and the station's parse equal to the Python parse, with
             the ms of each; 33 captured frames, each launching K1 twice
             on map frames and once on the rest, the tall G-buffer kernel
             (csrc/tall_gbuffer.cu, both layers) once, the shading kernel
             (csrc/deferred_shade.cu) once and no K2 or K3, a finite lit
             image, all 13 drop counters 0, peak device memory; every
             route of phase 13 (32 steps) captured against eager bit for
             bit (world hash, image, shadow state, counters, launches),
             capture seconds and graph pool MiB; a frame that renders a map
             through the eager programs, its K1 (both modes) against its
             plain version, exact, and the tall G-buffer kernel against its
             plain version (K2 over every tile and the chain, rows of A =
             48) on every plane and every pixel of both layers, equal to
             the bit (TALL_TOL), with its record (device ms, bound, share,
             plain ms); the frame through the kernels against the
             plain versions (1e-5); the shading kernel against its plain
             version on that frame's arguments (the flags equal, every
             composed pixel and covered plane within 1e-5, the share of
             pixels beyond 2/255 reported), with its record (device ms,
             bound, share, plain ms); K2's record on the same frame's
             opaque slot plane (resolve_nonfused, no longer launched on
             this route: device ms, bound, torch.gather); a profile (host
             API calls, device rows and time a frame, busy share, the rows
             that take the most device time); the shading kernel's launches a frame
             on both routes (1 and 0); ms a captured frame in turns
             against a second engine on the fused route; both engines'
             graph pools; last, the shading kernel against its plain
             version, as above, on frames that take its other branches
             (DEFERRED_FRAMES: every texture role and per-pixel
             shininess; directional, spot and point rows with dead rows
             of each kind; six slots at pcf_scale 1 and 3; the shadowed
             head of four point rows and chunks of 5 to 7 rows), on the
             many-lights engine on this route and on this engine with a
             fragment-shading system, whose textured G-buffer planes the
             kernel writes.
Every phase drives the captured Engine. Where a phase holds a kernel
against its plain version on a frame's own inputs (phases 2, 3, 7, 8, 10),
that frame runs through ``Eager``, so the kernel wrappers see each call;
the launch counts of captured frames are the counts each program's capture
recorded, added on every replay.
The last three lines are the kernels' JSON record, the card's name and
power limit (nvidia-smi), and {"ok": true, "device": {...}}.

Each kernel's record carries its bound (render_engine_tpu_torch/
kernel_bounds.py, from the captured inputs) and K2 the time of one
torch.gather computing the same values. The kernels phase also runs
synthetic cases made with numpy from a seed: K1 in both modes on an
adversarial candidate table (exact), K3 with every pixel covered in both
layers and with none covered (1e-5).

    python3 chip_smoke.py --earlier DIR

also builds the kernels of DIR/render_engine_tpu_torch/csrc (an earlier
checkout) and times them on the same captured inputs in turns (earlier,
current, current, earlier); their time goes into the records' earlier_ms,
which is null without the option.

    python3 chip_smoke.py --shadow-routes profile_out/shadow_routes.npz

also writes phase 12's shadowed frame's inputs (depth and winner tiles,
shadow maps, camera) and both routes' factors, which
scripts/shadow_routes_jax.py holds against the JAX package's two routes.
"""

from __future__ import annotations

import argparse
import copy
import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

SLICE = dict(width=1920, height=1080, capacity=16384, num_asteroids=10000,
             max_tris=16384)
SMALL = dict(width=128, height=32, capacity=128, num_asteroids=10,
             max_tris=2048)
WARMUP, TIMED = 3, 30
DT = 1.0 / 60.0
# phase 6: each recorded frame's render flag; frame REPLAY_FUSED_AT
# advances as a fused frame without an image
REPLAY_RENDER = (True, True, False, True, False, True, True, False, True,
                 True, True, True)
REPLAY_FUSED_AT = 4
REPLAY_DRAW_AT, REPLAY_DRAW_DISTANCE = 6, 1200.0
REPLAY_BIG_SEED_AT = 2
# phase 6, with deterministic algorithms off: the headline's recording of
# so many frames replayed with a detached camera (BASELINE.json config 5)
REPLAY_LONG = 10000
REPLAY_LONG_STRETCH = 300  # frames of W and a mouse turn, then of idle
RECORD_TURNS, TURN_FRAMES = ("off", "on", "on", "off") * 5, 10
CAPTURE_FRAME = 3  # frames 0 and 3 render maps at interval 3: both slots
# phase 7: the many-lights configuration at its full size
# (demo.space_scene.build_many_lights_engine)
LIGHTS = dict(width=1280, height=720)
N_POINT_LIGHTS, LIGHT_TILE_BUDGET = 256, 96
BUDGET_TURNS = (0, LIGHT_TILE_BUDGET, LIGHT_TILE_BUDGET, 0) * 3
SHADE_TURNS = ("without", "with", "with", "without") * 3
TCOUNT_BINS = (0, 1, 9, 17, 33, 49, 65, 81, 97)
ITEM_BINS = (0, 1, 33, 129, 257, 513, 1025, 2049)  # K3 items a tile / block
GOLDEN = dict(width=256, height=144, capacity=256, num_asteroids=64,
              max_tris=8192)
# phase 10: frame counts of the benchmark configurations (their scene
# sizes are the benchmark script's own, at scale 1)
CONFIG_FRAMES = dict(scene=10, asteroids=10, tick=10, tick_burst=10,
                     playback=300, playback_recorded=10)
CONFIG_SCALE = 1.0  # the benchmark script's BENCH_SCALE: full size
SCENE_FIXED_ENTITIES = 6  # beside the asteroids: stars, ship, station, ...

KERNELS = {  # record name -> (launch-count key, source, TPU kernel)
    "tile_raster": ("tile_raster",
                    "render_engine_tpu_torch/csrc/tile_raster.cu",
                    "render_engine_tpu/render/raster_pallas.py:37"),
    "tile_raster_one_pass": ("tile_raster_one_pass",
                             "render_engine_tpu_torch/csrc/tile_raster.cu",
                             "render_engine_tpu/render/raster_pallas.py:37"),
    "resolve": ("resolve", "render_engine_tpu_torch/csrc/resolve.cu",
                "render_engine_tpu/render/raster_pallas.py:476"),
    "fused_shade": ("fused_shade",
                    "render_engine_tpu_torch/csrc/fused_shade.cu",
                    "render_engine_tpu/render/shade_pallas.py:249"),
    # K2 over every tile of a layer (phase 8: the K2 launches of its run
    # whose slot planes hold every tile of the frame) and K3 over per-tile
    # light lists (phase 7): their launches come from those phases' runs
    "resolve_full_frame": ("resolve_full_frame",
                           "render_engine_tpu_torch/csrc/resolve.cu",
                           "render_engine_tpu/render/raster_pallas.py:476"),
    "fused_shade_tile_lists": ("fused_shade_tile_lists",
                               "render_engine_tpu_torch/csrc/fused_shade.cu",
                               "render_engine_tpu/render/shade_pallas.py:249"),
    # K2 over every tile of each layer on the JAX package's default route
    # (phase 16): since the tall G-buffer kernel it launches none there
    "resolve_nonfused": ("resolve_nonfused",
                         "render_engine_tpu_torch/csrc/resolve.cu",
                         "render_engine_tpu/render/raster_pallas.py:476"),
    # the default route's tall G-buffers (phase 16): K2 over every tile
    # fused with the chain after it; the JAX package leaves the route to
    # XLA, so it replaces no Pallas kernel
    "tall_gbuffer": ("tall_gbuffer",
                     "render_engine_tpu_torch/csrc/tall_gbuffer.cu", None),
    # the default route's shading (phase 16): the JAX package leaves it to
    # XLA, so it replaces no Pallas kernel
    "deferred_shade": ("deferred_shade",
                       "render_engine_tpu_torch/csrc/deferred_shade.cu",
                       None),
    # the custom-shading hook's G-buffer (phase 8): the JAX package forms it
    # in XLA, so it replaces no Pallas kernel
    "custom_gbuffer": ("custom_gbuffer",
                       "render_engine_tpu_torch/csrc/custom_gbuffer.cu",
                       None),
}
MAIN_PATH = ("tile_raster", "tile_raster_one_pass", "resolve", "fused_shade")
# phase 11: bands of tile rows, and the image limits of the JAX package's
# sharded render (tests/test_parallel.py, __graft_entry__.py:198-203)
BANDS = 4
BAND_MAX_DIFF, BAND_MAX_SHARE = 0.03, 0.005
BAND_TURNS = ("frame", "bands", "bands", "frame") * 2
# phase 12: the non-fused frame against the fused one (tests/
# test_frame_tiled.py:277, shadows at shadow_tile_budget 1.0)
NONFUSED_MAX_DIFF = 0.05
NONFUSED_FLIPS = 1e-5  # share of pixels whose PCF taps may flip
FLIP_MAX = 1.0 / 9.0  # ceiling on a flipped pixel's change (0.0587 seen)
NONFUSED_TURNS = ("fused", "nonfused", "nonfused", "fused") * 2
# phase 16: the shading kernel against its plain version: every composed
# pixel and covered plane within DEFERRED_TOL; the share of pixels beyond
# two 8-bit steps is reported
DEFERRED_TOL = 1e-5
DEFERRED_STEP = 2.0 / 255.0
# phase 8: the custom-shading hook's G-buffer kernel against its plain
# version, every plane of both layers (0: equal to the bit)
CUSTOM_TOL = 0.0
# phase 16: the default route's tall G-buffer kernel against its plain
# version, every plane and key of both layers (0: equal to the bit)
TALL_TOL = 0.0
# the frames of tests/deferred_scenes.py the kernel is held on beyond the
# headline's: label -> (scene, pcf_scale or None for no shadow maps,
# width, height, extra point lights, max_point_lights). The lit scene's
# point rows: with maps a shadowed head of four, then a chunk of six (two
# dead); without, one chunk of seven or of five, every row live
DEFERRED_FRAMES = {
    "featured": ("featured", None, 600, 340, 0, 4),
    "lit, pcf_scale 1": ("lit", 1, 600, 340, 7, 10),
    "lit, pcf_scale 3": ("lit", 3, 600, 340, 7, 10),
    "lit, no maps, a chunk of 7": ("lit", None, 600, 340, 6, 7),
    "lit, no maps, a chunk of 5": ("lit", None, 600, 340, 4, 5),
}
DROP_KEYS = 13  # 6 step counters and 7 render counters with shadows
DROP_KEYS_LIGHTS = 14  # and light_tile_overflow with a light-list budget
LIVE_BINS = (0, 1, 9, 17, 33, 65, 129, 257)  # K1 live candidates a tile


def log(*a):
    print(*a, flush=True)


def device_ms(fn, reps):
    """The device's ms per call: ``reps`` calls enqueued behind a sleeping
    kernel, so that the host's cost of issuing them is hidden, timed by
    CUDA events; the median of 3 such runs."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    torch.cuda._sleep(10 ** 7)
    b.record()
    torch.cuda.synchronize()
    cycles_per_ms = 1e7 / a.elapsed_time(b)
    runs = []
    for _ in range(3):
        torch.cuda._sleep(int(cycles_per_ms * (2.0 * reps * host_ms + 1.0)))
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        runs.append(a.elapsed_time(b) / reps)
    return statistics.median(runs)


def cuda_ms(fn, reps):
    """Median of ``reps`` single-call times in ms, by CUDA events (the
    host's cost of issuing the call included)."""
    import torch

    fn()  # warm
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def max_abs(a, b):
    return max(float((x.double() - y.double()).abs().max()) if x.numel()
               else 0.0 for x, y in zip(a, b))


class Capture:
    """Wrap a module function: keep a copy of every call's arguments (or
    what ``note`` makes of them), then delegate."""

    def __init__(self, module, name, note=None):
        self.module, self.name, self.note = module, name, note
        self.fn = getattr(module, name)
        self.calls = []

    def __call__(self, *args, **kw):
        import torch

        def keep(v):
            return v.clone() if isinstance(v, torch.Tensor) else v
        if self.note is not None:
            self.calls.append(self.note(*args, **kw))
        else:
            self.calls.append(([keep(a) for a in args],
                               {k: keep(v) for k, v in kw.items()}))
        return self.fn(*args, **kw)

    def __enter__(self):
        setattr(self.module, self.name, self)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class Plain:
    """Route the six kernel wrappers to their plain PyTorch versions on
    the card (for the whole-frame comparison)."""

    def __enter__(self):
        from render_engine_tpu_torch.render import custom_gbuffer as CG
        from render_engine_tpu_torch.render import deferred_shade as DS
        from render_engine_tpu_torch.render import raster_pallas as RP
        from render_engine_tpu_torch.render import shade_pallas as SP
        from render_engine_tpu_torch.render import tall_gbuffer as TG

        self.saved = [(RP, "tile_raster", RP.tile_raster),
                      (RP, "resolve_attributes_pallas",
                       RP.resolve_attributes_pallas),
                      (SP, "shade_tiles", SP.shade_tiles),
                      (DS, "deferred_shade", DS.deferred_shade),
                      (TG, "tall_gbuffer", TG.tall_gbuffer),
                      (CG, "custom_gbuffer", CG.custom_gbuffer)]
        RP.tile_raster = RP.tile_raster_reference
        RP.resolve_attributes_pallas = (
            lambda slot, rows, cfg=None:
            RP.resolve_attributes_reference(slot, rows))
        SP.shade_tiles = SP.fused_shade_reference
        DS.deferred_shade = DS.deferred_shade_reference
        TG.tall_gbuffer = TG.tall_gbuffer_reference
        CG.custom_gbuffer = CG.custom_gbuffer_reference
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


class Eager:
    """Run an engine's programs by calling their functions
    (``Engine.program_function``) on its state instead of replaying their
    CUDA graphs: the card's eager reference for the captured frame, and
    the route on which the kernel wrappers (and so ``Capture`` and
    ``Plain``) see every call."""

    def __init__(self, eng):
        self.eng, self.on = eng, False

    def __enter__(self):
        eng = self.eng
        eng._program = lambda key: (
            lambda: eng.program_function(key)(eng._state))
        self.on = True
        return self

    def __exit__(self, *exc):
        del self.eng._program
        self.on = False


class Library:
    """Route the kernel wrappers' launches to another loaded library."""

    def __init__(self, lib):
        self.lib = lib

    def __enter__(self):
        from render_engine_tpu_torch import kernels

        self.saved = kernels.library()
        kernels._lib = self.lib
        return self

    def __exit__(self, *exc):
        from render_engine_tpu_torch import kernels

        kernels._lib = self.saved


def kernel_ms(name, kern, earlier):
    """The kernel's device ms (see device_ms); with an earlier
    library, in turns earlier, current, current, earlier, and then also the
    earlier kernel's ms (each the mean of its two turns)."""
    if earlier is None:
        return device_ms(kern, 20), None
    turns = []
    for which in ("earlier", "current", "current", "earlier"):
        if which == "earlier":
            with Library(earlier):
                turns.append(device_ms(kern, 20))
        else:
            turns.append(device_ms(kern, 20))
    log(f"[kernels] {name} in turns (earlier, current, current, earlier): "
        f"{', '.join(f'{t:.4f}' for t in turns)} ms")
    return (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2


def histogram(counts, bins):
    """'[lo,hi): n, ...' over consecutive bin edges."""
    return ", ".join(
        f"[{lo},{hi}): {int(((counts >= lo) & (counts < hi)).sum())}"
        for lo, hi in zip(bins, bins[1:]))


def live_histogram(counts, k, tile_budget, trans_budget):
    from render_engine_tpu_torch import kernel_bounds as KB

    per_tile = KB.k1_live(counts, k, tile_budget, trans_budget).sum(1)
    return histogram(per_tile, LIVE_BINS) + (
        f"; max {int(per_tile.max())}, mean {float(per_tile.double().mean()):.1f}")


def synthetic_k1(two_pass, seed, dev):
    """An adversarial K1 table, 16 x 8 tiles of 8x128 with B = 112, BT = 64
    and a full global list of 32: small triangles, vertices on pixel
    centres, slivers (collinear, and 1e-3 and 1e-6 off; short, and long
    ones starting just past a pixel centre on their line), coordinates up
    to 1e6 and beyond 2^24, NaN coordinates and exact depth ties (a
    candidate repeated under another id); every fourth tile has full
    windows."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    tiles_x, tiles_y, th, tw = 16, 8, 8, 128
    bud, tbud, glob = 112, 64, 32
    k, nt = bud + tbud + glob, tiles_x * tiles_y
    ox = ((np.arange(nt) % tiles_x) * tw)[:, None].astype(np.float64)
    oy = ((np.arange(nt) // tiles_x) * th)[:, None].astype(np.float64)
    cx = ox + rng.uniform(-6, tw + 6, (nt, k))
    cy = oy + rng.uniform(-6, th + 6, (nt, k))
    v = np.stack([cx, cy] * 3, axis=1) + rng.uniform(-5, 5, (nt, 6, k))
    kind = rng.integers(0, 8, (nt, k))
    # vertices on pixel centres: edges run through centres
    on = kind == 1
    v = np.where(on[:, None], np.floor(v) + 0.5, v)
    # slivers: the third vertex on (or just off) the first two's line
    sl = kind == 2
    length = rng.uniform(5, 400, (nt, k))
    ang = rng.uniform(0, 2 * np.pi, (nt, k))
    off = rng.choice([0.0, 1e-3, 1e-6], (nt, k))
    ex, ey = np.cos(ang), np.sin(ang)
    bx, by = v[:, 0] + length * ex, v[:, 1] + length * ey
    mx = 0.5 * (v[:, 0] + bx) - off * ey
    my = 0.5 * (v[:, 1] + by) + off * ex
    for i, arr in ((2, bx), (3, by), (4, mx), (5, my)):
        v[:, i] = np.where(sl, arr, v[:, i])
    # long slivers on a line through a pixel centre, starting just past it
    # (the rounded edge test can accept centres beyond the vertex box)
    ls = kind == 7
    px0, py0 = ox + np.floor(cx - ox) + 0.5, oy + np.floor(cy - oy) + 0.5
    start = rng.uniform(0.5, 20, (nt, k))
    far = 10.0 ** rng.uniform(1, 6, (nt, k))
    ax, ay = px0 + start * ex, py0 + start * ey
    long_sliver = (ax, ay, ax + far * ex, ay + far * ey,
                   ax + 0.5 * far * ex - off * far * ey,
                   ay + 0.5 * far * ey + off * far * ex)
    for i, arr in enumerate(long_sliver):
        v[:, i] = np.where(ls, arr, v[:, i])
    # huge coordinates: one vertex far away, up to 1e6 or beyond 2^24
    for kd, scale in ((3, 1e6), (4, 4e7)):
        far = kind == kd
        which = rng.integers(0, 3, (nt, k))
        for c in range(3):
            m = far & (which == c)
            v[:, 2 * c] = np.where(m, rng.uniform(-scale, scale, (nt, k)),
                                   v[:, 2 * c])
            v[:, 2 * c + 1] = np.where(m, rng.uniform(-scale, scale,
                                                      (nt, k)), v[:, 2 * c + 1])
    z = rng.uniform(-1.2, 1.2, (nt, 3, k))
    cls = (rng.integers(1, 3, (nt, k)) if two_pass
           else np.ones((nt, k))).astype(np.float64)
    cls[rng.random((nt, k)) < 0.05] = 0.0
    data = np.concatenate([v, z, cls[:, None]], axis=1).astype(np.float32)
    nan = kind == 5
    data[:, 0][nan] = np.nan
    ids = (np.arange(nt)[:, None] * k + np.arange(k)[None]).astype(np.int32)
    # exact ties: a candidate repeats its predecessor under another id
    tie = kind == 6
    tie[:, 0] = False
    src = np.where(tie, np.arange(k)[None] - 1, np.arange(k)[None])
    data = np.take_along_axis(data, src[:, None, :], axis=2)
    # the global list: the same 32 big triangles in every tile
    g = rng.uniform([-600, -300] * 3, [2648, 364] * 3, (glob, 6)).T
    data[:, :6, bud + tbud:] = g[None].astype(np.float32)
    data[:, 6:9, bud + tbud:] = rng.uniform(-1.2, 1.2, (3, glob))[None]
    data[:, 9, bud + tbud:] = 1.0
    ids[:, bud + tbud:] = nt * k + np.arange(glob)
    n0 = np.where(np.arange(nt) % 4 == 0, bud, rng.integers(0, bud + 1, nt))
    n1 = (np.where(np.arange(nt) % 4 == 0, tbud,
                   rng.integers(0, tbud + 1, nt)) if two_pass
          else np.zeros(nt, np.int64))
    counts = np.stack([n0, n1, np.full(nt, glob)], axis=1)[:, None, :]
    args = [torch.from_numpy(data).to(dev),
            torch.from_numpy(ids[:, None, :].copy()).to(dev),
            torch.from_numpy(counts.astype(np.int32)).to(dev)]
    kw = dict(tiles_x=tiles_x, tile_h=th, tile_w=tw, tile_budget=bud,
              trans_budget=tbud, two_pass=two_pass)
    return args, kw


def synthetic_k3(a3, kw3, covered, seed):
    """K3 on the captured frame's lights, camera, overrides and slot
    factors, with every pixel covered in both layers (random slots, depths
    in [-0.99, 0.99]) or none. Each tile's rows are attribute rows that
    covered pixels of the frame referenced, moved onto one triangle that
    encloses the tile, so every pixel's barycentrics stay in [0, 1]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    rows, s_o, s_t, d_o, d_t, *rest = a3
    nt, k, _ = rows.shape
    th, tw = s_o.shape[1], s_o.shape[2]
    dev = rows.device
    cov = s_o >= 0
    t_idx = torch.arange(nt, device=dev)[:, None, None].expand_as(s_o)[cov]
    good = rows[t_idx, s_o[cov].long()]
    pick = torch.from_numpy(rng.integers(0, good.shape[0], (nt, k))).to(dev)
    syn = good[pick].clone()
    tids = torch.arange(nt, device=dev)
    ox = ((tids % kw3["tiles_x"]) * tw).float()[:, None]
    oy = (torch.div(tids, kw3["tiles_x"], rounding_mode="floor")
          * th).float()[:, None]
    jit = torch.from_numpy(rng.uniform(0, 50, (nt, k, 6))).float().to(dev)
    syn[:, :, 0] = ox - 200 - jit[..., 0]
    syn[:, :, 1] = oy - 200 - jit[..., 1]
    syn[:, :, 2] = ox + 3 * tw + 400 + jit[..., 2]
    syn[:, :, 3] = oy - 200 - jit[..., 3]
    syn[:, :, 4] = ox - 200 - jit[..., 4]
    syn[:, :, 5] = oy + 3 * th + 400 + jit[..., 5]
    shape = (nt, th, tw)
    if covered:
        so = torch.from_numpy(rng.integers(0, k, shape).astype(np.int32))
        st = torch.from_numpy(rng.integers(0, k, shape).astype(np.int32))
        do = torch.from_numpy(rng.uniform(-0.99, 0.99, shape)).float()
        dt = torch.from_numpy(rng.uniform(-0.99, 0.99, shape)).float()
    else:
        so = st = torch.full(shape, -1, dtype=torch.int32)
        do = dt = torch.ones(shape)
    return ([syn.contiguous(), so.to(dev), st.to(dev), do.to(dev),
             dt.to(dev), *rest], kw3)


def k2_gather(slot, rows):
    """K2's values from one torch.gather: rows with one zero row appended,
    channels leading, empty slots pointed at the zero row (the index is
    built here, outside the timed call)."""
    import torch

    tb, th, tw = slot.shape
    _, k, a = rows.shape
    table = torch.cat([rows, rows.new_zeros(tb, 1, a)], dim=1).permute(
        2, 0, 1).contiguous()  # (A, TB, K + 1)
    flat = slot.reshape(tb, th * tw).long()
    idx = torch.where((flat >= 0) & (flat < k), flat, k)[None].expand(
        a, tb, th * tw).contiguous()
    return lambda: [torch.gather(table, 2, idx).reshape(a, tb, th, tw)]


def kernel_record(name, tol, kern, plain, work, library=None, earlier=None,
                  plain_reps=3):
    """One kernel on captured inputs against its plain version (``tol`` 0:
    exact): its device ms (in turns with an ``earlier`` library's), the
    plain version's and the library call's, its bound and share."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB

    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = check_close(name, got, want, tol)
    ms, earlier_ms = kernel_ms(name, kern, earlier)
    call_ms = cuda_ms(kern, 20)
    plain_ms = cuda_ms(plain, plain_reps)
    library_ms = None
    if library is not None:
        check_close(f"{name} (torch.gather)", library(), want, 0.0)
        library_ms = device_ms(library, 20)
    bound_ms, bound_by = KB.bound(work["bytes"], work["ops"])
    log(f"[kernels] {name}: max_abs_err {err:.3g} (tolerance {tol}) "
        f"kernel {ms:.4f} ms (one call with its host cost "
        f"{call_ms:.4f} ms), plain {plain_ms:.3f} ms"
        + ("" if library_ms is None else f", torch.gather "
           f"{library_ms:.4f} ms")
        + ("" if earlier_ms is None else f", earlier {earlier_ms:.4f} ms")
        + f"; bound {bound_ms:.4f} ms by {bound_by} ({work}), share "
        f"{bound_ms / ms:.3f}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, library_ms=library_ms,
                earlier_ms=earlier_ms)


def phase_build():
    from render_engine_tpu_torch import kernels

    t0 = time.perf_counter()
    kernels.build(verbose=True)
    kernels.library()
    log(f"[build] nvcc {' '.join(kernels.NVCC_FLAGS)}: "
        f"{time.perf_counter() - t0:.1f} s")


def phase_kernels(eng, earlier=None):
    """Frames 0-2, then frame 3 with every kernel call's inputs captured;
    each kernel against its plain version on those inputs, its bound and
    (K2) its one-call yardstick; then the synthetic cases. Returns
    per-kernel records."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP

    for _ in range(CAPTURE_FRAME):
        eng.frame(None, DT)
    with Eager(eng), Capture(RP, "tile_raster") as k1, \
            Capture(RP, "resolve_attributes_pallas") as k2, \
            Capture(SP, "shade_tiles") as k3:
        img = eng.frame(None, DT)
        torch.cuda.synchronize()
    if tuple(img.shape) != (SLICE["height"], SLICE["width"], 3):
        raise RuntimeError(f"frame {CAPTURE_FRAME} has shape "
                           f"{tuple(img.shape)}")
    modes = [kw["two_pass"] for _, kw in k1.calls]
    if modes != [False, True] or len(k2.calls) < 1 or len(k3.calls) != 1:
        raise RuntimeError(
            f"frame {CAPTURE_FRAME} made K1 calls with two_pass {modes}, "
            f"{len(k2.calls)} K2 and {len(k3.calls)} K3 calls; expected the "
            "shadow raster, the main raster, K2 and one K3")
    (a1s, kw1s), (a1, kw1) = k1.calls
    a2, _ = k2.calls[0]
    a3, kw3 = k3.calls[0]
    sh = eng.shadow_state
    log(f"[kernels] frame {CAPTURE_FRAME}: shadow slots "
        f"{sh.slot_entity.tolist()}, faces {sh.slot_face.tolist()}, tick "
        f"{sh.tick}, cursor {sh.cursor}")
    if kw3["sf"] is None or int((kw3["sfi"] >= 0).sum()) == 0:
        raise RuntimeError("K3 got no shadow-slot factor tiles")
    if int((sh.slot_entity >= 0).sum()) != 2:
        raise RuntimeError("both shadow slots should be mapped")
    for name, (a, kw) in (("K1 one-pass", (a1s, kw1s)), ("K1", (a1, kw1))):
        log(f"[kernels] {name} inputs: data {tuple(a[0].shape)}, counts max "
            f"{a[2][:, 0].max(0).values.tolist()}, two_pass "
            f"{kw['two_pass']}; live candidates a tile: "
            + live_histogram(a[2], a[0].shape[2], kw["tile_budget"],
                             kw["trans_budget"]))
    log(f"[kernels] K2 inputs: slot {tuple(a2[0].shape)}, rows "
        f"{tuple(a2[1].shape)}")
    log(f"[kernels] K3 inputs: rows {tuple(a3[0].shape)}, ltab "
        f"{tuple(a3[5].shape)}, overrides "
        f"{None if kw3['ovr'] is None else tuple(kw3['ovr'].shape)}, slot "
        f"factors {tuple(kw3['sf'].shape)}, inverse map "
        f"{tuple(kw3['sfi'].shape)} with {int((kw3['sfi'] >= 0).sum())} "
        "mapped tiles")

    # name, tolerance, kernel, plain version, work, one-call yardstick
    cases = [
        ("tile_raster_one_pass", 0.0,
         lambda: RP.tile_raster(*a1s, **kw1s),
         lambda: RP.tile_raster_reference(*a1s, **kw1s),
         KB.tile_raster_work(*a1s, **kw1s), None),
        ("tile_raster", 0.0,
         lambda: RP.tile_raster(*a1, **kw1),
         lambda: RP.tile_raster_reference(*a1, **kw1),
         KB.tile_raster_work(*a1, **kw1), None),
        ("resolve", 0.0,
         lambda: [RP.resolve_attributes_pallas(*a2)],
         lambda: [RP.resolve_attributes_reference(*a2)],
         KB.resolve_work(*a2), k2_gather(*a2)),
        ("fused_shade", 1e-5,
         lambda: [SP.shade_tiles(*a3, **kw3)],
         lambda: [SP.fused_shade_reference(*a3, **kw3)],
         KB.fused_shade_work(*a3, **kw3), None),
    ]
    rec = {name: kernel_record(name, tol, kern, plain, work, library,
                               earlier=earlier)
           for name, tol, kern, plain, work, library in cases}

    synthetic = [(f"synthetic K1 two_pass={tp}", 0.0, *synthetic_k1(tp, 3 + tp, a1[0].device),
                  RP.tile_raster, RP.tile_raster_reference)
                 for tp in (False, True)]
    synthetic += [(f"synthetic K3 {'all' if c else 'none'} covered", 1e-5,
                   *synthetic_k3(a3, kw3, c, 5), lambda *a, **kw: [
                       SP.shade_tiles(*a, **kw)],
                   lambda *a, **kw: [SP.fused_shade_reference(*a, **kw)])
                  for c in (True, False)]
    for name, tol, args, kw, kern, plain in synthetic:
        got, want = kern(*args, **kw), plain(*args, **kw)
        torch.cuda.synchronize()
        err = check_close(name, got, want, tol)
        log(f"[kernels] {name}: max_abs_err {err:.3g} (tolerance {tol}), "
            f"kernel {device_ms(lambda: kern(*args, **kw), 5):.4f} ms")
    return rec


def check_close(name, got, want, tol):
    """Max abs error; raise unless equal (tol 0) or within rtol = atol =
    tol."""
    import torch

    err = max_abs(got, want)
    if tol == 0.0:
        ok = all(torch.equal(g, w) for g, w in zip(got, want))
    else:
        ok = all(torch.allclose(g, w, rtol=tol, atol=tol)
                 for g, w in zip(got, want))
    if not ok:
        raise RuntimeError(f"{name} disagrees with its plain version "
                           f"(max abs err {err})")
    return err


def phase_frame(eng):
    """The current state, shadow maps included, rendered through the
    kernels and through the plain versions; render() must not touch the
    shadow state."""
    import torch

    sh = eng.shadow_state
    maps = sh.maps.clone()
    img_k = eng.render()
    with Eager(eng), Plain():
        img_p = eng.render()
    torch.cuda.synchronize()
    if eng.shadow_state is not sh or not torch.equal(sh.maps, maps):
        raise RuntimeError("Engine.render() moved the shadow state")
    err = float((img_k - img_p).abs().max())
    log(f"[frame] kernels vs plain versions, whole 1080p frame with shadows "
        f"(tick {sh.tick}, cursor {sh.cursor}): max abs diff {err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"frame through the kernels differs by {err}")


def _same_shadow_state(i, sc, sg):
    """The CPU and card shadow states: schedule exactly, light matrices
    within 1e-5 and maps within the stated tolerance."""
    import torch

    for name in ("slot_entity", "slot_face"):
        if not torch.equal(getattr(sc, name), getattr(sg, name).cpu()):
            raise RuntimeError(f"small frame {i}: shadow {name} differs")
    if (sc.cursor, sc.tick) != (sg.cursor, sg.tick):
        raise RuntimeError(f"small frame {i}: shadow cursor/tick differ")
    if not torch.allclose(sg.light_mats.cpu(), sc.light_mats, rtol=1e-5,
                          atol=1e-5):
        raise RuntimeError(f"small frame {i}: light matrices differ")
    # maps: K1 is exact on equal inputs, but the light camera's last bits
    # differ between the CPU and the card (trig, 4x4 products), and CUDA's
    # "/ 3.0" in the binning's depth bucket multiplies by the reciprocal:
    # a triangle edge can cross a texel center, or an overflowing tile
    # window can keep another far candidate. So at most 0.5% of texels may
    # differ by more than 1e-5.
    far = ((sg.maps.cpu() - sc.maps).abs() > 1e-5).double().mean()
    log(f"[small] frame {i}: shadow maps, share of texels differing by more "
        f"than 1e-5: {float(far):.4%}")
    if float(far) > 5e-3:
        raise RuntimeError(f"small frame {i}: shadow maps differ")


def frame_inputs(i):
    """Frame i's inputs: idle, then W, then W with a mouse turn."""
    import numpy as np

    from render_engine_tpu_torch.logic.types import KEY_W, InputState

    inp = InputState.idle(i)
    if i == 1:
        return inp.with_keys(KEY_W)
    if i >= 2:
        return dataclasses.replace(
            inp.with_keys(KEY_W),
            mouse_delta=np.array([0.02, -0.01], np.float32))
    return inp


def phase_small():
    """4 frames of the small engine on the card against the CPU, without
    and with shadows."""
    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.render.frame import to_srgb_u8

    for shadows in (False, True):
        tag = "with shadows" if shadows else "no shadows"
        engines = {d: build_space_engine(device=d, enable_shadows=shadows,
                                         **SMALL)
                   for d in ("cpu", "cuda")}
        for i in range(4):
            inp = frame_inputs(i)
            imgs = {d: e.frame(inp, DT).cpu() for d, e in engines.items()}
            wc, wg = engines["cpu"].world, engines["cuda"].world
            if not torch.equal(wc.alive, wg.alive.cpu()):
                raise RuntimeError(f"small frame {i}: alive differs")
            for name in ("type_id", "model_id", "flags"):
                if not torch.equal(wc[name], wg[name].cpu()):
                    raise RuntimeError(f"small frame {i}: {name} differs")
            for name in ("position", "velocity", "orientation", "aabb_min",
                         "aabb_max"):
                if not torch.allclose(wg[name].cpu(), wc[name], rtol=1e-5,
                                      atol=1e-4):
                    raise RuntimeError(f"small frame {i}: {name} differs")
            cams = [e.camera.serialize().cpu() for e in engines.values()]
            if not torch.allclose(cams[0], cams[1], rtol=1e-5, atol=1e-5):
                raise RuntimeError(f"small frame {i}: camera differs")
            drops = [e.drop_stats() for e in engines.values()]
            if drops[0] != drops[1]:
                raise RuntimeError(f"small frame {i}: drop counters {drops}")
            if shadows:
                if len(drops[0]) != DROP_KEYS:
                    raise RuntimeError(f"small frame {i}: {len(drops[0])} "
                                       f"drop counters, expected {DROP_KEYS}")
                _same_shadow_state(i, engines["cpu"].shadow_state,
                                   engines["cuda"].shadow_state)
            diff = float((imgs["cpu"] - imgs["cuda"]).abs().max())
            u8 = float((to_srgb_u8(imgs["cpu"]) != to_srgb_u8(imgs["cuda"]))
                       .double().mean())
            log(f"[small] {tag}, frame {i}: image max abs diff {diff:.3g}, "
                f"u8 values differing {u8:.2%}")
            if not (diff <= 2.0 / 255.0 and u8 <= 1e-3):
                raise RuntimeError(f"small frame {i}: image differs")
        log(f"[small] {tag}: 4 frames agree, drop counters "
            f"{engines['cuda'].drop_stats()}")


def phase_slice(eng):
    """Warm-up and timed frames of the full slice with shadows; launch
    counts per frame; the 13 drop counters."""
    import torch

    from render_engine_tpu_torch import kernels

    eng.reset()
    interval = eng.config.shadow_update_interval
    kernels.reset_launch_counts()
    times = []
    img = None
    shadow_frames = 0
    for i in range(WARMUP + TIMED):
        before = dict(kernels.LAUNCHES)
        renders_map = eng.shadow_state.tick % interval == 0
        shadow_frames += renders_map
        t0 = time.perf_counter()
        img = eng.frame(None, DT)
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        per_frame = {k: n - before[k] for k, n in kernels.LAUNCHES.items()}
        want = frame_launches(renders_map)
        if per_frame != want:
            raise RuntimeError(f"frame {i} launched {per_frame}, expected "
                               f"{want}")
    launches = dict(kernels.LAUNCHES)
    frames = WARMUP + TIMED
    log(f"[slice] launches in {frames} frames: {launches} ({shadow_frames} "
        f"frames render a shadow map: K1 twice on those, once on the rest; "
        "K2 and K3 once a frame)")
    if tuple(img.shape) != (SLICE["height"], SLICE["width"], 3):
        raise RuntimeError(f"image shape {tuple(img.shape)}")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("image has non-finite values")
    lit = float((img.amax(dim=-1) > 0.05).double().mean())
    log(f"[slice] image {tuple(img.shape)}, max {float(img.max()):.3f}, "
        f"share of pixels above 0.05: {lit:.3f}")
    # space is black: the asteroids, stars and station light about 0.7%
    # of the 1080p frame
    if not (float(img.max()) > 0.5 and lit > 1e-3):
        raise RuntimeError("the image is (nearly) blank")
    med = statistics.median(times)
    log(f"[slice] {TIMED} timed frames: median {med:.2f} ms/frame, min "
        f"{min(times):.2f}, max {max(times):.2f} "
        f"({1e3 / med:.1f} frames/s)")
    drops = eng.drop_stats()
    log(f"[slice] drop counters ({len(drops)}): {drops}")
    if len(drops) != DROP_KEYS or any(drops.values()):
        raise RuntimeError(f"expected {DROP_KEYS} drop counters, all 0")
    return launches


def frame_launches(renders_map, resolve=1, tile_lists=0, deferred=0,
                   custom=0, tall=0):
    """The launches one frame must make: K1 twice when it renders a shadow
    map and once otherwise, K2 ``resolve`` times, K3 once (``tile_lists``:
    1 when it loops over lists), the default route's shading kernel
    ``deferred`` times and its G-buffer kernel ``tall`` times, the
    custom-shading hook's G-buffer kernel ``custom`` times."""
    return {"tile_raster": 1 + int(renders_map),
            "tile_raster_one_pass": int(renders_map), "resolve": resolve,
            "fused_shade": 1, "fused_shade_tile_lists": tile_lists,
            "deferred_shade": deferred, "tall_gbuffer": tall,
            "custom_gbuffer": custom}


def hold_kernels(eng, label, k3=False):
    """One more frame of ``eng``, which must render a shadow map, with
    every kernel call's inputs captured: K1 in both modes and K2 (the
    frame's first call) against their plain versions at this path's
    shapes, exact; with ``k3`` also K3 within 1e-5. Returns the frame."""
    import torch

    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP

    with Eager(eng), Capture(RP, "tile_raster") as k1, \
            Capture(RP, "resolve_attributes_pallas") as k2, \
            Capture(SP, "shade_tiles") as k3c:
        img = eng.frame(None, DT)
    modes = [kw["two_pass"] for _, kw in k1.calls]
    if modes != [False, True] or len(k2.calls) != 1 or len(k3c.calls) != 1:
        raise RuntimeError(f"{label}: K1 calls with two_pass {modes}, "
                           f"{len(k2.calls)} K2 calls, {len(k3c.calls)} K3 "
                           "calls")
    for (a, kw), name in zip(k1.calls, ("K1 one-pass", "K1")):
        err = check_close(f"{label} {name}", RP.tile_raster(*a, **kw),
                          RP.tile_raster_reference(*a, **kw), 0.0)
        log(f"[{label}] {name} on this frame's inputs (data "
            f"{tuple(a[0].shape)}, tile_budget {kw['tile_budget']}, "
            f"trans_budget {kw['trans_budget']}): max_abs_err {err:.3g} "
            "(exact)")
    a2 = k2.calls[0][0]
    err = check_close(f"{label} K2", [RP.resolve_attributes_pallas(*a2)],
                      [RP.resolve_attributes_reference(*a2)], 0.0)
    log(f"[{label}] K2 on this frame's inputs (slot {tuple(a2[0].shape)}, "
        f"rows {tuple(a2[1].shape)}): max_abs_err {err:.3g} (exact)")
    if k3:
        a3, kw3 = k3c.calls[0]
        err = check_close(f"{label} K3", [SP.shade_tiles(*a3, **kw3)],
                          [SP.fused_shade_reference(*a3, **kw3)], 1e-5)
        covered = int((a3[1] >= 0).sum()) + int((a3[2] >= 0).sum())
        log(f"[{label}] K3 on this frame's inputs (rows "
            f"{tuple(a3[0].shape)}, {covered} covered items, slot factors "
            f"{None if kw3['sf'] is None else tuple(kw3['sf'].shape)}): "
            f"max_abs_err {err:.3g} (tolerance 1e-05)")
    torch.cuda.synchronize()
    return img


def frame_through_plain(eng, label, what):
    """The current state through the kernels and through the plain
    versions: the images within 1e-5."""
    import torch

    img_k = eng.render()
    with Eager(eng), Plain():
        img_p = eng.render()
    torch.cuda.synchronize()
    err = float((img_k - img_p).abs().max())
    log(f"[{label}] kernels vs plain versions, {what}: max abs diff "
        f"{err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"{label}: the frame through the kernels differs "
                           f"by {err}")
    return img_k


def launch_delta(before):
    from render_engine_tpu_torch import kernels

    return {k: n - before[k] for k, n in kernels.LAUNCHES.items()}


def timed_frame(fn):
    """fn() and its ms, synchronized."""
    from render_engine_tpu_torch.runtime.profiling import timed

    return timed(fn)


def turn_medians(eng, turns, start, label, what=""):
    """Median ms/frame of TURN_FRAMES rendered frames a turn, each turn
    begun by ``start(which)`` (which resets the engine into that kind);
    per kind the median of its turn medians."""
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm

    return tm(lambda: eng.frame(None, DT), turns, start, frames=TURN_FRAMES,
              log=log, label=label, what=what)[0]


def record_turns(eng):
    """ms/frame with recording off and on, in RECORD_TURNS order."""
    def start(which):
        eng.config.record_history = which == "on"
        eng.reset()

    turns = turn_medians(eng, RECORD_TURNS, start, "replay", "recording ")
    eng.config.record_history = False
    return turns


def record_live(eng):
    """Record the REPLAY_RENDER frames on ``eng`` from a reset; flush and
    load the log. Returns the log, each frame's hash, launches and image,
    the frames' ms, the flush ms and the npz size."""
    import tempfile

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.runtime.history import HistoryLog
    from render_engine_tpu_torch.utils.hashing import world_hash

    eng.config.record_history = True
    eng.reset()
    live, live_ms = [], []
    kernels.reset_launch_counts()
    for i, render in enumerate(REPLAY_RENDER):
        if i == REPLAY_DRAW_AT:
            eng.set_draw_distances(draw_distance=REPLAY_DRAW_DISTANCE)
        inp = frame_inputs(i)
        if i == REPLAY_BIG_SEED_AT:
            inp = dataclasses.replace(inp, rng_seed=2**32 - 1)
        before = dict(kernels.LAUNCHES)
        img, ms = timed_frame(lambda: eng.frame(
            inp, DT, render=render,
            advance="fused" if i == REPLAY_FUSED_AT else None))
        live_ms.append(ms)
        live.append(dict(hash=world_hash(eng.world),
                         launches=launch_delta(before), img=img))
    with tempfile.TemporaryDirectory() as d:
        eng.config.history_dir = d
        path, flush_ms = timed_frame(eng.flush_history)
        size = os.path.getsize(path)
        history = HistoryLog.load(d)
    eng.config.record_history = False
    log(f"[replay] live: {len(REPLAY_RENDER)} frames (render "
        f"{''.join('TF'[not r] for r in REPLAY_RENDER)}, frame "
        f"{REPLAY_FUSED_AT} fused without an image), launches "
        f"{dict(kernels.LAUNCHES)}; flush of the {eng.config.capacity}-row "
        f"baseline {flush_ms:.1f} ms, npz {size} bytes")
    if history.num_frames != len(REPLAY_RENDER):
        raise RuntimeError(f"the log holds {history.num_frames} frames")
    return history, live, live_ms, flush_ms, size


def replay_checked(eng, eng2, history, live):
    """Replay ``history`` on ``eng2`` with each frame's live render flag;
    hashes, launches and images must equal the live frames', and the
    shadow state and draw distance ``eng``'s at the end. Returns the
    launches and each frame's ms."""
    import torch

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.runtime.replay import Player
    from render_engine_tpu_torch.utils.hashing import world_hash

    kernels.reset_launch_counts()
    player = Player(eng2, history)
    replay_ms = []
    for i, render in enumerate(REPLAY_RENDER):
        before = dict(kernels.LAUNCHES)
        (img, _), ms = timed_frame(lambda: player.step(render=render))
        replay_ms.append(ms)
        got, want = launch_delta(before), live[i]
        if world_hash(eng2.world) != want["hash"]:
            raise RuntimeError(f"replayed frame {i}: world hash differs")
        if got != want["launches"]:
            raise RuntimeError(f"replayed frame {i} launched {got}, live "
                               f"{want['launches']}")
        if (img is None) != (want["img"] is None) or (
                img is not None and not torch.equal(img, want["img"])):
            raise RuntimeError(f"replayed frame {i}: image differs")
    launches = dict(kernels.LAUNCHES)
    a, b = eng.shadow_state, eng2.shadow_state
    if not (all(torch.equal(getattr(a, n), getattr(b, n)) for n in
                ("maps", "light_mats", "slot_entity", "slot_face"))
            and (a.cursor, a.tick) == (b.cursor, b.tick)):
        raise RuntimeError("replay: shadow state differs at the end")
    if eng2.camera.draw_distance != REPLAY_DRAW_DISTANCE:
        raise RuntimeError("replay: the draw-distance change was lost")
    missing = [k for k in MAIN_PATH if launches[k] == 0]
    if missing:
        raise RuntimeError(f"replay launched no {missing}")
    log(f"[replay] {len(REPLAY_RENDER)} replayed frames: world hashes, "
        "launches per frame and the rendered images equal the live run's "
        "(torch.equal), shadow state equal, draw distance "
        f"{eng2.camera.draw_distance}; launches {launches}")
    return launches, replay_ms


def replay_detached(eng2, history, live):
    """Replay again from a reset with the detached camera (Esc, then W and
    a mouse turn), then past the end: Up, then Right."""
    import numpy as np
    import torch

    from render_engine_tpu_torch.logic.types import (KEY_ESC, KEY_RIGHT,
                                                     KEY_UP, KEY_W,
                                                     InputState)
    from render_engine_tpu_torch.runtime.replay import PlaybackMode, Player
    from render_engine_tpu_torch.utils.hashing import world_hash

    eng2.reset()
    player = Player(eng2, history)
    for i in range(len(REPLAY_RENDER)):
        controls = InputState.idle(i).with_keys(KEY_ESC)
        if i:
            controls = dataclasses.replace(
                InputState.idle(i).with_keys(KEY_W),
                mouse_delta=np.array([0.03, 0.0], np.float32))
        img, _ = player.step(controls, render=True)
        if world_hash(eng2.world) != live[i]["hash"]:
            raise RuntimeError(f"detached replay frame {i}: world hash "
                               "differs")
        if tuple(img.shape) != (SLICE["height"], SLICE["width"], 3) or \
                not bool(torch.isfinite(img).all()):
            raise RuntimeError(f"detached replay frame {i}: image")
        if i >= 1 and live[i]["img"] is not None and torch.equal(
                img, live[i]["img"]):
            raise RuntimeError(f"detached replay frame {i}: the image is "
                               "the recorded camera's")
    if player.mode != PlaybackMode.DEBUG_CUSTOM_MOVEMENT:
        raise RuntimeError(f"detached replay ended in {player.mode}")
    moved = float((player.detached_camera.position
                   - eng2.camera.position).norm())
    log("[replay] detached camera: world hashes equal the live run's, "
        f"finite images unlike the live ones; camera {moved:.3f} units from "
        "the recorded one")

    player.step(render=False)
    if player.mode != PlaybackMode.ONE_PAST_LAST_FRAME:
        raise RuntimeError(f"past the end: {player.mode}")
    h0 = world_hash(eng2.world)
    player.step(InputState.idle(100).with_keys(KEY_UP), render=True)
    if player.mode != PlaybackMode.ONE_PAST_LAST_PAUSE or \
            world_hash(eng2.world) == h0:
        raise RuntimeError("Up past the end did not step one frame")
    player.step(InputState.idle(101).with_keys(KEY_RIGHT), render=True)
    if player.mode != PlaybackMode.RUN:
        raise RuntimeError(f"Right did not resume: {player.mode}")
    log("[replay] past the end: ONE_PAST_LAST_FRAME, Up stepped one live "
        "frame (ONE_PAST_LAST_PAUSE), Right resumed RUN")


def long_inputs(i):
    """Frame i of the long recording: idle and W with a mouse turn in
    turns of REPLAY_LONG_STRETCH frames, each frame its own seed."""
    import numpy as np

    from render_engine_tpu_torch.logic.types import KEY_W, InputState

    inp = InputState.idle((i * 2654435761 + 12345) & 0xFFFFFFFF)
    if (i // REPLAY_LONG_STRETCH) % 2:
        return dataclasses.replace(
            inp.with_keys(KEY_W),
            mouse_delta=np.array([0.004, -0.001], np.float32))
    return inp


def replay_long(eng, n=REPLAY_LONG):
    """The headline recorded headless for ``n`` frames on ``eng`` from a
    reset, each frame followed by the engine's own shadow update (so the
    live shadow state is the one a rendered replay reaches); the log
    flushed and loaded; then replayed on a fresh engine through the Player
    with the camera detached (Esc, then the recorded inputs' keys and
    mouse as the flight's controls) and every frame rendered, with
    deterministic algorithms off and every Player.step after warm-up under
    torch.cuda.set_sync_debug_mode("error"). The world hash after every
    frame must equal the live run's, the shadow state at the end too, and
    no program may be captured after the warm-up (interval x slots + 2
    frames)."""
    import tempfile

    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import KEY_ESC, InputState
    from render_engine_tpu_torch.runtime.history import HistoryLog
    from render_engine_tpu_torch.runtime.replay import PlaybackMode, Player
    from render_engine_tpu_torch.utils.hashing import world_hash

    if torch.are_deterministic_algorithms_enabled():
        raise RuntimeError("the long replay runs with deterministic "
                           "algorithms off")
    eng.config.record_history = True
    eng.reset()
    live = []
    t0 = time.perf_counter()
    for i in range(n):
        eng.frame(long_inputs(i), DT, render=False)
        eng.update_shadows()
        live.append(world_hash(eng.world))
    live_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as d:
        eng.config.history_dir = d
        eng.flush_history()
        history = HistoryLog.load(d)
    eng.config.record_history = False
    if history.num_frames != n or any(history.frames_fused):
        raise RuntimeError("the long log is not n headless frames")

    eng2 = build_space_engine(device="cuda", **SLICE)
    eng2.config.record_history = False
    player = Player(eng2, history)
    player.handle_controls(InputState.idle().with_keys(KEY_ESC))
    warm = eng2.config.shadow_update_interval * eng2.config.shadow_slots + 2
    programs = None
    t0 = time.perf_counter()
    for i in range(n):
        controls = long_inputs(i)
        if i == warm:
            programs = eng2.captured_programs
        if programs is None:
            img, _ = player.step(controls, render=True)
        else:
            before = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                img, _ = player.step(controls, render=True)
            finally:
                torch.cuda.set_sync_debug_mode(before)
        if world_hash(eng2.world) != live[i]:
            raise RuntimeError(f"long replay frame {i}: world hash differs "
                               "from the live run's")
    replay_s = time.perf_counter() - t0
    if player.mode != PlaybackMode.DEBUG_CUSTOM_MOVEMENT:
        raise RuntimeError(f"long replay ended in {player.mode}")
    if eng2.captured_programs != programs:
        raise RuntimeError(f"long replay captured after warm-up: "
                           f"{sorted(map(str, eng2.captured_programs - programs))}")
    a, b = eng.shadow_state, eng2.shadow_state
    if not (all(torch.equal(getattr(a, k), getattr(b, k)) for k in
                ("maps", "light_mats", "slot_entity", "slot_face"))
            and (a.cursor, a.tick) == (b.cursor, b.tick)):
        raise RuntimeError("long replay: shadow state differs at the end")
    if tuple(img.shape) != (SLICE["height"], SLICE["width"], 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError("long replay: the last image")
    moved = float((player.detached_camera.position
                   - eng2.camera.position).norm())
    log(f"[replay] long: {n} headline frames recorded headless in "
        f"{live_s:.1f} s and replayed with the detached camera in "
        f"{replay_s:.1f} s (each with a world hash), deterministic "
        f"algorithms off: world hashes equal the live run's after every "
        f"frame, shadow state equal at the end (cursor {b.cursor}, tick "
        f"{b.tick}), {len(programs)} programs, none captured after frame "
        f"{warm}, no synchronization under sync debug mode 'error'; "
        f"detached camera {moved:.3f} units from the recorded one")
    del eng2
    torch.cuda.empty_cache()
    return {"frames": n, "record_s": live_s, "replay_s": replay_s,
            "programs": len(programs)}


def phase_replay(eng):
    """Recording off and on in turns; then, under deterministic
    algorithms, record on ``eng``, replay on a second engine, replay with
    the detached camera and step past the end; then, with them off, the
    long recording (``replay_long``). Returns the launches of the checked
    replay."""
    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    turns = record_turns(eng)
    torch.use_deterministic_algorithms(True)
    try:
        history, live, live_ms, flush_ms, size = record_live(eng)
        eng2 = build_space_engine(device="cuda", **SLICE)
        eng2.config.record_history = False
        launches, replay_ms = replay_checked(eng, eng2, history, live)
        replay_detached(eng2, history, live)
    finally:
        torch.use_deterministic_algorithms(False)
    long = replay_long(eng)
    log(f"[replay] deterministic algorithms on: live median "
        f"{statistics.median(live_ms):.2f} ms/frame, replay median "
        f"{statistics.median(replay_ms):.2f} ms/frame (per frame: live "
        f"{', '.join(f'{t:.1f}' for t in live_ms)}; replay "
        f"{', '.join(f'{t:.1f}' for t in replay_ms)})")
    log(json.dumps({"replay": {
        "ms_per_frame_record_off": turns["off"],
        "ms_per_frame_record_on": turns["on"],
        "flush_ms": flush_ms, "npz_bytes": size,
        "live_ms_per_frame_deterministic": statistics.median(live_ms),
        "replay_ms_per_frame_deterministic": statistics.median(replay_ms),
        "frames": len(REPLAY_RENDER), "long": long}}))
    return launches


def build_lights_engine():
    """The many-lights engine at its full size: 720p, 200 asteroids, 256
    seeded point lights, 268 light-table rows, two render systems."""
    from render_engine_tpu_torch.demo.space_scene import (
        build_many_lights_engine)

    eng = build_many_lights_engine(device="cuda", n_lights=N_POINT_LIGHTS,
                                   light_tile_budget=LIGHT_TILE_BUDGET,
                                   **LIGHTS)
    if len(eng.compiled_systems.names) != 2:
        raise RuntimeError(f"render systems {eng.compiled_systems.names}")
    return eng


def k3_paths(label, a3, kw3):
    """Log K3's items a tile and a block (max and histogram) and its
    critical path, the most light iterations one thread runs:
    max ceil(items / threads) x n_iter over blocks of 256 threads that own
    a whole tile (the design before the split) and over the kernel's
    blocks (kernel_bounds.fused_shade_work's critical_path)."""
    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch.render import shade_pallas as SP

    rows, s_o, s_t, d_o, d_t, ltab, lcount = a3[:7]
    work = KB.fused_shade_work(*a3, **kw3)
    per_tile = SP.shade_work_list(s_o, s_t, d_o, d_t)[2].long()
    per_block = SP.shade_block_items(s_o, s_t)[1]
    _, n_iter = SP.staged_light_rows(ltab, lcount, rows.shape[0],
                                     kw3["tlist"], kw3["tcount"])
    before = int((((per_tile + 255) // 256) * n_iter.long()).max())
    log(f"[lights] K3 {label}: items a tile max {work['items_max_tile']} ("
        + histogram(per_tile, ITEM_BINS) + f"); a block max "
        f"{work['items_max_block']} (" + histogram(per_block, ITEM_BINS)
        + f"); critical path {before} light iterations with a tile a "
        f"block, {work['critical_path']} with {SP.BLOCK_PIXELS} pixels a "
        f"block ("
        f"{before / max(work['critical_path'], 1):.2f} times shorter)")


def synthetic_lists(a3, kw3, seed):
    """K3 on the many-lights frame's inputs with every pixel covered in
    both layers (synthetic_k3) and full lists: each tile 96 distinct live
    rows of the 268-row table, ascending."""
    import numpy as np
    import torch

    args, kw = synthetic_k3(a3, kw3, True, seed)
    rng = np.random.default_rng(seed)
    nt, n_live = args[0].shape[0], int(args[6][0])
    tl = np.sort(np.stack([rng.choice(n_live, LIGHT_TILE_BUDGET,
                                      replace=False) for _ in range(nt)]),
                 axis=1).astype(np.int32)
    dev = args[0].device
    return args, dict(kw, tlist=torch.from_numpy(tl).to(dev),
                      tcount=torch.full((nt,), LIGHT_TILE_BUDGET,
                                        dtype=torch.int32, device=dev))


def phase_lights(earlier=None):
    """K3's tile-list branch on the many-lights frame. Returns the kernel
    record and the launches of the path's counted run."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.render import frame as F
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP

    t0 = time.perf_counter()
    eng = build_lights_engine()
    listed = eng.config.render
    dense = dataclasses.replace(listed, light_tile_budget=0)
    log(f"[lights] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{LIGHTS}, {N_POINT_LIGHTS} point lights, light_tile_budget "
        f"{LIGHT_TILE_BUDGET}, systems {eng.compiled_systems.names}")

    def set_budget(budget):
        eng.config.render = listed if budget else dense

    def start_turn(budget):
        eng.reset()  # restores the render settings too
        set_budget(budget)

    # the path's counted run: launches per frame and the 14 counters
    kernels.reset_launch_counts()
    interval = eng.config.shadow_update_interval
    frames = 6
    for i in range(frames):
        before = dict(kernels.LAUNCHES)
        renders_map = eng.shadow_state.tick % interval == 0
        img = eng.frame(None, DT)
        got, want = launch_delta(before), frame_launches(renders_map,
                                                         tile_lists=1)
        if got != want:
            raise RuntimeError(f"lights frame {i} launched {got}, expected "
                               f"{want}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    if tuple(img.shape) != (LIGHTS["height"], LIGHTS["width"], 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError("lights: image")
    drops = eng.drop_stats()
    log(f"[lights] launches in {frames} frames: {launches}; drop counters "
        f"({len(drops)}): {drops}")
    if len(drops) != DROP_KEYS_LIGHTS or any(drops.values()):
        raise RuntimeError(f"expected {DROP_KEYS_LIGHTS} drop counters, "
                           "all 0")

    # one more frame, which renders a shadow map: K1 in both modes and K2
    # at this path's shapes (other tile counts and budgets than the
    # headline's) against their plain versions, exact
    hold_kernels(eng, "lights")

    # the same state through the kernels at budget 96, through the plain
    # versions, and through the kernels at budget 0
    with Eager(eng), Capture(SP, "shade_tiles") as k3, \
            Capture(F, "select_tile_lights") as sel:
        img_l = eng.render()
    with Eager(eng), Plain():
        img_p = eng.render()
    set_budget(0)
    img_d = eng.render()
    set_budget(LIGHT_TILE_BUDGET)
    torch.cuda.synchronize()
    err = float((img_l - img_p).abs().max())
    log(f"[lights] kernels vs plain versions, whole 720p frame with tile "
        f"light lists: max abs diff {err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"lights frame through the kernels differs by "
                           f"{err}")
    same = torch.equal(img_l, img_d)
    log(f"[lights] frame at budget {LIGHT_TILE_BUDGET} against budget 0: "
        f"torch.equal {same}, max abs diff "
        f"{float((img_l - img_d).abs().max()):.3g}; image max "
        f"{float(img_l.max()):.3f}, mean {float(img_l.mean()):.4f}")
    if not same:
        raise RuntimeError("the tile-listed frame differs from the dense "
                           "one with no overflow")
    a3, kw3 = k3.calls[0]
    tlist, tcount = kw3["tlist"], kw3["tcount"]
    if tlist is None or tuple(tlist.shape) != (a3[0].shape[0],
                                               LIGHT_TILE_BUDGET):
        raise RuntimeError("K3 got no tile light lists")
    n_live = int(a3[6][0])
    log(f"[lights] K3 inputs: rows {tuple(a3[0].shape)}, ltab "
        f"{tuple(a3[5].shape)}, {n_live} live lights, tlist "
        f"{tuple(tlist.shape)}; tcount a tile: "
        + histogram(tcount, TCOUNT_BINS) + f"; max {int(tcount.max())}, mean "
        f"{float(tcount.double().mean()):.1f}; K3 blocks an SM with room "
        f"for {LIGHT_TILE_BUDGET} list rows: "
        f"{SP.blocks_per_sm(LIGHT_TILE_BUDGET)}, for the "
        f"{a3[5].shape[0]}-row table: {SP.blocks_per_sm(a3[5].shape[0])}, "
        f"for the headline's 20 rows: {SP.blocks_per_sm(20)}")
    kw_dense = dict(kw3, tlist=None, tcount=None)
    k3_paths("with lists", a3, kw3)
    k3_paths(f"over all {n_live} lights", a3, kw_dense)
    rec = kernel_record(
        "fused_shade_tile_lists", 1e-5,
        lambda: [SP.shade_tiles(*a3, **kw3)],
        lambda: [SP.fused_shade_reference(*a3, **kw3)],
        KB.fused_shade_work(*a3, **kw3), earlier=earlier, plain_reps=1)
    out_l = SP.shade_tiles(*a3, **kw3)
    out_d = SP.shade_tiles(*a3, **kw_dense)
    if not torch.equal(out_l, out_d):
        raise RuntimeError("K3 with lists differs from K3 over every light")
    dense_rec = kernel_record(
        f"fused_shade over all {n_live} lights", 1e-5,
        lambda: [SP.shade_tiles(*a3, **kw_dense)],
        lambda: [SP.fused_shade_reference(*a3, **kw_dense)],
        KB.fused_shade_work(*a3, **kw_dense), earlier=earlier, plain_reps=1)
    a_syn, kw_syn = synthetic_lists(a3, kw3, 9)
    k3_paths(f"all covered, {LIGHT_TILE_BUDGET}-entry lists", a_syn, kw_syn)
    kernel_record(
        f"synthetic K3 all covered, {LIGHT_TILE_BUDGET}-entry lists", 1e-5,
        lambda: [SP.shade_tiles(*a_syn, **kw_syn)],
        lambda: [SP.fused_shade_reference(*a_syn, **kw_syn)],
        KB.fused_shade_work(*a_syn, **kw_syn), earlier=earlier,
        plain_reps=1)
    sa, skw = sel.calls[0]
    select_ms = device_ms(lambda: SP.select_tile_lights(*sa, **skw), 20)
    select_host = cuda_ms(lambda: SP.select_tile_lights(*sa, **skw), 10)
    log(f"[lights] K3 with lists {rec['ms']:.4f} ms against "
        f"{dense_rec['ms']:.4f} ms over all lights (equal outputs); "
        f"select_tile_lights {select_ms:.4f} ms of device time (one call "
        f"with its host cost {select_host:.3f} ms)")
    turns = turn_medians(eng, BUDGET_TURNS, start_turn, "lights", "budget ")
    rec.update(dense_ms=dense_rec["ms"], dense_bound_ms=dense_rec["bound_ms"],
               dense_bound_by=dense_rec["bound_by"],
               dense_earlier_ms=dense_rec["earlier_ms"], select_ms=select_ms,
               tcount_max=int(tcount.max()),
               tcount_mean=float(tcount.double().mean()),
               ms_per_frame_budget_0=turns[0],
               ms_per_frame_budget_96=turns[LIGHT_TILE_BUDGET])
    return rec, launches, frames


def custom_systems(eng):
    """The engine's two systems, recompiled: the lit one with a
    fragment-shading function over the normal, the albedo, the default
    color and a uniform; the light sources with a draw callback (a sortable
    filter, a gate on a tensor, a uniform write, the skybox). Returns the
    compiled systems with and without the shading function."""
    import torch

    from render_engine_tpu_torch.ecs import registry as R
    from render_engine_tpu_torch.render.render_system import compile_systems
    from render_engine_tpu_torch.utils.consts import on_device

    lit, sources = eng.compiled_systems.src

    def shade(sp):
        tone = on_device(sp.uniforms["tone"], device=sp.base_color.device)
        n = 0.5 * (sp.normal + 1.0)
        return (sp.base_color * tone + 0.2 * sp.albedo * n).clamp(0.0, 1.0)

    def draw(dp):
        cam = dp.get_camera()
        dp.draw_models(*sources.model_ids, sortable=R.SORTABLE_SPOT,
                       when=cam.position[2] > 0.0)
        dp.write_uniform("emissive_boost",
                         torch.ones((), device=dp.world.device))
        dp.draw_skybox(cam.position[2] > 0.0)

    sources = dataclasses.replace(sources, draw=draw)
    toned = dataclasses.replace(lit, uniforms=lit.uniforms + (("tone", 0.8),))
    return (compile_systems((dataclasses.replace(toned, shade=shade),
                             sources), eng.bank),
            compile_systems((lit, sources), eng.bank),
            lambda sp: sp.base_color * float("nan"))


def custom_planes(out):
    """The planes of ``custom_gbuffer``'s result, layer after layer."""
    return [t for gbuf, px_sys in out
            for t in (gbuf.position, gbuf.normal, gbuf.albedo, gbuf.material,
                      px_sys)]


def custom_agreement(label, args, kw):
    """The hook's G-buffer kernel against its plain version on every pixel
    of both layers: each plane's largest difference and differing values
    (CUSTOM_TOL: equal to the bit)."""
    import torch

    from render_engine_tpu_torch.render import custom_gbuffer as CG

    got = CG.custom_gbuffer(*args, **kw)
    want = CG.custom_gbuffer_reference(*args, **kw)
    torch.cuda.synchronize()
    names = ("position", "normal", "albedo", "material", "px_sys")
    rows = []
    for i, (g, w) in enumerate(zip(custom_planes(got), custom_planes(want))):
        diff = (g.double() - w.double()).abs()
        rows.append(f"{('opaque', 'transparent')[i // 5]} {names[i % 5]} "
                    f"{float(diff.max()):.3g} ({int((diff > 0).sum())})")
    log(f"[custom] {label}: kernel vs plain version, every pixel of both "
        f"layers: max abs diff (values differing): {'; '.join(rows)} "
        f"(tolerance {CUSTOM_TOL})")
    check_close(label, custom_planes(got), custom_planes(want), CUSTOM_TOL)


def phase_custom(eng):
    """The hook's G-buffer kernel and K2 over every tile on the headline
    engine with custom shading. Returns the two kernel records and the
    launches of the path's counted run."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.render import custom_gbuffer as CG
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render.render_system import compile_systems

    eng.config.record_history = False
    eng.reset()
    default = eng.compiled_systems
    shaded, unshaded, marker = custom_systems(eng)
    eng.compiled_systems = shaded

    # the path's counted run: one G-buffer launch a frame, K2 only over the
    # textured tiles (a K2 launch over every tile holds all the frame's
    # tiles in its slot plane)
    nt = -(-SLICE["height"] // 8) * -(-SLICE["width"] // 128)
    kernels.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    interval = eng.config.shadow_update_interval
    frames = 6
    with Eager(eng), Capture(RP, "resolve_attributes_pallas",
                             note=lambda slot, rows, *a, **kw:
                             slot.shape[0]) as tiles, \
            Capture(CG, "custom_gbuffer") as cg:
        for i in range(frames):
            before = dict(kernels.LAUNCHES)
            renders_map = eng.shadow_state.tick % interval == 0
            img = eng.frame(None, DT)
            got, want = launch_delta(before), frame_launches(
                renders_map, resolve=1, custom=1)
            seen = tiles.calls[i:]
            if got != want or len(seen) != 1 or seen[0] >= nt:
                raise RuntimeError(f"custom frame {i} launched {got} with K2 "
                                   f"over {seen} tiles, expected {want} with "
                                   f"K2 over fewer than {nt}")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    launches["resolve_full_frame"] = sum(t == nt for t in tiles.calls)
    peak = torch.cuda.max_memory_allocated()
    log(f"[custom] launches in {frames} frames: {launches} (the G-buffer "
        "kernel once a frame for both layers; K2 once, over the textured "
        f"tiles; K2 over every tile {launches['resolve_full_frame']} times); "
        f"peak device memory {peak / 2**20:.0f} MiB")
    if not bool(torch.isfinite(img).all()):
        raise RuntimeError("custom: image has non-finite values")
    for i, (a, kw) in enumerate(cg.calls):
        custom_agreement(f"frame {i}", a, kw)

    with Eager(eng), Capture(CG, "custom_gbuffer") as cg:
        img_s = eng.render()
    with Eager(eng), Plain():
        img_p = eng.render()
    eng.compiled_systems = unshaded
    img_u = eng.render()
    lit = shaded.src[0]
    eng.compiled_systems = compile_systems(
        (dataclasses.replace(lit, shade=marker), shaded.src[1]), eng.bank)
    owned = torch.isnan(eng.render()).any(dim=-1)
    eng.compiled_systems = default
    img_0 = eng.render()
    eng.compiled_systems = shaded
    torch.cuda.synchronize()
    err = float((img_s - img_p).abs().max())
    log(f"[custom] kernels vs plain versions, whole 1080p frame with custom "
        f"shading: max abs diff {err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"custom frame through the kernels differs by "
                           f"{err}")
    changed = (img_s != img_u).any(dim=-1)
    log(f"[custom] the shading system owns {int(owned.sum())} pixels; "
        f"{int(changed.sum())} differ from the frame without the function, "
        f"{int((changed & ~owned).sum())} of them outside its pixels; the "
        "draw callback's frame equals the static systems': "
        f"{torch.equal(img_u, img_0)}")
    if bool((changed & ~owned).any()) or not bool(changed.any()) \
            or not bool(owned.any()):
        raise RuntimeError("custom shading touched pixels it does not own, "
                           "or none")
    if not torch.equal(img_u, img_0):
        raise RuntimeError("the draw callback (every light source drawn, "
                           "boost x 1, skybox on) changed the frame")

    (a, kw), = cg.calls
    layers, rows = a[0], a[1]
    work = KB.custom_gbuffer_work(*a, **kw)
    log(f"[custom] G-buffer inputs: slot {tuple(layers[0][0].shape)} a "
        f"layer, rows {tuple(rows.shape)}, owned pixels "
        f"{work['owned_pixels']}, distinct rows {work['rows']}, atlas "
        f"samples {work['atlas_samples']}")
    rec_cg = kernel_record(
        "custom_gbuffer", CUSTOM_TOL,
        lambda: custom_planes(CG.custom_gbuffer(*a, **kw)),
        lambda: custom_planes(CG.custom_gbuffer_reference(*a, **kw)), work)

    # K2 over every tile of the opaque layer, as the plain version's first
    # step runs it, on the same slot plane
    a2 = (layers[0][0], rows)
    covered = float((a2[0] >= 0).double().mean())
    out_bytes = a2[1].shape[2] * a2[0].numel() * 4
    log(f"[custom] K2 full-frame inputs: slot {tuple(a2[0].shape)}, rows "
        f"{tuple(a2[1].shape)}, output {out_bytes / 1e6:.1f} MB, covered "
        f"pixels {covered:.4f}")
    rec = kernel_record(
        "resolve_full_frame", 0.0,
        lambda: [RP.resolve_attributes_pallas(*a2)],
        lambda: [RP.resolve_attributes_reference(*a2)],
        KB.resolve_work(*a2), k2_gather(*a2))

    def start_turn(which):
        eng.reset()
        eng.compiled_systems = shaded if which == "with" else unshaded

    turns = turn_medians(eng, SHADE_TURNS, start_turn, "custom",
                         "shading function: ")
    eng.compiled_systems = default
    rec.update(ms_per_frame_with_shading=turns["with"],
               ms_per_frame_without_shading=turns["without"],
               peak_memory_bytes=peak, output_bytes=out_bytes)
    return rec, rec_cg, launches, frames


def render_launches(label, before, frames):
    """The launches since ``before``: every kernel of the rendered path
    must have run. Returns them."""
    got = launch_delta(before)
    log(f"[{label}] launches in {frames} rendered frames: {got}")
    missing = [k for k in MAIN_PATH if got[k] == 0]
    if missing:
        raise RuntimeError(f"{label} launched no {missing}")
    return got


def config_scene(RB):
    """800x600: the last of 7 tile columns is 32 pixels wide."""
    import torch

    from render_engine_tpu_torch import kernels

    kernels.reset_launch_counts()
    before = dict(kernels.LAUNCHES)
    rec, eng = RB.bench_scene(scale=CONFIG_SCALE,
                              frames=CONFIG_FRAMES["scene"])
    render_launches("configs scene", before, WARMUP + CONFIG_FRAMES["scene"])
    sc = RB._scaler(CONFIG_SCALE)
    s = eng.config.render
    size = (sc(600, 96), sc(800, 128))
    if (s.height, s.width) != size or (
            CONFIG_SCALE == 1.0 and s.width % s.raster.tile_w == 0):
        raise RuntimeError(f"scene renders {s.width}x{s.height}")
    interval = eng.config.shadow_update_interval
    while eng.shadow_state.tick % interval:
        eng.frame(None, DT)
    img = hold_kernels(eng, "configs scene", k3=True)
    if tuple(img.shape) != (*size, 3) or \
            not bool(torch.isfinite(img).all()) or float(img.max()) < 0.5:
        raise RuntimeError("scene: image")
    tw = s.raster.tile_w
    frame_through_plain(
        eng, "configs scene", f"whole {s.width}x{s.height} frame "
        f"({-(-s.width // tw)} tile columns, the last {s.width % tw or tw} "
        "pixels wide)")
    log(json.dumps(rec))
    return rec


def config_asteroids(RB):
    import torch

    from render_engine_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    rec, eng = RB.bench_asteroids(scale=CONFIG_SCALE,
                                  frames=CONFIG_FRAMES["asteroids"])
    # drop_stats inside the benchmark launched K1 once more
    render_launches("configs asteroids", before,
                    WARMUP + CONFIG_FRAMES["asteroids"])
    drops = rec["drops"]
    img = eng.render()
    sc = RB._scaler(CONFIG_SCALE)
    if tuple(img.shape) != (sc(1080, 144), sc(1920, 256), 3) or \
            not bool(torch.isfinite(img).all()) or float(img.max()) < 0.5:
        raise RuntimeError("asteroids: image")
    log(f"[configs asteroids] collision_large_budget "
        f"{eng.config.collision_large_budget}, drop counters "
        f"({len(drops)}): {drops}")
    if eng.config.collision_large_budget != 64 or len(drops) != DROP_KEYS \
            or any(drops.values()):
        raise RuntimeError(f"asteroids: expected {DROP_KEYS} drop counters, "
                           "all 0, at collision_large_budget 64")
    log(json.dumps(rec))
    return rec


def config_tick(RB):
    """The 100,000-entity world: steps, a burst, then one rendered frame
    at max_tris 49152 with the kernels held to their plain versions."""
    import torch

    from render_engine_tpu_torch.logic import random as RND
    from render_engine_tpu_torch.logic.step import STEP_DROP_KEYS

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    rec, eng = RB.bench_tick(scale=CONFIG_SCALE, frames=CONFIG_FRAMES["tick"],
                             burst=CONFIG_FRAMES["tick_burst"])
    log(f"[configs tick] built and stepped in "
        f"{time.perf_counter() - t0:.1f} s: capacity {rec['capacity']}, "
        f"{rec['alive']} alive, {1e3 / rec['steps_per_sec']:.2f} ms a step "
        f"frame by frame, {1e3 / rec['scan_steps_per_sec']:.2f} ms a step "
        f"in a run_frames burst of {CONFIG_FRAMES['tick_burst']}")
    sc = RB._scaler(CONFIG_SCALE)
    entities = sc(100000, 1000) + SCENE_FIXED_ENTITIES
    if rec["alive"] != entities or \
            rec["capacity"] != 1 << (entities + 58).bit_length():
        raise RuntimeError(f"tick: {rec['alive']} alive of capacity "
                           f"{rec['capacity']}")
    c = eng.config
    budgets = {"collision_query_dropped": "the step's query budget",
               "collision_cell_dropped": f"collision_budget "
               f"{c.collision_budget} a cell",
               "collision_pair_dropped": f"collision_pairs "
               f"{c.collision_pairs}",
               "collision_large_dropped": f"collision_large_budget "
               f"{c.collision_large_budget}",
               "spawn_dropped": f"spawn_budget {c.spawn_budget}",
               "oob_killed": "no budget: entities deleted out of bounds"}
    step = {k: rec["drops"][k] for k in STEP_DROP_KEYS}
    log(f"[configs tick] step counters: {step}")
    for k, v in step.items():
        if v:
            log(f"[configs tick] FINDING: {k} = {v} ({budgets[k]})")
    # the step's random draws are made on the card from the frame's seed,
    # bit for bit jax.random's: a key, one split per random callback, two
    # uniform(3) draws
    seed = torch.tensor(12345, dtype=torch.int64, device="cuda")

    def draws():
        _, sub = RND.split(RND.key(seed))
        RND.uniform(sub, (3,), minval=-8.0, maxval=8.0)
        RND.uniform(sub, (3,), minval=-2.0, maxval=2.0)

    draws()  # the warm-up: cached constants
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        draws()
    log(f"[configs tick] the step's threefry draws on the card (a key, a "
        f"split, two uniform(3)), captured as in the step program: "
        f"{device_ms(graph.replay, 20):.4f} ms of device time a step, "
        "whatever the entity count")
    if eng.shadow_state.tick % c.shadow_update_interval:
        raise RuntimeError("tick: the first rendered frame should render a "
                           "shadow map")
    img = hold_kernels(eng, "configs tick", k3=True)
    if tuple(img.shape) != (sc(1080, 144), sc(1920, 256), 3) or \
            not bool(torch.isfinite(img).all()):
        raise RuntimeError("tick: image")
    frame_through_plain(eng, "configs tick", f"whole {img.shape[1]}x"
                        f"{img.shape[0]} frame at max_tris "
                        f"{c.render.max_tris}")
    rdrops = eng.render_drop_stats()
    log(f"[configs tick] render counters at max_tris {c.render.max_tris}: "
        f"{rdrops}")
    peak = torch.cuda.max_memory_allocated()
    log(f"[configs tick] peak device memory {peak / 2**20:.0f} MiB")
    rec["peak_memory_bytes"] = peak
    log(json.dumps(rec))
    return rec


def config_playback(RB):
    from render_engine_tpu_torch import kernels

    before = dict(kernels.LAUNCHES)
    rec, eng = RB.bench_playback(
        scale=CONFIG_SCALE, frames=CONFIG_FRAMES["playback"],
        recorded_frames=CONFIG_FRAMES["playback_recorded"])
    render_launches("configs playback", before,
                    WARMUP + CONFIG_FRAMES["playback_recorded"])
    log(f"[configs playback] {CONFIG_FRAMES['playback']} step frames "
        f"recorded at {1e3 / rec['record_fps']:.2f} ms and replayed at "
        f"{1e3 / rec['value']:.2f} ms a frame; bit_deterministic "
        f"{rec['bit_deterministic']}; past the end: parked "
        f"{rec['past_end_parked']}, Up stepped one live frame "
        f"{rec['past_end_up_stepped']}; {eng.history.num_frames} recorded "
        f"1080p frames at {rec['recorded_ms_per_frame']:.2f} ms")
    if not (rec["bit_deterministic"] and rec["past_end_parked"]
            and rec["past_end_up_stepped"]):
        raise RuntimeError("playback: the replay diverged, or the steps "
                           "past the end misbehaved")
    log(json.dumps(rec))
    return rec


def phase_configs():
    """The benchmark configurations at full scene size with cut frame
    counts; each is checked as the module docstring says."""
    import torch

    from benchmarks import run_benchmarks_torch as RB

    for config in (config_scene, config_asteroids, config_tick,
                   config_playback):
        t0 = time.perf_counter()
        config(RB)
        torch.cuda.empty_cache()
        log(f"[configs] {config.__name__[len('config_'):]}: "
            f"{time.perf_counter() - t0:.1f} s")


def engine_state(eng):
    """What a frame changes on ``eng``, to put back afterwards."""
    sh = eng.shadow_state
    return (eng.world.clone(), eng.camera, sh and sh.clone(),
            eng.frame_index, eng._prev_keys.copy(), eng.history,
            copy.deepcopy(eng._frame_calls))


def restore_state(eng, state):
    w, cam, sh, index, prev, history, calls = state
    eng.world, eng.camera, eng.shadow_state = w.clone(), cam, sh and sh.clone()
    eng.frame_index, eng._prev_keys = index, prev.copy()
    eng.history = history
    eng._frame_calls = copy.deepcopy(calls)


def band_agreement(img, ref):
    """Max abs diff and share of pixels beyond 1e-6 of two images."""
    diff = (img - ref).abs().amax(dim=-1)
    return float(diff.max()), float((diff > 1e-6).double().mean())


def init_one_rank_nccl():
    """The default process group as one rank of NCCL, meeting in a
    ``file://`` store in the build directory."""
    import torch.distributed as dist

    store = os.path.join(HERE, "render_engine_tpu_torch", "_build",
                         "nccl_store")
    os.makedirs(os.path.dirname(store), exist_ok=True)
    if os.path.exists(store):
        os.remove(store)
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            world_size=1, rank=0)


def phase_bands(eng):
    """Phase 11 (module docstring) on the engine's current state."""
    import torch
    import torch.distributed as dist

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.parallel import (gather_image, gather_world,
                                                  make_mesh,
                                                  render_frame_band,
                                                  shard_step, shard_world)
    from render_engine_tpu_torch.runtime.engine import config_step
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm
    from render_engine_tpu_torch.utils.hashing import world_hash

    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import multigpu_torch as MG

    from render_engine_tpu_torch.render.frame import render_frame

    # texture and shadow tile budgets are fractions of a band's tiles, as in
    # the JAX package: at the headline's 0.04 and 0.28 a band may overflow
    # where the frame does not. At 1.0 every tile is textured and shadowed,
    # and the bands give the whole frame's rows bit for bit (measured on
    # this frame: the shift by whole tile rows changes no K1 edge test)
    s0 = eng.config.render
    s = dataclasses.replace(s0, texture_tile_budget=1.0,
                            shadow_tile_budget=1.0)
    kw = dict(cubemap=eng.cubemap, atlas=eng.atlas,
              shadow_state=eng.shadow_state, systems=eng.compiled_systems)

    def band(r, settings=s):
        return render_frame_band(eng.world, eng.camera, eng.bank, settings,
                                 rank=r, n_ranks=BANDS, **kw)

    kernels.reset_launch_counts()
    bands = []
    for r in range(BANDS):
        before = dict(kernels.LAUNCHES)
        if r == 2:
            with Capture(RP, "tile_raster") as k1, \
                    Capture(RP, "resolve_attributes_pallas") as k2, \
                    Capture(SP, "shade_tiles") as k3:
                bands.append(band(r))
        else:
            bands.append(band(r))
        got = launch_delta(before)
        log(f"[bands] band {r} of {BANDS} ({bands[-1].shape[0]} rows from "
            f"row {r * bands[-1].shape[0]}): launches {got}")
        if got != frame_launches(False):
            raise RuntimeError(f"band {r} launched {got}, expected K1, K2 "
                               "and K3 once each")
    launches = dict(kernels.LAUNCHES)
    torch.cuda.synchronize()
    (a1, kw1), = k1.calls
    a2, _ = k2.calls[0]
    a3, kw3 = k3.calls[0]
    for name, tol, got, want, what in (
            ("K1", 0.0, RP.tile_raster(*a1, **kw1),
             RP.tile_raster_reference(*a1, **kw1),
             f"data {tuple(a1[0].shape)}"),
            ("K2", 0.0, [RP.resolve_attributes_pallas(*a2)],
             [RP.resolve_attributes_reference(*a2)],
             f"slot {tuple(a2[0].shape)}, rows {tuple(a2[1].shape)}"),
            ("K3", 1e-5, [SP.shade_tiles(*a3, **kw3)],
             [SP.fused_shade_reference(*a3, **kw3)],
             f"rows {tuple(a3[0].shape)}, pixel origin {a3[9].tolist()}")):
        err = check_close(f"bands {name}", got, want, tol)
        log(f"[bands] {name} on band 2's inputs ({what}): max_abs_err "
            f"{err:.3g} (tolerance {tol})")
    img = torch.cat(bands)[:s.height]
    whole = render_frame(eng.world, eng.camera, eng.bank, s, **kw)
    worst, share = band_agreement(img, whole)
    log(f"[bands] {BANDS} bands joined against render_frame, tile budgets "
        f"1.0: equal {torch.equal(img, whole)} (max abs diff {worst:.3g}, "
        f"{share:.4%} of pixels beyond 1e-6; required: equal)")
    if not torch.equal(img, whole):
        raise RuntimeError("the bands differ from the whole frame at tile "
                           "budgets 1.0")
    img0 = torch.cat([band(r, s0) for r in range(BANDS)])[:s.height]
    worst0, share0 = band_agreement(img0, eng.render())
    log(f"[bands] at the headline's texture / shadow tile budgets "
        f"{s0.texture_tile_budget} / {s0.shadow_tile_budget} (a band's "
        f"budget is that fraction of its own tiles): max abs diff "
        f"{worst0:.3g}, {share0:.4%} of pixels beyond 1e-6 (limits "
        f"{BAND_MAX_DIFF}, {BAND_MAX_SHARE:.1%})")
    if not (worst0 < BAND_MAX_DIFF and share0 < BAND_MAX_SHARE):
        raise RuntimeError("the bands differ from the whole frame at the "
                           "headline's budgets")

    # one rank of a NCCL group: the band is the whole frame
    state = engine_state(eng)
    recording, eng.config.record_history = eng.config.record_history, False
    init_one_rank_nccl()
    try:
        mesh = make_mesh(1)
        inputs = InputState.idle(eng.frame_index)
        img_e = eng.frame(inputs, DT)
        hash_e = world_hash(eng.world)
        restore_state(eng, state)
        stepped = shard_step(config_step(eng.config), mesh)
        _, own_band, _ = MG.sharded_frame(eng, mesh, stepped,
                                          shard_world(eng.world, mesh),
                                          inputs.with_prev(eng._prev_keys))
        img_s = gather_image(own_band, mesh, s.height)
        hash_s = world_hash(eng.world)
        hash_g = world_hash(gather_world(shard_world(eng.world, mesh), mesh))
        torch.cuda.synchronize()
    finally:
        dist.destroy_process_group()
        restore_state(eng, state)
        eng.config.record_history = recording
    log(f"[bands] one-rank NCCL group ({mesh.device}): image equals "
        f"Engine.frame's: {torch.equal(img_s, img_e)}; world hash "
        f"{hash_s[:16]} against {hash_e[:16]}, after shard_world and "
        f"gather_world {hash_g[:16]}")
    if not torch.equal(img_s, img_e) or not hash_s == hash_g == hash_e:
        raise RuntimeError("the one-rank sharded frame differs from "
                           "Engine.frame")

    mode = {}
    turns = tm(lambda: (torch.cat([band(r, s0) for r in range(BANDS)])
                        if mode["which"] == "bands" else eng.render()),
               BAND_TURNS, lambda which: mode.update(which=which),
               frames=TURN_FRAMES, log=log, label="bands",
               what=f"{BANDS} bands one after another against one frame (a "
               "record, not a speed-up): ")[0]
    return launches, turns


def unshadowed(kind, i, pos):
    """A ``shadow_factor`` that shadows nothing."""
    return 1.0


def shadows_of(sh, world, s):
    """The ``shadow_factor`` the golden path builds from ``sh`` for the
    lights a frame of ``s`` extracts: handed to ``render_frame``, the
    shadowed frame takes the non-fused tiled path."""
    from render_engine_tpu_torch.render import lighting as L
    from render_engine_tpu_torch.render import shadows as SHD

    lights = L.extract_lights(world, max_dir=s.max_dir_lights,
                              max_point=s.max_point_lights,
                              max_spot=s.max_spot_lights)
    return SHD.make_shadow_factor(sh, world, {"dir": lights.dir_entity,
                                              "spot": lights.sp_entity,
                                              "point": lights.pt_entity})


def route_factors(sh, depth, winner, proj_view, s):
    """Both shading routes' PCF factors of every active shadow slot at
    every pixel, each (S, H, W), from the ``depth`` and ``winner`` tiles
    (NT, th, tw) of one raster, on their device: the fused path's
    (camera NDC through light_mat @ inv_proj_view,
    ``frame._per_slot_factor_tiles``) and the non-fused path's (the
    G-buffer's unprojected world position, ``shadows.slot_factors``)."""
    import torch

    from render_engine_tpu_torch.math import transforms as T
    from render_engine_tpu_torch.render import frame as F
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shadows as SHD

    d, wn = depth, winner
    th, tw = s.raster.tile_h, s.raster.tile_w
    tiles_x, tiles_y = -(-s.width // tw), -(-s.height // th)
    nt = d.shape[0]
    inv_pv = T.inv44(proj_view)
    sft, sfi = F._per_slot_factor_tiles(sh, d, wn, tiles_x, th, tw, s.width,
                                        s.height, inv_pv, 0.0, 1.0)
    slots = torch.arange(sh.slots, device=d.device)[:, None]
    fused = torch.where((sfi >= 0)[..., None, None],
                        sft[slots, sfi.clamp(min=0)], 1.0)
    # the position depends on no attribute channel
    px, py = RP._tall_pixel_centers(torch.arange(nt, device=d.device),
                                    tiles_x, th, tw)
    g, _ = RP._gbuffer_from_channels(
        d.new_zeros(35, nt * th, tw), d.reshape(nt * th, tw),
        wn.reshape(nt * th, tw), s.height, s.width, inv_pv, px=px, py=py)
    tall = SHD.slot_factors(sh, g.position)
    active = sh.slot_entity >= 0
    return [torch.stack([RP._untile_tall(f[i].reshape(-1, tw), tiles_y,
                                         tiles_x, th, tw, s.height, s.width)
                         for i in range(sh.slots)])[active]
            for f in (fused, tall)]


def route_inputs(eng, s):
    """The depth and winner tiles of ``eng``'s frame (K1, two layers) and
    the camera's proj_view: what ``route_factors`` starts from."""
    from render_engine_tpu_torch.render import frame as F
    from render_engine_tpu_torch.render import raster_pallas as RP

    th, tw = s.raster.tile_h, s.raster.tile_w
    tiles_x, tiles_y = -(-s.width // tw), -(-s.height // th)
    batch = F.frame_inputs(eng.world, eng.camera, eng.bank, s,
                           cubemap=eng.cubemap,
                           systems=eng.compiled_systems)["batch"]
    tri_class = RP._tri_class(batch)
    cand, counts = RP._candidate_table(batch, s.raster, tiles_x, tiles_y,
                                       tri_class)
    d, wn, *_ = RP._launch(batch, s.height, s.width, s.raster, tri_class,
                           two_pass=True, cand=cand, counts=counts)
    return dict(depth=d, winner=wn, proj_view=eng.camera.proj_view())


def save_shadow_routes(path, sh, s, inputs, flips, a, b, routes):
    """What a check of the JAX package's two routes on this frame needs
    (scripts/shadow_routes_jax.py), as a numpy archive."""
    import numpy as np

    ys, xs = flips.cpu().unbind(1)
    routes = {k: v.cpu() for k, v in routes.items()}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez_compressed(
        path, width=s.width, height=s.height, tile_h=s.raster.tile_h,
        tile_w=s.raster.tile_w, resolution=sh.resolution,
        maps=sh.maps.cpu().numpy(), light_mats=sh.light_mats.cpu().numpy(),
        slot_entity=sh.slot_entity.cpu().numpy(),
        slot_face=sh.slot_face.cpu().numpy(),
        **{k: v.cpu().numpy() for k, v in inputs.items()},
        flips=flips.cpu().numpy(), color_fused=a.cpu()[ys, xs].numpy(),
        color_nonfused=b.cpu()[ys, xs].numpy(),
        **{f"factors_{k}": v[:, ys, xs].numpy() for k, v in routes.items()},
        routes_differ=(routes["fused"] != routes["nonfused"]).any(
            dim=0).numpy(),
        routes_differ_cpu=(routes["fused_cpu"] != routes["nonfused_cpu"]
                           ).any(dim=0).numpy())
    log(f"[nonfused] the two routes' inputs and factors written to {path}")


def phase_nonfused(eng, routes_path=None):
    """Phase 12 (module docstring) on the engine's current state. Returns
    the launches of its counted frame."""
    import torch

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.render import tall_gbuffer as TG
    from render_engine_tpu_torch.render.frame import render_frame
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm

    s0 = eng.config.render
    kw = dict(cubemap=eng.cubemap, atlas=eng.atlas,
              systems=eng.compiled_systems)

    def nonfused():
        return render_frame(eng.world, eng.camera, eng.bank, s0,
                            shadow_factor=shadows_of(eng.shadow_state,
                                                     eng.world, s0), **kw)

    nt = -(-s0.height // s0.raster.tile_h) * -(-s0.width // s0.raster.tile_w)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    with Capture(TG, "tall_gbuffer", note=lambda layers, rows, *a, **kw: (
            [la[0].shape[0] for la in layers], tuple(rows.shape))) as tall:
        img_n = nonfused()
        torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    want = dict(frame_launches(False, resolve=0, tall=1), fused_shade=0)
    tiles = [c[0] for c in tall.calls]
    log(f"[nonfused] launches in one frame: {launches}; the tall G-buffers "
        f"over {tiles} tiles with rows {[c[1] for c in tall.calls]}; peak "
        f"device memory {peak / 2**20:.0f} MiB")
    if launches != want or tiles != [[nt, nt]]:
        raise RuntimeError(f"nonfused frame launched {launches}, expected "
                           f"{want} with the tall G-buffers once over {nt} "
                           "tiles of each layer")
    with Plain():
        img_p = nonfused()
    torch.cuda.synchronize()
    err = float((img_n - img_p).abs().max())
    log(f"[nonfused] kernels vs plain versions, whole 1080p frame with "
        f"shadows: max abs diff {err:.3g}")
    if not err <= 1e-5:
        raise RuntimeError(f"nonfused frame through the kernels differs by "
                           f"{err}")
    # against the fused frame as the JAX package holds them (tests/
    # test_frame_tiled.py:103-110, 277) at tile budgets 1.0: 99.5% of
    # pixels within 1e-2, median 0 and max below 0.05; with shadows at
    # pcf_scale 1 at most NONFUSED_FLIPS of the pixels may reach 0.05, by
    # no more than FLIP_MAX, and only where the two routes' PCF factors
    # differ: the fused path takes camera NDC to light clip space through
    # one composed matrix, the non-fused path through the world position;
    # for a far pixel both are differences of terms near 1e3, so the two
    # land on texels or sides of the frustum that may differ, in the JAX
    # package as here (scripts/shadow_routes_jax.py). At the demo's
    # pcf_scale 3 the two paths also subsample on different grids (every
    # k-th row of a tile against every k-th row of the tall layout): a
    # record
    sh = eng.shadow_state
    sh1 = dataclasses.replace(sh, pcf_scale=1)
    exact = dataclasses.replace(s0, shadow_tile_budget=1.0,
                                texture_tile_budget=1.0)
    for what, shadow in (("no shadows", None),
                         ("shadows at pcf_scale 1", sh1),
                         (f"shadows at pcf_scale {sh.pcf_scale} (a record)",
                          sh)):
        a = render_frame(eng.world, eng.camera, eng.bank, exact,
                         shadow_state=shadow, **kw)
        b = render_frame(eng.world, eng.camera, eng.bank, exact,
                         shadow_factor=(unshadowed if shadow is None else
                                        shadows_of(shadow, eng.world, exact)),
                         **kw)
        diff = (a - b).abs().amax(dim=-1)
        near = float((diff < 1e-2).double().mean())
        flips = diff >= NONFUSED_MAX_DIFF
        worst, med = float(diff.max()), float(diff.median())
        log(f"[nonfused] against the fused frame, {what}, tile budgets 1.0: "
            f"max {worst:.3g}, {near:.6f} of pixels within 1e-2, median "
            f"{med:.3g}, {int(flips.sum())} pixels at {NONFUSED_MAX_DIFF} or "
            "more")
        if shadow is sh:
            continue
        ok = near > 0.995 and med <= 1e-5
        if shadow is None:
            ok = ok and worst < NONFUSED_MAX_DIFF
        else:
            # the same routes from the same depth on the host's CPU: the
            # light-space position of a far pixel is a difference of terms
            # near 1e3, so the two devices may round a tap apart
            inputs = route_inputs(eng, exact)
            routes = dict(zip(("fused", "nonfused"),
                              route_factors(sh1, **inputs, s=exact)))
            sh_cpu = dataclasses.replace(
                sh1, maps=sh1.maps.cpu(), light_mats=sh1.light_mats.cpu(),
                slot_entity=sh1.slot_entity.cpu(),
                slot_face=sh1.slot_face.cpu())
            routes.update(zip(("fused_cpu", "nonfused_cpu"), route_factors(
                sh_cpu, **{k: v.cpu() for k, v in inputs.items()},
                s=exact)))
            differ = (routes["fused"] != routes["nonfused"]).any(dim=0)
            differ_cpu = (routes["fused_cpu"] != routes["nonfused_cpu"]
                          ).any(dim=0)
            at = torch.nonzero(flips)
            log(f"[nonfused] the two routes' PCF factors differ at "
                f"{int(differ.sum())} pixels on the card, at "
                f"{int(differ_cpu.sum())} on the host's CPU from the same "
                f"depth; at each pixel at {NONFUSED_MAX_DIFF} or more (y, x, "
                "diff; fused / non-fused factors of the active slots on the "
                "card, then on the CPU): " + "; ".join(
                    f"{y} {x} {float(diff[y, x]):.4f}; " + " ".join(
                        f"{routes[k][:, y, x].tolist()}" for k in routes)
                    for y, x in at.tolist()[:8]))
            ok = (ok and worst <= FLIP_MAX
                  and float(flips.double().mean()) <= NONFUSED_FLIPS
                  and bool(differ[flips].all()))
            if routes_path:
                save_shadow_routes(routes_path, sh1, exact, inputs, at, a, b,
                                   routes)
        if not ok:
            raise RuntimeError(f"the nonfused frame differs from the fused "
                               f"one ({what})")
    mode = {}
    turns = tm(lambda: nonfused() if mode["which"] == "nonfused"
               else eng.render(), NONFUSED_TURNS,
               lambda which: mode.update(which=which), frames=TURN_FRAMES,
               log=log, label="nonfused",
               what="render of the captured frame: ")[0]
    return launches, turns, peak


def image_agreement(a, b):
    """Share of pixels within 2e-2, the median and the max of the per-pixel
    max abs difference of two images."""
    diff = (a - b).abs().amax(dim=-1)
    return (float((diff < 2e-2).double().mean()), float(diff.median()),
            float(diff.max()))


def phase_golden():
    """The golden path on a small engine with a cubemap skybox: against
    the fused path on the card, and the card against the CPU."""
    import torch

    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.render import skybox as SB
    from render_engine_tpu_torch.render.frame import to_srgb_u8

    imgs = {}
    for dev in ("cpu", "cuda"):
        eng = build_space_engine(device=dev, **GOLDEN)
        eng.config.record_history = False
        eng.set_skybox(SB.starfield_cubemap(64, device=eng.device))
        for i in range(3):
            eng.frame(frame_inputs(i), DT)
        fused = eng.render()
        eng.config.render = dataclasses.replace(eng.config.render,
                                                backend="jnp")
        imgs[dev] = (fused.cpu(), eng.render().cpu())
        eng.set_skybox(SB.cubemap_rows(eng.cubemap))
        rows = eng.render().cpu()
        if not torch.allclose(rows, imgs[dev][1], rtol=0, atol=1e-6):
            raise RuntimeError(f"golden on {dev}: the row sampler's "
                               "background differs from the four-tap one")
    for dev, (fused, golden) in imgs.items():
        near, med, worst = image_agreement(fused, golden)
        log(f"[golden] {dev}: fused against golden at {GOLDEN['width']}x"
            f"{GOLDEN['height']} with shadows and a cubemap: "
            f"{near:.4f} of pixels within 2e-2, median {med:.3g}, max "
            f"{worst:.3g}")
        if not (near > 0.98 and med <= 1e-5):
            raise RuntimeError(f"golden on {dev} disagrees with the fused "
                               "path")
        if not bool(torch.isfinite(golden).all()) or \
                float(golden.max()) < 0.5:
            raise RuntimeError(f"golden on {dev}: blank or non-finite")
    a, b = imgs["cuda"][1], imgs["cpu"][1]
    far = float(((a - b).abs().amax(dim=-1) > 2.0 / 255.0).double().mean())
    u8 = float((to_srgb_u8(a) != to_srgb_u8(b)).double().mean())
    log(f"[golden] card against CPU: {far:.4%} of pixels differ by more "
        f"than 2/255, u8 values differing {u8:.2%}")
    if far > 5e-3:
        raise RuntimeError("golden: the card's frame differs from the CPU's")



# phase 13: the Engine's captured programs against the same programs'
# functions run eagerly (Eager), route by route
PROGRAM_FRAMES = 6
PROGRAM_TURNS = ("graphed", "eager", "eager", "graphed") * 3
PROFILE_FRAMES = 6
TOP_ROWS = 8  # device rows by time a profile lists
SPAWN_AT, SPAWN_DT = 7, 4.5  # a frame long enough to fire the mine spawner
HOST_LAUNCH_APIS = ("cudaGraphLaunch", "cudaLaunchKernel",
                    "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def program_record(eng, img, before):
    """What one step of a route leaves: the world hash, the image, the
    shadow state, the step counters and the kernel launches since
    ``before``."""
    from render_engine_tpu_torch.logic.step import unpack_drop_stats
    from render_engine_tpu_torch.utils.hashing import world_hash

    sh = eng.shadow_state
    return dict(
        hash=world_hash(eng.world), img=img,
        shadow=None if sh is None else (sh.maps, sh.light_mats,
                                        sh.slot_entity, sh.slot_face,
                                        sh.cursor, sh.tick),
        drops=(None if eng._last_drops is None
               else unpack_drop_stats(eng._last_drops)),
        launches=launch_delta(before))


def drive_routes(eng):
    """33 step frames over every route: frames (fused; every fifth a step
    frame and the updating render; frame SPAWN_AT lasts SPAWN_DT s), then
    run_frames (3, the last rendered), run_frames_rendered (3), render(),
    render_only through a detached camera of another field of view, and
    step(). Returns a program_record a call."""
    from render_engine_tpu_torch import kernels

    out = []

    def rec(fn):
        before = dict(kernels.LAUNCHES)
        out.append(program_record(eng, fn(), before))

    for i in range(27):
        rec(lambda: eng.frame(frame_inputs(i),
                              SPAWN_DT if i == SPAWN_AT else DT,
                              advance="step" if i % 5 == 3 else None))
    rec(lambda: eng.run_frames([frame_inputs(27 + j) for j in range(3)],
                               [DT] * 3, render_last=True))
    rec(lambda: eng.run_frames_rendered(
        [frame_inputs(30 + j) for j in range(3)], [DT] * 3))
    rec(eng.render)
    detached = dataclasses.replace(eng.camera, fov_y=0.9)
    rec(lambda: eng.render_only(detached))
    rec(lambda: eng.step(frame_inputs(40), DT))
    return out


def drive_frames(n, render=True):
    """``n`` frames (rendered) or ``n`` steps and a run_frames burst."""
    from render_engine_tpu_torch import kernels

    def drive(eng):
        out = []
        for i in range(n):
            before = dict(kernels.LAUNCHES)
            img = (eng.frame(frame_inputs(i), DT) if render
                   else eng.step(frame_inputs(i), DT))
            out.append(program_record(eng, img, before))
        if not render:
            before = dict(kernels.LAUNCHES)
            eng.run_frames([frame_inputs(n + j) for j in range(3)], [DT] * 3)
            out.append(program_record(eng, None, before))
        return out

    return drive


def program_name(key):
    """A program key, its camera configuration cut to the field of view."""
    if key[0] == "render":
        return (f"render(fov_y {dict(key[1])['fov_y']:.3f}, inputs "
                f"{key[2]})")
    return "/".join(map(str, key))


def graph_pool_bytes(eng):
    """Bytes of ``eng``'s graph pool (an Engine's or a ShardedPrograms'
    programs share one private pool)."""
    from render_engine_tpu_torch.runtime.profiling import graph_pool_bytes

    return graph_pool_bytes(eng._pool)


def captured_vs_eager(label, eng, drive):
    """``drive`` on ``eng`` through its captured programs, then from the
    same state through the programs' functions (Eager): every step's world
    hash, image (torch.equal), shadow state, step counters and kernel
    launches must be equal. The engine's state is put back."""
    import torch

    state = engine_state(eng)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = drive(eng)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    pool = graph_pool_bytes(eng)
    restore_state(eng, state)
    with Eager(eng):
        want = drive(eng)
    torch.cuda.synchronize()
    restore_state(eng, state)
    if len(got) != len(want):
        raise RuntimeError(f"[programs] {label}: {len(got)} against "
                           f"{len(want)} steps")
    for i, (g, w) in enumerate(zip(got, want)):
        same = {
            "hash": g["hash"] == w["hash"],
            "image": (g["img"] is None) == (w["img"] is None) and (
                g["img"] is None or torch.equal(g["img"], w["img"])),
            "shadow": (g["shadow"] is None) == (w["shadow"] is None) and (
                g["shadow"] is None or (
                    all(torch.equal(a, b) for a, b in
                        zip(g["shadow"][:4], w["shadow"][:4]))
                    and g["shadow"][4:] == w["shadow"][4:])),
            "drops": g["drops"] == w["drops"],
            "launches": g["launches"] == w["launches"]}
        if not all(same.values()):
            raise RuntimeError(
                f"[programs] {label} step {i}: captured differs from eager "
                f"in {[k for k, v in same.items() if not v]} (launches "
                f"{g['launches']} against {w['launches']})")
    secs = eng.capture_seconds()
    maps = sum(r["launches"]["tile_raster_one_pass"] for r in got)
    log(f"[programs] {label}: {len(got)} steps captured against eager: "
        "world hashes, images (torch.equal), shadow state, step counters "
        f"and launches equal ({sum(sum(r['launches'].values()) for r in got)}"
        f" kernel launches, {maps} shadow rasters); "
        f"{len(secs)} programs captured in {sum(secs.values()):.2f} s "
        "(two warm-ups each included): "
        + ", ".join(f"{program_name(k)} {v:.2f}" for k, v in sorted(
            secs.items(), key=str))
        + f"; the captured run {wall:.2f} s; graph pool "
        f"{pool / 2**20:.1f} MiB")
    return dict(steps=len(got), programs=len(secs),
                capture_s=sum(secs.values()), pool_mib=pool / 2**20)


def frame_profile(eng, frames):
    """Host API launches (graph launches, kernel launches, copies and
    memsets) and device kernels a frame over ``frames`` frames, with the
    device time a frame and the device's busy share, all from one traced
    run: the union of the trace's device rows over the window that CUDA
    events on the frames' stream take (from before the first frame's
    launch to the end of the last frame's work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.runtime.profiling import device_activity

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts):  # the profiler's own start-up
        eng.frame(None, DT)
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    before = dict(kernels.LAUNCHES)
    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=acts) as prof:
        first.record()
        for _ in range(frames):
            eng.frame(None, DT)
        last.record()
        torch.cuda.synchronize()
    window_ms = first.elapsed_time(last)
    counted = launch_delta(before)
    events = prof.key_averages()
    api = {e.key: e.count / frames for e in events
           if e.key in HOST_LAUNCH_APIS}
    dev = [e for e in events
           if e.device_type == torch.autograd.DeviceType.CUDA]

    def named(part):
        return sum(e.count for e in dev if part in e.key)

    # the kernels the profiler saw run, against the wrappers' counts
    seen = {"tile_raster": named("tile_raster_kernel"),
            "tile_raster_one_pass": named("tile_raster_kernel<false>"),
            "resolve": named("resolve_kernel"),
            "fused_shade": named("fused_shade_kernel"),
            "deferred_shade": named("deferred_shade_kernel"),
            "tall_gbuffer": named("tall_gbuffer_kernel"),
            "custom_gbuffer": named("custom_gbuffer_kernel")}
    if any(seen[k] != counted[k] for k in seen):
        raise RuntimeError(f"the profiler saw {seen} kernels in {frames} "
                           f"frames, the launch counts say {counted}")
    act = device_activity(prof.events())
    # the device rows that take the most time, by name: ms and count a
    # frame
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP_ROWS]
    return dict(host_launches=sum(api.values()), host_api=api,
                device_kernels=act["rows"] / frames,
                device_ms=act["sum_ms"] / frames,
                window_ms=window_ms / frames,
                busy_share=act["busy_ms"] / window_ms,
                overlap=act["sum_ms"] / act["busy_ms"], kernels_seen=seen,
                top=[(k[:80], ms / frames, n / frames)
                     for k, (ms, n) in top])


def phase_programs():
    """Captured against eager on the headline (both advance routes, the
    bursts, render and render_only, step), the unshadowed frame, custom
    shading, lights-720p-256, scene-800x600 and tick-100k's step; then,
    on the headline, ms/frame graphed against eager in turns and a
    profile of each."""
    import torch

    from benchmarks import run_benchmarks_torch as RB
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    out = {}
    eng = build_space_engine(device="cuda", **SLICE)
    eng.config.record_history = False
    out["headline"] = captured_vs_eager("headline 1080p/10k, shadows", eng,
                                        drive_routes)
    eager = Eager(eng)

    def start(which):
        eng.reset()
        if (which == "eager") != eager.on:
            if eager.on:
                eager.__exit__()
            else:
                eager.__enter__()

    turns = turn_medians(eng, PROGRAM_TURNS, start, "programs",
                         "headline frame ")
    if eager.on:
        eager.__exit__()
    profiles = {}
    for which in ("graphed", "eager"):
        start(which)
        profiles[which] = frame_profile(eng, PROFILE_FRAMES)
    if eager.on:
        eager.__exit__()
    for which, p in profiles.items():
        api = ", ".join(f"{k} {v:.1f}" for k, v in sorted(
            p["host_api"].items()))
        log(f"[programs] headline {which}: {p['host_launches']:.1f} host API "
            f"launches a frame ({api}), {p['device_kernels']:.1f} device "
            f"rows a frame summing to {p['device_ms']:.3f} ms; the device "
            f"busy {p['busy_share']:.4f} of the traced window of "
            f"{p['window_ms']:.3f} ms a frame (untraced median "
            f"{turns[which]:.2f} ms/frame); device rows' sum over their "
            f"union {p['overlap']:.4f}; K1, K2 and K3 in the trace in "
            f"{PROFILE_FRAMES} frames: {p['kernels_seen']} (equal to the "
            "launch counts)")
    if profiles["graphed"]["device_kernels"] != \
            profiles["eager"]["device_kernels"]:
        log("[programs] device kernels a frame differ between graphed and "
            "eager: the graph's copies back into the static buffers and the "
            "image clone")
    eng.reset()
    default = eng.compiled_systems
    eng.compiled_systems = custom_systems(eng)[0]
    out["custom"] = captured_vs_eager("custom shading 1080p/10k", eng,
                                      drive_frames(PROGRAM_FRAMES))
    eng.compiled_systems = default
    del eng
    torch.cuda.empty_cache()

    eng = build_space_engine(device="cuda", enable_shadows=False, **SLICE)
    eng.config.record_history = False
    out["unshadowed"] = captured_vs_eager("unshadowed 1080p/10k", eng,
                                          drive_routes)
    del eng
    torch.cuda.empty_cache()
    eng = build_lights_engine()
    out["lights"] = captured_vs_eager("lights-720p-256", eng,
                                      drive_frames(PROGRAM_FRAMES))
    del eng
    torch.cuda.empty_cache()
    _, eng = RB.bench_scene(scale=1.0, frames=1)
    out["scene"] = captured_vs_eager("scene-800x600", eng,
                                     drive_frames(PROGRAM_FRAMES))
    del eng
    torch.cuda.empty_cache()
    _, eng = RB.bench_tick(scale=1.0, frames=1, burst=2)
    out["tick"] = captured_vs_eager("tick-100k step", eng,
                                    drive_frames(PROGRAM_FRAMES,
                                                 render=False))
    del eng
    torch.cuda.empty_cache()
    log(json.dumps({"programs": dict(
        routes=out, ms_per_frame_graphed=turns["graphed"],
        ms_per_frame_eager=turns["eager"], profile=profiles)}))
    return out


# phase 14: the partitioned step on a one-rank NCCL group against the
# Engine's captured step
PARTITIONED_STEPS, PARTITIONED_SPAWN_AT = 8, 5  # step 5 lasts SPAWN_DT s
TICK_STEPS = 3
PARTITIONED_TURNS = ("captured", "partitioned", "partitioned", "captured")
PARTITIONED_TURN_STEPS = 5
def partitioned_vs_captured(label, eng, steps, spawn_at=None):
    """``steps`` steps of ``eng``'s captured step program and of the
    partitioned step on a one-rank NCCL mesh from the same state, each
    step's columns, world hash, camera and counters equal; then their ms
    in turns. The engine's state is put back."""
    import numpy as np
    import torch

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.logic.step import (pack_drop_stats,
                                                    unpack_drop_stats)
    from render_engine_tpu_torch.parallel import (columns, make_mesh,
                                                  shard_step, shard_world)
    from render_engine_tpu_torch.runtime.engine import config_step
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm
    from render_engine_tpu_torch.utils.hashing import world_hash

    mesh = make_mesh(1)
    stepped = shard_step(config_step(eng.config), mesh)
    state = engine_state(eng)
    rows, camera = shard_world(eng.world, mesh), eng.camera
    boxes = (eng.bank.aabb_min, eng.bank.aabb_max)
    prev = eng._prev_keys.copy()
    alive0 = int(eng.world.alive.sum())
    kernels.reset_launch_counts()
    for i in range(steps):
        inputs = frame_inputs(i).with_prev(prev)
        prev = np.asarray(inputs.keys, bool)
        dt = SPAWN_DT if i == spawn_at else DT
        eng.step(inputs, dt)
        rows, camera, stats = stepped(
            rows, camera, inputs.to_device(mesh.device),
            torch.tensor(np.float32(dt), device=mesh.device), *boxes)
        want = eng.world
        same = {"columns": all(torch.equal(v, columns(want)[k])
                               for k, v in columns(rows).items()),
                "hash": world_hash(rows) == world_hash(want),
                "camera": torch.equal(camera.serialize(),
                                      eng.camera.serialize()),
                "counters": torch.equal(pack_drop_stats(stats),
                                        eng._last_drops)}
        if not all(same.values()):
            raise RuntimeError(
                f"[partitioned] {label} step {i}: the partitioned step "
                f"differs from the captured one in "
                f"{[k for k, v in same.items() if not v]}")
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if launched:
        raise RuntimeError(f"[partitioned] {label}: the steps launched "
                           f"{launched}")
    alive = int(rows.alive.sum())
    log(f"[partitioned] {label}: {steps} steps on a one-rank NCCL group "
        f"({mesh.device}, {rows.alive.shape[0]} rows) against the captured "
        "step: every column, the world hash, the camera and the 6 counters "
        f"equal (torch.equal) after each step; {alive0} -> {alive} alive"
        + (f" (step {spawn_at} lasts {SPAWN_DT} s and fires the mine "
           "spawner)" if spawn_at is not None else "")
        + f"; counters {unpack_drop_stats(pack_drop_stats(stats))}; no "
        "kernel launched")
    inputs = frame_inputs(0)
    dev_in = inputs.to_device(mesh.device)
    dt_t = torch.tensor(np.float32(DT), device=mesh.device)
    mode, held = {}, {"rows": rows, "camera": camera}

    def one():
        if mode["which"] == "captured":
            eng.step(inputs, DT)
        else:
            held["rows"], held["camera"], _ = stepped(
                held["rows"], held["camera"], dev_in, dt_t, *boxes)

    turns = tm(one, PARTITIONED_TURNS, lambda w: mode.update(which=w),
               frames=PARTITIONED_TURN_STEPS, log=log, label="partitioned",
               what=f"{label} step, eager partitioned against captured (a "
               "record): ")[0]
    restore_state(eng, state)
    return dict(steps=steps, alive=alive, ms=turns)


def phase_partitioned():
    """Phase 14 (module docstring)."""
    import torch
    import torch.distributed as dist

    from benchmarks import run_benchmarks_torch as RB
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    from render_engine_tpu_torch.parallel import GLOO_CUDA_REFUSED

    out = {}
    log(f"[partitioned] 2 ranks on the one card under gloo: not run; "
        f"{GLOO_CUDA_REFUSED}")
    init_one_rank_nccl()
    try:
        eng = build_space_engine(device="cuda", **SLICE)
        eng.config.record_history = False
        out["headline"] = partitioned_vs_captured(
            "headline 1080p/10k", eng, PARTITIONED_STEPS,
            spawn_at=PARTITIONED_SPAWN_AT)
        del eng
        torch.cuda.empty_cache()
        _, eng = RB.bench_tick(scale=1.0, frames=1, burst=2)
        out["tick"] = partitioned_vs_captured("tick-100k", eng, TICK_STEPS)
        del eng
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(json.dumps({"partitioned": out}))
    return out


# phase 15: the partitioned step and the sharded frame as programs
# (parallel.ShardedPrograms, captured over NCCL) on a one-rank NCCL group
# against the Engine's captured programs
MESH_STEP_TURNS = ("captured", "engine", "eager", "eager", "engine",
                   "captured")
MESH_FRAME_TURNS = ("sharded", "engine", "engine", "sharded") * 2
MESH_TURN_FRAMES = 6


def same_step(progs, eng):
    """What a step of ``progs`` and of ``eng`` must share, each part
    ``torch.equal``."""
    import torch

    from render_engine_tpu_torch.parallel import columns
    from render_engine_tpu_torch.utils.hashing import world_hash

    rows, want = progs.rows, eng.world
    return {"columns": all(torch.equal(v, columns(want)[k])
                           for k, v in columns(rows).items()),
            "hash": world_hash(rows) == world_hash(want),
            "camera": torch.equal(progs.camera.serialize(),
                                  eng.camera.serialize()),
            "counters": torch.equal(progs.drops, eng._last_drops)}


def collectives(progs, key):
    """The collectives one eager run of the program ``key``'s function
    issues (scripts/multigpu_torch.collectives): total and by operation."""
    sys.path.insert(0, os.path.join(HERE, "scripts"))
    import multigpu_torch as MG

    by_op = MG.collectives(progs, key)
    return sum(by_op.values()), by_op


def mesh_steps(label, eng, steps, spawn_at=None):
    """``steps`` steps of ``eng``'s captured step program and of the
    captured partitioned step (``ShardedPrograms.step``) from the same
    state, each step's columns, world hash, camera and counters equal;
    then their ms in turns with the partitioned step's function run
    eagerly. The engine's state is put back."""
    import numpy as np

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.logic.step import unpack_drop_stats
    from render_engine_tpu_torch.parallel import ShardedPrograms, make_mesh
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm

    state = engine_state(eng)
    progs = ShardedPrograms(eng, make_mesh(1))
    prev = eng._prev_keys.copy()
    alive0 = int(eng.world.alive.sum())
    kernels.reset_launch_counts()
    for i in range(steps):
        inputs = frame_inputs(i).with_prev(prev)
        prev = np.asarray(inputs.keys, bool)
        dt = SPAWN_DT if i == spawn_at else DT
        eng.step(inputs, dt)
        progs.step(inputs, dt)
        same = same_step(progs, eng)
        if not all(same.values()):
            raise RuntimeError(
                f"[mesh] {label} step {i}: the captured partitioned step "
                "differs from the Engine's captured step in "
                f"{[k for k, v in same.items() if not v]}")
    launched = {k: v for k, v in kernels.LAUNCHES.items() if v}
    if launched:
        raise RuntimeError(f"[mesh] {label}: the steps launched {launched}")
    alive = int(progs.rows.alive.sum())
    comms = collectives(progs, ("step",))
    log(f"[mesh] {label}: {steps} steps of the captured partitioned step "
        f"(ShardedPrograms, one-rank NCCL group, {progs.rows.alive.shape[0]}"
        " rows) against the Engine's captured step: every column, the world "
        "hash, the camera and the 6 counters equal (torch.equal) after each "
        f"step; {alive0} -> {alive} alive"
        + (f" (step {spawn_at} lasts {SPAWN_DT} s and fires the mine "
           "spawner)" if spawn_at is not None else "")
        + f"; counters {unpack_drop_stats(progs.drops)}; no kernel "
        f"launched; collectives a step on one rank: {comms[0]} {comms[1]}")
    inputs = frame_inputs(0)
    eager = progs.program_function(("step",))
    mode = {}

    def one():
        if mode["which"] == "captured":
            progs.step(inputs, DT)
        elif mode["which"] == "engine":
            eng.step(inputs, DT)
        else:
            eng._feed(inputs.pack_with_dt(DT))
            eager(progs._state)

    turns = tm(one, MESH_STEP_TURNS, lambda w: mode.update(which=w),
               frames=PARTITIONED_TURN_STEPS, log=log, label="mesh",
               what=f"{label} step, the captured partitioned step against "
               "the Engine's captured step and the partitioned step's "
               "function run eagerly (a record): ")[0]
    secs = progs.capture_seconds()
    rec = dict(steps=steps, alive=alive, ms=turns,
               capture_s=sum(secs.values()),
               pool_mib=graph_pool_bytes(progs) / 2**20,
               collectives=comms[0])
    log(f"[mesh] {label}: the step program captured in "
        f"{rec['capture_s']:.2f} s (two warm-ups included), graph pool "
        f"{rec['pool_mib']:.1f} MiB")
    restore_state(eng, state)
    return rec


def mesh_frames(eng):
    """The captured sharded frame (``ShardedPrograms.frame``) against
    ``Engine.frame`` from the same state at tile budgets 1.0, over
    interval x slots + 1 frames (both shadow decisions' programs captured,
    every slot refreshed, the map program replayed): image (torch.equal),
    world hash, shadow state and the launches of K1, K2 and K3 each frame
    equal; then one more frame's
    program function run eagerly through the plain versions against its
    replay (phase 3's limits: the image within 1e-5, the world and the
    shadow maps equal); then ms a frame in turns. Returns the record and
    the launches of the frames' run. The engine's state is put back."""
    import torch

    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.parallel import ShardedPrograms, make_mesh
    from render_engine_tpu_torch.parallel import columns
    from render_engine_tpu_torch.runtime import engine as E
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm
    from render_engine_tpu_torch.utils.hashing import world_hash

    state = engine_state(eng)
    s0 = eng.config.render
    eng.config.render = dataclasses.replace(s0, texture_tile_budget=1.0,
                                            shadow_tile_budget=1.0)
    progs = ShardedPrograms(eng, make_mesh(1))
    c = eng.config
    frames = c.shadow_update_interval * c.shadow_slots + 1
    kernels.reset_launch_counts()
    run = {}
    for i in range(frames):
        before = dict(kernels.LAUNCHES)
        img_s = progs.frame(frame_inputs(i), DT)
        got = launch_delta(before)
        for k, n in got.items():
            run[k] = run.get(k, 0) + n
        before = dict(kernels.LAUNCHES)
        img_e = eng.frame(frame_inputs(i), DT)
        want = launch_delta(before)
        sh_s, sh_e = progs.shadow_state, eng.shadow_state
        same = {"image": torch.equal(img_s, img_e),
                "hash": world_hash(progs.world) == world_hash(eng.world),
                "shadow": all(torch.equal(a, b) for a, b in zip(
                    (sh_s.maps, sh_s.light_mats, sh_s.slot_entity,
                     sh_s.slot_face), (sh_e.maps, sh_e.light_mats,
                                       sh_e.slot_entity, sh_e.slot_face))),
                "launches": got == want}
        if not all(same.values()):
            raise RuntimeError(
                f"[mesh] frame {i}: the captured sharded frame differs from "
                f"Engine.frame in {[k for k, v in same.items() if not v]} "
                f"(launches {got} against {want})")
    for k in MAIN_PATH:
        if run.get(k, 0) == 0:
            raise RuntimeError(f"[mesh] {k}: no launch in the sharded "
                               f"frames' run {run}")
    programs = sorted(progs.captured_programs, key=str)
    log(f"[mesh] headline 1080p/10k, tile budgets 1.0: {frames} frames of "
        f"the captured sharded frame against Engine.frame: images "
        "(torch.equal), world hashes, shadow state and kernel launches "
        f"equal each frame; programs {programs}; launches in the "
        f"{frames} frames' run {run}")
    # one more frame, its program's function run eagerly through the plain
    # versions from the same state and inputs
    i = frames
    decision, slot, _, _ = E.shadow_schedule(
        progs._sh_tick, progs._sh_cursor, c.shadow_update_interval,
        progs._state.shadow)
    key = ("frame", decision)
    eng._feed(frame_inputs(i).with_prev(progs._prev_keys).pack_with_dt(DT),
              slot)
    pre = progs._state.clone()
    img = progs.frame(frame_inputs(i), DT)
    with Plain():
        progs.program_function(key)(pre)
    torch.cuda.synchronize()
    err = check_close("sharded frame program", [img], [pre.image], 1e-5)
    rows = progs.rows
    exact = all(torch.equal(v, columns(pre.world)[k])
                for k, v in columns(rows).items()) and all(
        torch.equal(a, b) for a, b in zip(progs._state.shadow, pre.shadow))
    log(f"[mesh] frame {i}, program {key}: its replay against its function "
        "run eagerly through the plain versions of K1, K2 and K3: image max "
        f"abs diff {err:.3g} (tolerance 1e-5), world and shadow tables "
        f"equal {exact}")
    if not exact:
        raise RuntimeError("[mesh] the sharded frame's replay and its plain "
                           "run differ in the world or the shadow tables")
    comms = collectives(progs, key)
    mode = {}
    turns = tm(lambda: (progs.frame(None, DT) if mode["which"] == "sharded"
                        else eng.frame(None, DT)),
               MESH_FRAME_TURNS, lambda w: mode.update(which=w),
               frames=MESH_TURN_FRAMES, log=log, label="mesh",
               what="headline frame, the captured sharded frame on one "
               "rank against Engine.frame (a record): ")[0]
    secs = progs.capture_seconds()
    rec = dict(frames=frames, programs=len(secs),
               capture_s=sum(secs.values()),
               pool_mib=graph_pool_bytes(progs) / 2**20,
               collectives=comms[0], plain_max_abs=err, ms=turns,
               launches=run)
    log(f"[mesh] {len(secs)} sharded frame programs captured in "
        f"{rec['capture_s']:.2f} s (two warm-ups each included): "
        + ", ".join(f"{program_name(k)} {v:.2f}" for k, v in sorted(
            secs.items(), key=str))
        + f"; graph pool {rec['pool_mib']:.1f} MiB (the Engine's "
        f"{graph_pool_bytes(eng) / 2**20:.1f}); collectives a frame on one "
        f"rank: {comms[0]} {comms[1]}")
    eng.config.render = s0
    restore_state(eng, state)
    return rec, run


def phase_mesh():
    """Phase 15 (module docstring)."""
    import torch
    import torch.distributed as dist

    from benchmarks import run_benchmarks_torch as RB
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    out = {}
    init_one_rank_nccl()
    try:
        eng = build_space_engine(device="cuda", **SLICE)
        eng.config.record_history = False
        out["headline_step"] = mesh_steps(
            "headline 1080p/10k", eng, PARTITIONED_STEPS,
            spawn_at=PARTITIONED_SPAWN_AT)
        out["headline_frame"], launches = mesh_frames(eng)
        del eng
        torch.cuda.empty_cache()
        _, eng = RB.bench_tick(scale=1.0, frames=1, burst=2)
        out["tick_step"] = mesh_steps("tick-100k", eng, TICK_STEPS)
        del eng
        torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    log(json.dumps({"mesh": out}))
    return launches


# phase 16: the JAX package's default render route (fused_shading=False)
# on the headline
DEFAULT_TURNS = ("fused", "nonfused", "nonfused", "fused") * 2
PARSE_REPS = 20


def native_obj_parse():
    """The native OBJ parser loaded; the demo station's parse through it
    equal to the Python parse, and the ms of each (median of PARSE_REPS
    calls, in turns)."""
    import numpy as np

    from render_engine_tpu_torch.demo.space_scene import STATION_OBJ
    from render_engine_tpu_torch.models import obj_loader as OL
    from render_engine_tpu_torch.native.build import obj_native

    if obj_native() is None:
        raise RuntimeError("[default-route] the native OBJ parser did not "
                           "build or load")
    times = {"native": [], "python": []}
    out = {}
    saved = os.environ.get("RE_TPU_NATIVE")
    try:
        for _ in range(PARSE_REPS):
            for which in ("native", "python", "python", "native"):
                os.environ["RE_TPU_NATIVE"] = "1" if which == "native" \
                    else "0"
                t0 = time.perf_counter()
                out[which] = OL.load_obj(STATION_OBJ)
                times[which].append((time.perf_counter() - t0) * 1e3)
    finally:
        if saved is None:
            os.environ.pop("RE_TPU_NATIVE", None)
        else:
            os.environ["RE_TPU_NATIVE"] = saved
    same = all(np.array_equal(a, b) for a, b in zip(out["native"][:5],
                                                    out["python"][:5])) and \
        [m["name"] for m in out["native"][5]] == \
        [m["name"] for m in out["python"][5]]
    ms = {k: statistics.median(v) for k, v in times.items()}
    log(f"[default-route] native OBJ parser loaded; the station "
        f"({out['native'][0].shape[0]} vertices, {out['native'][3].shape[0]}"
        f" triangles) parsed in {ms['native']:.4f} ms native against "
        f"{ms['python']:.4f} ms in Python (host clock, median of "
        f"{2 * PARSE_REPS} each); equal: {same}")
    if not same:
        raise RuntimeError("[default-route] the native and Python parses of "
                           "the station differ")
    return ms


def route_engine(fused):
    """The headline engine on the card, rendering through K3 (``fused``,
    the demo's setting) or on the JAX package's default route; the
    setting is the engine's initial one, which ``reset`` keeps."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    eng = build_space_engine(device="cuda", **SLICE)
    eng.config.record_history = False
    if not fused:
        eng.config.render = dataclasses.replace(eng.config.render,
                                                fused_shading=False)
        eng.finalize_scene()
    return eng


def default_counted_run(eng):
    """WARMUP + TIMED captured frames from the reset state: each launches
    K1 twice on map frames and once otherwise, the tall G-buffer kernel and
    the shading kernel once each and no K2 or K3; the image finite and
    lit; the 13 drop counters 0. Returns the launches, the median ms and
    the peak device memory."""
    import torch

    from render_engine_tpu_torch import kernels

    eng.reset()
    interval = eng.config.shadow_update_interval
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    times = []
    for i in range(WARMUP + TIMED):
        before = dict(kernels.LAUNCHES)
        renders_map = eng.shadow_state.tick % interval == 0
        t0 = time.perf_counter()
        img = eng.frame(None, DT)
        torch.cuda.synchronize()
        if i >= WARMUP:
            times.append((time.perf_counter() - t0) * 1e3)
        want = dict(frame_launches(renders_map, resolve=0, deferred=1,
                                   tall=1), fused_shade=0)
        if launch_delta(before) != want:
            raise RuntimeError(f"[default-route] frame {i} launched "
                               f"{launch_delta(before)}, expected {want}")
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    lit = float((img.amax(dim=-1) > 0.05).double().mean())
    med = statistics.median(times)
    log(f"[default-route] launches in {WARMUP + TIMED} captured frames: "
        f"{launches} (K1 twice on map frames, once on the rest; "
        f"tall_gbuffer and deferred_shade once a frame; no K2, no K3); "
        f"{TIMED} timed frames: median "
        f"{med:.2f} ms/frame, "
        f"min {min(times):.2f}, max {max(times):.2f}; peak device memory "
        f"{peak / 2**20:.0f} MiB; image max {float(img.max()):.3f}, share "
        f"of pixels above 0.05: {lit:.4f}")
    if not (bool(torch.isfinite(img).all()) and float(img.max()) > 0.5
            and lit > 1e-3):
        raise RuntimeError("[default-route] the image is not finite or "
                           "(nearly) blank")
    missing = [k for k in ("tile_raster", "tile_raster_one_pass",
                           "tall_gbuffer", "deferred_shade")
               if launches[k] == 0]
    if missing:
        raise RuntimeError(f"[default-route] launched no {missing}")
    drops = eng.drop_stats()
    log(f"[default-route] drop counters ({len(drops)}): {drops}")
    if len(drops) != DROP_KEYS or any(drops.values()):
        raise RuntimeError(f"expected {DROP_KEYS} drop counters, all 0")
    return launches, med, peak


def hold_default_kernels(eng):
    """One eager frame of ``eng`` that renders a shadow map, every kernel
    call's inputs captured: K1 in both modes against its plain version,
    exact; one call of the tall G-buffer kernel over every tile of both
    layers and none of K2 or K3; one call of the shading kernel. Returns
    the tall G-buffer kernel's arguments and the shading kernel's."""
    import torch

    from render_engine_tpu_torch.render import deferred_shade as DS
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.render import shade_pallas as SP
    from render_engine_tpu_torch.render import tall_gbuffer as TG

    nt = -(-SLICE["height"] // 8) * -(-SLICE["width"] // 128)
    interval = eng.config.shadow_update_interval
    while eng.shadow_state.tick % interval:
        eng.frame(None, DT)
    with Eager(eng), Capture(RP, "tile_raster") as k1, \
            Capture(RP, "resolve_attributes_pallas") as k2, \
            Capture(SP, "shade_tiles") as k3, \
            Capture(TG, "tall_gbuffer") as tall, \
            Capture(DS, "deferred_shade") as ds:
        eng.frame(None, DT)
    modes = [kw["two_pass"] for _, kw in k1.calls]
    tiles = [[la[0].shape[0] for la in a[0]] for a, _ in tall.calls]
    if (modes != [False, True] or tiles != [[nt, nt]] or k2.calls
            or k3.calls or len(ds.calls) != 1):
        raise RuntimeError(f"[default-route] K1 calls with two_pass {modes}, "
                           f"tall_gbuffer over {tiles} tiles, "
                           f"{len(k2.calls)} K2 calls, {len(k3.calls)} K3 "
                           f"calls, {len(ds.calls)} deferred_shade calls")
    for (a, kw), name in zip(k1.calls, ("K1 one-pass", "K1")):
        err = check_close(f"default-route {name}", RP.tile_raster(*a, **kw),
                          RP.tile_raster_reference(*a, **kw), 0.0)
        log(f"[default-route] {name} on this frame's inputs (data "
            f"{tuple(a[0].shape)}): max_abs_err {err:.3g} (exact)")
    torch.cuda.synchronize()
    return tall.calls[0], ds.calls[0]


def tall_planes(out):
    """The planes of ``tall_gbuffer``'s result by name, layer after layer
    (the G-buffer's, then every key of the extras)."""
    planes = {}
    for i, layer in enumerate(("opaque", "transparent")):
        gbuf, extras = out[2 * i], out[2 * i + 1]
        for f in dataclasses.fields(gbuf):
            planes[f"{layer} {f.name}"] = getattr(gbuf, f.name)
        for k, v in extras.items():
            planes[f"{layer} {k}"] = v
    return planes


def tall_agreement(args, kw):
    """The tall G-buffer kernel against its plain version on every plane
    and every pixel of both layers: the same keys, each plane's largest
    difference and differing values (TALL_TOL: equal to the bit)."""
    import torch

    from render_engine_tpu_torch.render import tall_gbuffer as TG

    got = tall_planes(TG.tall_gbuffer(*args, **kw))
    want = tall_planes(TG.tall_gbuffer_reference(*args, **kw))
    torch.cuda.synchronize()
    if list(got) != list(want):
        raise RuntimeError(f"[default-route] tall_gbuffer gives the planes "
                           f"{list(got)}, its plain version {list(want)}")
    rows = []
    for k in want:
        diff = (got[k].double() - want[k].double()).abs()
        rows.append(f"{k} {float(diff.max()):.3g} ({int((diff > 0).sum())})")
    covered = [float((want[f"{la} tri_id"] >= 0).double().mean())
               for la in ("opaque", "transparent")]
    log(f"[default-route] tall_gbuffer vs plain version, headline frame "
        f"(slot {tuple(args[0][0][0].shape)} a layer, rows "
        f"{tuple(args[1].shape)}, covered opaque {covered[0]:.4f}, "
        f"transparent {covered[1]:.4f}), every pixel of both layers: max "
        f"abs diff (values differing): {'; '.join(rows)} (tolerance "
        f"{TALL_TOL})")
    check_close("default-route tall_gbuffer", list(got.values()),
                list(want.values()), TALL_TOL)


def tall_record(args, kw):
    """``tall_agreement`` on the headline frame's arguments, then the
    kernel's record: device ms, the plain version's, bound and share."""
    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch.render import tall_gbuffer as TG

    tall_agreement(args, kw)
    work = KB.tall_gbuffer_work(*args, **kw)
    log(f"[default-route] tall_gbuffer inputs: covered pixels "
        f"{work['covered_pixels']}, distinct rows {work['rows']}, shininess "
        f"plane {kw['spec_packed']}")
    return kernel_record(
        "tall_gbuffer", TALL_TOL,
        lambda: list(tall_planes(TG.tall_gbuffer(*args, **kw)).values()),
        lambda: list(tall_planes(
            TG.tall_gbuffer_reference(*args, **kw)).values()), work)


def deferred_agreement(got, want):
    """The shading kernel's ``(packed, textured)`` against its plain
    version's: the flags equal; the composed pixels over a black background
    (what the frame shows), their largest channel difference and the share
    of pixels beyond DEFERRED_STEP; the largest difference of the covered
    layers' planes and of the textured G-buffer planes, where asked for."""
    import torch

    from render_engine_tpu_torch.render.frame import compose

    (got, g_tex), (want, w_tex) = got, want
    if not torch.equal(got[..., 7], want[..., 7]):
        raise RuntimeError("[default-route] deferred_shade's flags differ "
                           "from its plain version's")
    zero = torch.zeros(got.shape[:-1] + (3,), device=got.device)
    diff = (compose(got, zero) - compose(want, zero)).abs().amax(dim=-1)
    flags = want[..., 7]
    cov_o = torch.remainder(flags, 2.0) >= 1.0
    cov_t = (got[..., 3:6] != 0).any(-1) | (want[..., 3:6] != 0).any(-1)
    planes = torch.cat([
        torch.where(cov_o[..., None], got[..., 0:3] - want[..., 0:3], 0.0),
        torch.where(cov_t[..., None], got[..., 3:6] - want[..., 3:6], 0.0),
        torch.where((flags >= 2.0)[..., None], got[..., 6:7] - want[..., 6:7],
                    0.0)], dim=-1).abs()
    plane_diff = float(planes.max())
    if (g_tex is None) != (w_tex is None):
        raise RuntimeError("[default-route] deferred_shade and its plain "
                           "version disagree on the textured planes")
    if g_tex is not None:
        plane_diff = max([plane_diff] + [
            float((getattr(a, f) - getattr(b, f)).abs().max())
            for a, b in zip(g_tex, w_tex) for f in ("albedo", "normal")])
    return dict(max_diff=float(diff.max()),
                share_beyond=float((diff > DEFERRED_STEP).double().mean()),
                share_differing=float((diff > 0).double().mean()),
                max_plane_diff=plane_diff)


def deferred_check(label, args, kw):
    """The shading kernel on one frame's arguments against its plain
    version: the flags equal, every composed pixel and covered plane within
    DEFERRED_TOL. Returns the agreement and the kernel's result."""
    import torch

    from render_engine_tpu_torch.render import deferred_shade as DS

    got = DS.deferred_shade(*args, **kw)
    want = DS.deferred_shade_reference(*args, **kw)
    torch.cuda.synchronize()
    agree = deferred_agreement(got, want)
    gbuf, _, t_gbuf, _, lights = args[:5]
    sh = kw.get("shadow_state")
    rows = {k: (int(getattr(lights, f"{k}_count")),
                getattr(lights, f"{k}_entity").shape[0])
            for k in ("dir", "pt", "sp")}
    log(f"[default-route] deferred_shade vs plain, {label} "
        f"({tuple(got[0].shape)}; covered opaque "
        f"{float((gbuf.tri_id >= 0).double().mean()):.4f}, transparent "
        f"{float((t_gbuf.tri_id >= 0).double().mean()):.4f}; live / rows "
        f"{rows}; slots "
        f"{None if sh is None else sh.slot_entity.tolist()}, pcf_scale "
        f"{None if sh is None else sh.pcf_scale}; atlas "
        f"{kw.get('atlas') is not None}, shininess plane "
        f"{'shininess' in args[1]}, textured planes "
        f"{bool(kw.get('gbuffer_planes'))}): composed pixels max diff "
        f"{agree['max_diff']:.3g}, share differing "
        f"{agree['share_differing']:.3g}, beyond 2/255 "
        f"{agree['share_beyond']:.3g}; planes max diff "
        f"{agree['max_plane_diff']:.3g} (each at most {DEFERRED_TOL})")
    if not (agree["max_diff"] <= DEFERRED_TOL
            and agree["max_plane_diff"] <= DEFERRED_TOL):
        raise RuntimeError(f"[default-route] deferred_shade differs from its "
                           f"plain version on {label}: {agree}")
    return agree, got


def deferred_record(args, kw):
    """The shading kernel on the headline frame's arguments against its
    plain version (``deferred_check``), its device ms, the plain version's,
    its bound and share."""
    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch.render import deferred_shade as DS

    agree, got = deferred_check("headline frame", args, kw)
    ms = device_ms(lambda: DS.deferred_shade(*args, **kw), 20)
    call_ms = cuda_ms(lambda: DS.deferred_shade(*args, **kw), 20)
    plain_ms = cuda_ms(lambda: DS.deferred_shade_reference(*args, **kw), 3)
    work = KB.deferred_shade_work(*args, **kw)
    bound_ms, bound_by = KB.bound(work["bytes"], work["ops"])
    log(f"[kernels] deferred_shade on the default route's frame "
        f"({tuple(got[0].shape)}): kernel {ms:.4f} ms (one call with its "
        f"host cost {call_ms:.4f} ms), plain {plain_ms:.3f} ms; bound "
        f"{bound_ms:.4f} ms by {bound_by} ({work}), share "
        f"{bound_ms / ms:.3f}")
    return dict(max_abs_err=agree["max_diff"], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share_of_bound=bound_ms / ms, library_ms=None,
                earlier_ms=None, share_beyond=agree["share_beyond"],
                share_differing=agree["share_differing"])


def deferred_frames(eng):
    """``deferred_check`` on DEFERRED_FRAMES (tests/deferred_scenes.py,
    built on the card, with 256^2 maps), on the many-lights engine on the
    default route (its frame's arguments once every slot is mapped) and on
    ``eng`` with a fragment-shading system (the textured G-buffer planes).
    Returns the agreements by label."""
    import torch

    from render_engine_tpu_torch.render import deferred_shade as DS
    from render_engine_tpu_torch.render import frame as F
    from render_engine_tpu_torch.render import shadows as SH

    sys.path.insert(0, os.path.join(HERE, "tests"))
    import deferred_scenes as DSC

    pk = DSC.torch_packages()
    out = {}
    for label, (name, k, width, height, extra, n_pt) in \
            DEFERRED_FRAMES.items():
        if name == "featured":
            w, bank, cam, atlas = DSC.featured(pk, width / height, "cuda")
        else:
            w, bank, cam, atlas = DSC.lit(pk, width / height, extra, "cuda")
        sh = None
        if k is not None:
            sh = SH.create_shadow_state(resolution=256, budget=DSC.LIT_SLOTS,
                                        pcf_scale=k, device="cuda")
            for _ in range(DSC.LIT_SLOTS):
                sh = SH.render_shadow_map(sh, w, cam, bank, max_tris=256)
            if sh.slot_entity.tolist() != [0, 1, 2, 2, 2, 2]:
                raise RuntimeError(f"{label}: slots {sh.slot_entity}")
        s = F.RenderSettings(width=width, height=height, max_tris=256,
                             fused_shading=False, max_point_lights=n_pt)
        with Capture(DS, "deferred_shade") as ds:
            F.render_frame(w, cam, bank, s, atlas=atlas, shadow_state=sh)
        out[label] = deferred_check(label, *ds.calls[0])[0]
    lights = build_lights_engine()
    lights.config.record_history = False
    lights.config.render = dataclasses.replace(lights.config.render,
                                               fused_shading=False)
    lights.finalize_scene()
    lights.reset()
    warm = (lights.config.shadow_update_interval
            * lights.config.shadow_slots + 1)
    with Eager(lights), Capture(DS, "deferred_shade") as ds:
        for _ in range(warm):
            lights.frame(None, DT)
    out["many lights"] = deferred_check("the many-lights engine",
                                        *ds.calls[-1])[0]
    del lights
    saved = eng.compiled_systems
    eng.compiled_systems = custom_systems(eng)[0]
    try:
        with Eager(eng), Capture(DS, "deferred_shade") as ds:
            eng.render()
    finally:
        eng.compiled_systems = saved
    if not ds.calls[0][1]["gbuffer_planes"]:
        raise RuntimeError("[default-route] the shading system's frame asked "
                           "for no textured planes")
    out["shading system"] = deferred_check(
        "the headline engine with a fragment-shading system",
        *ds.calls[0])[0]
    torch.cuda.empty_cache()
    return out


def phase_default_route():
    """Phase 16 (module docstring). Returns the K2, shading-kernel and tall
    G-buffer records of the route, the launches of its counted run and the
    run's frame count."""
    import torch

    from render_engine_tpu_torch import kernel_bounds as KB
    from render_engine_tpu_torch import kernels
    from render_engine_tpu_torch.render import raster_pallas as RP
    from render_engine_tpu_torch.runtime.profiling import turn_medians as tm

    parse_ms = native_obj_parse()
    torch.cuda.empty_cache()
    eng = route_engine(fused=False)
    launches, med, peak = default_counted_run(eng)
    routes = captured_vs_eager("default route (fused_shading=False) "
                               "1080p/10k, shadows", eng, drive_routes)
    (a_tg, kw_tg), (a_ds, kw_ds) = hold_default_kernels(eng)
    rec_tg = tall_record(a_tg, kw_tg)
    frame_through_plain(eng, "default-route", "whole 1080p frame with "
                        "shadows on the default route")
    rec_ds = deferred_record(a_ds, kw_ds)
    # K2 over every tile of the opaque layer, as the tall G-buffers' plain
    # version runs it, on the same slot plane
    a2 = (a_tg[0][0][0], a_tg[1])
    rec = kernel_record(
        "resolve_nonfused", 0.0,
        lambda: [RP.resolve_attributes_pallas(*a2)],
        lambda: [RP.resolve_attributes_reference(*a2)],
        KB.resolve_work(*a2), k2_gather(*a2))
    eng.reset()
    prof = frame_profile(eng, PROFILE_FRAMES)
    api = ", ".join(f"{k} {v:.1f}" for k, v in sorted(
        prof["host_api"].items()))
    log(f"[default-route] profile: {prof['host_launches']:.1f} host API "
        f"launches a frame ({api}), {prof['device_kernels']:.1f} device "
        f"rows a frame summing to {prof['device_ms']:.3f} ms; the device "
        f"busy {prof['busy_share']:.4f} of the traced window of "
        f"{prof['window_ms']:.3f} ms a frame; the hand kernels in the trace "
        f"in {PROFILE_FRAMES} frames: {prof['kernels_seen']}; the rows that "
        "take the most device time (ms and count a frame): " + "; ".join(
            f"{k} {ms:.3f} ({n:.0f})" for k, ms, n in prof["top"]))
    fused = route_engine(fused=True)
    engines = {"fused": fused, "nonfused": eng}
    warm = eng.config.shadow_update_interval * eng.config.shadow_slots + 1
    shading = {}
    for which, e in engines.items():
        e.reset()
        before = dict(kernels.LAUNCHES)
        for _ in range(warm):  # every frame program captured
            e.frame(None, DT)
        shading[which] = launch_delta(before)["deferred_shade"] / warm
    log(f"[default-route] deferred_shade launches a frame: {shading}")
    if shading != {"fused": 0.0, "nonfused": 1.0}:
        raise RuntimeError("[default-route] deferred_shade should launch "
                           "once a default-route frame and never on the "
                           "fused route")
    mode = {}

    def start(which):
        mode["which"] = which
        engines[which].reset()

    turns = tm(lambda: engines[mode["which"]].frame(None, DT), DEFAULT_TURNS,
               start, frames=TURN_FRAMES, log=log, label="default-route",
               what="captured headline frame, ")[0]
    pools = {k: graph_pool_bytes(e) / 2**20 for k, e in engines.items()}
    log(f"[default-route] graph pools: non-fused {pools['nonfused']:.1f} "
        f"MiB, fused {pools['fused']:.1f} MiB")
    # last: the shading system's frame drops the engine's programs
    branches = deferred_frames(eng)
    out = dict(parse_ms=parse_ms, launches=launches, frames=WARMUP + TIMED,
               ms_per_frame_counted=med, peak_mib=peak / 2**20,
               routes=routes, profile=prof, ms_per_frame=turns,
               pool_mib=pools, deferred_shade_per_frame=shading,
               deferred_shade_frames=branches)
    log(json.dumps({"default_route": out}))
    del eng, fused, engines
    torch.cuda.empty_cache()
    return rec, rec_ds, rec_tg, launches, WARMUP + TIMED


def main() -> int:
    # cuBLAS is deterministic only with a fixed workspace, set before CUDA
    # starts (phase 6 runs with deterministic algorithms)
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--earlier", metavar="DIR",
                    help="an earlier checkout whose kernels to time in "
                         "turns with the current ones")
    ap.add_argument("--shadow-routes", metavar="NPZ",
                    help="write phase 12's shadowed frame's inputs and both "
                         "routes' PCF factors there (read by "
                         "scripts/shadow_routes_jax.py)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import render_engine_tpu_torch  # noqa: F401  (fails outside the repo)
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {smi}")
    phase_build()
    earlier = None
    if args.earlier:
        from render_engine_tpu_torch import kernels

        src = os.path.join(args.earlier, "render_engine_tpu_torch", "csrc")
        earlier = kernels.load(kernels.build(
            csrc=src, lib_path=os.path.join(args.earlier, "_build",
                                            "librender_kernels.so")))
        log(f"[build] earlier kernels from {src}")

    t0 = time.perf_counter()
    eng = build_space_engine(device="cuda", **SLICE)
    eng.config.record_history = False
    log(f"[slice] engine built in {time.perf_counter() - t0:.1f} s: "
        f"{SLICE}")
    rec = phase_kernels(eng, earlier)
    phase_frame(eng)
    phase_bands(eng)
    launches_n, _, _ = phase_nonfused(eng, args.shadow_routes)
    phase_small()
    launches = phase_slice(eng)
    replay_launches = phase_replay(eng)
    frames = WARMUP + TIMED
    # per frame: the two-pass main raster once, the one-pass shadow raster
    # on map frames (tile_raster counts both modes)
    per_frame = {"tile_raster": (launches["tile_raster"]
                                 - launches["tile_raster_one_pass"]) / frames,
                 "tile_raster_one_pass": launches["tile_raster_one_pass"]
                 / frames, "resolve": launches["resolve"] / frames,
                 "fused_shade": launches["fused_shade"] / frames}
    rec_c, rec_cg, launches_c, frames_c = phase_custom(eng)
    del eng
    torch.cuda.empty_cache()
    rec_l, launches_l, frames_l = phase_lights(earlier)
    phase_golden()
    phase_configs()
    phase_programs()
    phase_partitioned()
    launches_m = phase_mesh()
    rec_d, rec_ds, rec_tg, launches_d, frames_d = phase_default_route()
    # the branch rows take their launches from their own phase's run; the
    # default route launches no K2 (phase 16 holds it to 0 there)
    launches_d["resolve_nonfused"] = launches_d["resolve"]
    rec.update(resolve_full_frame=rec_c, fused_shade_tile_lists=rec_l,
               resolve_nonfused=rec_d, tall_gbuffer=rec_tg,
               deferred_shade=rec_ds, custom_gbuffer=rec_cg)
    # K2 over every tile no longer runs on the custom frame (phase 8 holds
    # it to 0 there), nor on the non-fused frame (phase 12)
    for name, run, n in (("resolve_full_frame", launches_c, frames_c),
                         ("fused_shade_tile_lists", launches_l, frames_l),
                         ("resolve_nonfused", launches_d, frames_d),
                         ("tall_gbuffer", launches_d, frames_d),
                         ("deferred_shade", launches_d, frames_d),
                         ("custom_gbuffer", launches_c, frames_c)):
        launches[name] = run[name]
        per_frame[name] = run[name] / n
        if run[name] == 0 and name not in ("resolve_full_frame",
                                           "resolve_nonfused"):
            raise RuntimeError(f"{name}: no launch on its path")

    kern = [dict(name=n, route="cuda", source=src, replaces=rep,
                 launches=launches[key], launches_per_frame=per_frame[n],
                 replay_launches=replay_launches.get(key, 0),
                 sharded_frame_launches=launches_m.get(key, 0), **rec[n])
            for n, (key, src, rep) in KERNELS.items()]
    # the non-fused frame (phase 12): K2 over every tile none, the tall
    # G-buffers once for both layers
    kern[list(KERNELS).index("resolve_full_frame")]["nonfused_launches"] = \
        launches_n["resolve"]
    kern[list(KERNELS).index("tall_gbuffer")]["nonfused_launches"] = \
        launches_n["tall_gbuffer"]
    log(json.dumps({"kernels": kern}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
