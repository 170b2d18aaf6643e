"""The Engine: owns world, camera and bank on one device; drives frames.

Port of ``render_engine_tpu/runtime/engine.py``: ``finalize_scene``,
``frame()`` (the step, then the shadow-map update, then the render of the
stepped state with the updated maps, as the JAX package's fused frame
program does), ``render`` / ``render_only``, ``reset``, the burst loops
``run_frames`` and ``run_frames_rendered``, the recorded config events
(``set_draw_distances``, ``set_window``), history recording with
``flush_history`` (runtime/history.py; replayed by runtime/replay.py),
``drop_stats`` with ``render_drop_stats``, and ``fps_stats``. PyTorch runs
eagerly, so there is no compiled program to build: ``frame`` calls the
step, ``render_shadow_map`` and ``render_frame`` directly, and hands the
frame's inputs to the render systems' draw callbacks on every route.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from render_engine_tpu_torch.ecs import world as W
from render_engine_tpu_torch.logic import kinematics as K
from render_engine_tpu_torch.logic.step import (make_step, pack_drop_stats,
                                                unpack_drop_stats)
from render_engine_tpu_torch.logic.types import NUM_KEYS, InputState
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.math.camera import Camera, CameraBuilder
from render_engine_tpu_torch.models.bank import ModelBank, ModelBankBuilder
from render_engine_tpu_torch.render import lighting as LG
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render import shade_pallas as SP
from render_engine_tpu_torch.render import shadows as SH
from render_engine_tpu_torch.render.frame import (render_frame,
                                                  shadow_tile_overflow)
from render_engine_tpu_torch.render.geometry import (build_triangle_batch,
                                                     to_screen)
from render_engine_tpu_torch.render.raster_jnp import _bin_triangles
from render_engine_tpu_torch.runtime.config import EngineConfig
from render_engine_tpu_torch.runtime.history import HistoryLog

_CAMERA_EVENT_KEYS = ("draw_distance", "near", "far", "fov_y")


class Engine:
    def __init__(self, config: EngineConfig, camera: Camera | None = None,
                 device="cuda"):
        self.config = config
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Engine: no CUDA device; pass device='cpu' "
                               "to run on the CPU")
        self.world_config = W.WorldConfig(
            capacity=config.capacity, world_min=config.world_min,
            world_length=config.world_length,
            section_length=config.section_length, registry=config.registry)
        self.world = W.create_world(self.world_config, self.device)
        self.camera = (camera or CameraBuilder().build()).to(self.device)
        self.bank_builder = (
            ModelBankBuilder(lov_fractions=tuple(config.lov_fractions))
            if config.lov_fractions is not None else ModelBankBuilder())
        self.bank: ModelBank | None = None
        self.cubemap = None
        self.atlas = None
        self.compiled_systems = None
        self.shadow_state: SH.ShadowState | None = None
        self.history = HistoryLog()
        self.frame_index = 0
        self._prev_keys = np.zeros(NUM_KEYS, bool)
        self._last_drops = None
        self._frame_times: list[float] = []
        if config.build_scene is not None:
            config.build_scene(self)
        self.finalize_scene()

    # -- scene setup -------------------------------------------------------
    def spawn(self, count: int, **components):
        self.world, idx = W.spawn_host(self.world, count, **components)
        return idx

    def set_skybox(self, cubemap):
        self.cubemap = cubemap

    def set_atlas(self, atlas):
        self.atlas = atlas

    def set_render_systems(self, systems):
        self.config.render_systems = systems

    def finalize_scene(self):
        """Freeze the model bank, refresh every AABB, take the history
        baseline, compile the render systems and the step, create the
        shadow state, and snapshot the initial state."""
        if self.bank is None:
            if not self.bank_builder._models:
                from render_engine_tpu_torch.models import primitives

                self.bank_builder.add_model("__placeholder__",
                                            primitives.cube(1.0))
            self.bank = self.bank_builder.finalize(self.device)
        self.world = K.refresh_transforms(self.world, self.bank.aabb_min,
                                          self.bank.aabb_max,
                                          self.world.alive)
        # the baseline is the refreshed world: the Player uses it verbatim
        self._start_history()
        cfg = self.config
        self._step_fn = make_step(
            tuple(cfg.entity_types), logic_radius=cfg.logic_radius,
            spawn_budget=cfg.spawn_budget,
            collision_budget=cfg.collision_budget,
            collision_pairs=cfg.collision_pairs,
            collision_large_budget=cfg.collision_large_budget)
        self.compiled_systems = None
        rs = cfg.render_systems
        if rs is not None:
            from render_engine_tpu_torch.render.render_system import (
                compile_systems)

            if callable(rs):
                rs = rs(self.bank)
            self.compiled_systems = compile_systems(tuple(rs), self.bank)
        if cfg.enable_shadows:
            self.shadow_state = SH.create_shadow_state(
                cfg.shadow_resolution, budget=cfg.shadow_slots,
                pcf_scale=cfg.shadow_pcf_scale, device=self.device)
        self._initial_state = (
            self.world.clone(), self.camera,
            None if self.shadow_state is None else self.shadow_state.clone(),
            cfg.render)

    def _start_history(self):
        self.history = HistoryLog()
        if self.config.record_history:
            self.history.set_baseline(
                self.world, self.camera,
                meta={"engine": "render_engine_tpu_torch",
                      "capacity": self.config.capacity})

    def reset(self):
        """Back to the post-finalize state at frame zero: world, camera
        (its draw distances too), shadow state and render settings, with a
        fresh history baseline."""
        w0, c0, s0, r0 = self._initial_state
        self.world = w0.clone()
        self.camera = c0
        self.shadow_state = None if s0 is None else s0.clone()
        self.config.render = r0
        self._start_history()
        self.frame_index = 0
        self._prev_keys = np.zeros(NUM_KEYS, bool)
        self._frame_times = []
        self._last_drops = None

    # -- mid-run config changes, recorded and replayed before the frame
    # they preceded --------------------------------------------------------
    def apply_config_event(self, event: dict):
        cam = {k: float(v) for k, v in event.items()
               if k in _CAMERA_EVENT_KEYS}
        if cam:
            self.camera = dataclasses.replace(self.camera, **cam)
        if "window" in event:
            w, h = (int(v) for v in event["window"])
            self.config.render = dataclasses.replace(self.config.render,
                                                     width=w, height=h)
            self.camera = dataclasses.replace(self.camera, aspect=w / h)

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
        (recorded). The step does not read either."""
        self._change_config({"window": [int(width), int(height)]})

    # -- frame loop ----------------------------------------------------------
    def step(self, inputs: InputState, dt: float):
        """Advance the world one tick (no render)."""
        self._step_device(inputs.to_device(self.device), dt)

    def _step_device(self, inputs: InputState, dt: float):
        self.world, self.camera, stats = self._step_fn(
            self.world, self.camera, inputs, dt, self.bank.aabb_min,
            self.bank.aabb_max)
        self._last_drops = pack_drop_stats(stats)

    def update_shadows(self):
        """One shadow-map update of the current state (the interval gate
        and the round-robin schedule run on the host)."""
        cfg = self.config
        self.shadow_state = SH.render_shadow_map(
            self.shadow_state, self.world, self.camera, self.bank,
            max_tris=cfg.shadow_max_tris, interval=cfg.shadow_update_interval,
            lov_bias=cfg.shadow_lov_bias, caster_mask=cfg.shadow_caster_mask)

    def render(self, camera=None, inputs: InputState | None = None
               ) -> torch.Tensor:
        """Render the current state, through ``camera`` (the engine's by
        default), with the current shadow maps, which this does not update:
        (H, W, 3) float32 linear color. ``inputs``: the frame's inputs on
        the engine's device, for the render systems' draw callbacks."""
        return render_frame(self.world,
                            self.camera if camera is None else camera,
                            self.bank, self.config.render,
                            cubemap=self.cubemap, atlas=self.atlas,
                            shadow_state=self.shadow_state,
                            systems=self.compiled_systems, inputs=inputs)

    # the JAX package's name (detached-camera replay views)
    render_only = render

    def frame(self, inputs: InputState | None = None, dt: float = 1.0 / 60.0,
              render: bool = True, advance: str | None = None):
        """Advance one frame: the step, then the shadow-map update if
        ``render`` or ``advance == "fused"``, then (``render``) the render
        of the stepped state. Returns the image or None.

        ``advance`` is the JAX package's choice of compiled program:
        ``"fused"`` (step, shadow update and render in one program) or
        ``"step"`` (the step alone, plus an updating render if ``render``);
        None means fused exactly when rendering. The world never depends on
        it here (there is one eager step); it decides the shadow update,
        and it is recorded with the frame's raw inputs so that logs replay
        in either package with the live run's shadow maps and images.

        The image is not waited for; the frame time recorded is the host's
        dispatch time unless the caller synchronizes."""
        inputs = inputs if inputs is not None else InputState.idle(
            seed=self.frame_index)
        if advance not in (None, "fused", "step"):
            raise ValueError(f"advance must be None, 'fused' or 'step', "
                             f"not {advance!r}")
        fused = advance == "fused" or (advance is None and bool(render))
        if self.config.record_history:
            self.history.record_frame(inputs, dt, fused=fused)
        # last frame's keys ride along as prev_keys: derived from the
        # stream, so replay rebuilds them
        inputs = inputs.with_prev(self._prev_keys)
        self._prev_keys = np.asarray(inputs.keys, bool)
        t0 = time.perf_counter()
        # one transfer: the step and the draw callbacks read the same
        # tensors, live and in a replay
        inputs = inputs.to_device(self.device)
        self._step_device(inputs, dt)
        if self.shadow_state is not None and (render or fused):
            self.update_shadows()
        img = self.render(inputs=inputs) if render else None
        self.frame_index += 1
        self._frame_times.append(time.perf_counter() - t0)
        return img

    def _burst(self, inputs_list, dts, renders, advance):
        if len(inputs_list) != len(dts):
            raise ValueError(f"{len(inputs_list)} inputs for {len(dts)} dts")
        img, drops = None, []
        for inputs, dt, render in zip(inputs_list, dts, renders):
            img = self.frame(inputs, dt, render=render, advance=advance)
            drops.append(self._last_drops)
        if drops:
            # the per-counter max over the burst: an overflow in the middle
            # of it stays visible
            self._last_drops = torch.stack(drops).amax(0)
        return img

    def run_frames(self, inputs_list, dts, render_last: bool = False):
        """Step many frames, recorded (when recording) as step frames. With
        ``render_last`` the last one also updates the shadow maps and
        renders; returns its image, else None. Drop counters are the
        per-counter max over the frames."""
        n = len(dts)
        return self._burst(inputs_list, dts,
                           [render_last and i == n - 1 for i in range(n)],
                           "step")

    def run_frames_rendered(self, inputs_list, dts):
        """Step, update the shadows and render every one of many frames;
        returns the last image. For unrecorded runs: it refuses to run
        while recording."""
        if self.config.record_history:
            raise RuntimeError("run_frames_rendered is for unrecorded runs; "
                               "recorded frames go through frame()")
        return self._burst(inputs_list, dts, [True] * len(dts), None)

    def flush_history(self) -> str | None:
        """Write the history log to ``config.history_dir`` when recording;
        returns the npz path, or None."""
        if self.config.record_history:
            return self.history.write_to_disk(self.config.history_dir)
        return None

    # -- stats ---------------------------------------------------------------
    def fps_stats(self) -> dict:
        if not self._frame_times:
            return {}
        ts = np.asarray(self._frame_times[1:] or self._frame_times)
        return {"frames": len(self._frame_times),
                "mean_ms": float(ts.mean() * 1e3),
                "p50_ms": float(np.percentile(ts, 50) * 1e3),
                "fps": float(1.0 / max(ts.mean(), 1e-9)),
                "drops": self.drop_stats()}

    def drop_stats(self) -> dict:
        """Budget-overflow counters: the last step's (read back here) and
        the render's for the current state (``render_drop_stats``)."""
        out = {}
        if self._last_drops is not None:
            out.update(unpack_drop_stats(self._last_drops))
        out.update(self.render_drop_stats())
        return out

    def render_drop_stats(self) -> dict:
        """Triangle-budget, tile-candidate, texture-tile, light-list and
        shadow overflow of the current state, by re-running the frame's
        geometry and binning (and, with shadows, the next update's shadow
        batch and binning and the main raster for the per-slot PCF
        budget). The texture-tile and light-list budgets exist on the fused
        tiled path only, so ``backend="jnp"`` reports neither. A diagnostic
        off the frame's path: it launches K1 once with shadows and reads
        the counters back once."""
        if self.bank is None:
            return {}
        s = self.config.render
        cfg = s.raster
        world, camera, bank = self.world, self.camera, self.bank
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
        sh = self.shadow_state
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
