"""The Engine: owns world, camera and bank on one device; drives frames.

Port of ``render_engine_tpu/runtime/engine.py`` for the headline path:
``finalize_scene``, ``frame()`` (the step, then the shadow-map update,
then the render of the stepped state with the updated maps, as the JAX
package's fused frame program does), ``render``, ``reset``,
``drop_stats`` with ``render_drop_stats``, and ``fps_stats``. PyTorch
runs eagerly, so there is no compiled program to build: ``frame`` calls
the step, ``render_shadow_map`` and ``render_frame`` directly.

Not ported yet: history recording and replay, ``run_frames`` /
``run_frames_rendered`` (scan-batched frames), mid-run config events and
the ``light_tile_overflow`` counter (tile light lists are not ported).
"""

from __future__ import annotations

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
from render_engine_tpu_torch.render import raster_pallas as RP
from render_engine_tpu_torch.render import shadows as SH
from render_engine_tpu_torch.render.frame import (render_frame,
                                                  shadow_tile_overflow)
from render_engine_tpu_torch.render.geometry import (build_triangle_batch,
                                                     to_screen)
from render_engine_tpu_torch.render.raster_jnp import _bin_triangles
from render_engine_tpu_torch.runtime.config import EngineConfig


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
        """Freeze the model bank, refresh every AABB, compile the render
        systems and the step, create the shadow state, and snapshot the
        initial state."""
        if self.bank is None:
            if not self.bank_builder._models:
                from render_engine_tpu_torch.models import primitives

                self.bank_builder.add_model("__placeholder__",
                                            primitives.cube(1.0))
            self.bank = self.bank_builder.finalize(self.device)
        self.world = K.refresh_transforms(self.world, self.bank.aabb_min,
                                          self.bank.aabb_max,
                                          self.world.alive)
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
            None if self.shadow_state is None else self.shadow_state.clone())

    def reset(self):
        """Back to the post-finalize state at frame zero."""
        w0, c0, s0 = self._initial_state
        self.world = w0.clone()
        self.camera = c0
        self.shadow_state = None if s0 is None else s0.clone()
        self.frame_index = 0
        self._prev_keys = np.zeros(NUM_KEYS, bool)
        self._frame_times = []
        self._last_drops = None

    # -- frame loop ----------------------------------------------------------
    def step(self, inputs: InputState, dt: float):
        """Advance the world one tick (no render)."""
        self.world, self.camera, stats = self._step_fn(
            self.world, self.camera, inputs.to_device(self.device), dt,
            self.bank.aabb_min, self.bank.aabb_max)
        self._last_drops = pack_drop_stats(stats)

    def update_shadows(self):
        """One shadow-map update of the current state (the interval gate
        and the round-robin schedule run on the host)."""
        cfg = self.config
        self.shadow_state = SH.render_shadow_map(
            self.shadow_state, self.world, self.camera, self.bank,
            max_tris=cfg.shadow_max_tris, interval=cfg.shadow_update_interval,
            lov_bias=cfg.shadow_lov_bias, caster_mask=cfg.shadow_caster_mask)

    def render(self) -> torch.Tensor:
        """Render the current state with the current shadow maps (which
        this does not update): (H, W, 3) float32 linear color."""
        return render_frame(self.world, self.camera, self.bank,
                            self.config.render, cubemap=self.cubemap,
                            atlas=self.atlas, shadow_state=self.shadow_state,
                            systems=self.compiled_systems)

    def frame(self, inputs: InputState | None = None, dt: float = 1.0 / 60.0,
              render: bool = True):
        """Advance one frame: the step, then (``render=True``) the
        shadow-map update and the render of the stepped state. Returns the
        image, or None with ``render=False``, which steps only and leaves
        the shadow state alone. The image is not waited for; the frame time
        recorded is the host's dispatch time unless the caller
        synchronizes."""
        inputs = inputs if inputs is not None else InputState.idle(
            seed=self.frame_index)
        inputs = inputs.with_prev(self._prev_keys)
        self._prev_keys = np.asarray(inputs.keys, bool)
        t0 = time.perf_counter()
        self.step(inputs, dt)
        img = None
        if render:
            if self.shadow_state is not None:
                self.update_shadows()
            img = self.render()
        self.frame_index += 1
        self._frame_times.append(time.perf_counter() - t0)
        return img

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
        """Triangle-budget, tile-candidate, texture-tile and shadow
        overflow of the current state, by re-running the frame's geometry
        and binning (and, with shadows, the next update's shadow batch and
        binning and the main raster for the per-slot PCF budget). A
        diagnostic off the frame's path: it launches K1 once with shadows
        and reads the counters back once."""
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
        if self.atlas is not None:
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
