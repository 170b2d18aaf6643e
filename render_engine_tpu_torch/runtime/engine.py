"""The Engine: owns world, camera and bank on one device; drives frames.

Port of ``render_engine_tpu/runtime/engine.py`` for the headline path:
``finalize_scene``, ``frame()`` (the fused advance: the step, then the
render of the stepped state, as the JAX package's unshadowed frame
program does), ``reset``, ``drop_stats`` and ``fps_stats``. PyTorch runs
eagerly, so there is no compiled program to build: ``frame`` calls the
step and ``render_frame`` directly.

Not ported yet: shadows, history recording and replay, ``run_frames`` /
``run_frames_rendered`` (scan-batched frames), the render drop counters
(``render_drop_stats`` re-runs the raster) and mid-run config events.
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
from render_engine_tpu_torch.math.camera import Camera, CameraBuilder
from render_engine_tpu_torch.models.bank import ModelBank, ModelBankBuilder
from render_engine_tpu_torch.render.frame import render_frame
from render_engine_tpu_torch.runtime.config import EngineConfig


class Engine:
    def __init__(self, config: EngineConfig, camera: Camera | None = None,
                 device="cpu"):
        if config.enable_shadows:
            raise NotImplementedError(
                "shadows are not ported yet: build with enable_shadows=False")
        self.config = config
        self.device = torch.device(device)
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
        systems and the step, and snapshot the initial state."""
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
        self._initial_state = (self.world.clone(), self.camera)

    def reset(self):
        """Back to the post-finalize state at frame zero."""
        w0, c0 = self._initial_state
        self.world = w0.clone()
        self.camera = c0
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

    def render(self) -> torch.Tensor:
        """Render the current state: (H, W, 3) float32 linear color."""
        return render_frame(self.world, self.camera, self.bank,
                            self.config.render, cubemap=self.cubemap,
                            atlas=self.atlas, systems=self.compiled_systems)

    def frame(self, inputs: InputState | None = None, dt: float = 1.0 / 60.0,
              render: bool = True):
        """Advance one frame (step, then render the stepped state). Returns
        the image, or None with ``render=False``. The image is not waited
        for; the frame time recorded is the host's dispatch time unless the
        caller synchronizes."""
        inputs = inputs if inputs is not None else InputState.idle(
            seed=self.frame_index)
        inputs = inputs.with_prev(self._prev_keys)
        self._prev_keys = np.asarray(inputs.keys, bool)
        t0 = time.perf_counter()
        self.step(inputs, dt)
        img = self.render() if render else None
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
        """The last step's budget-overflow counters (read back here)."""
        if self._last_drops is None:
            return {}
        return unpack_drop_stats(self._last_drops)
