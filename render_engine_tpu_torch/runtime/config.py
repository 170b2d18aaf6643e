"""Engine configuration (port of ``render_engine_tpu/runtime/config.py``)."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

from render_engine_tpu_torch.ecs.registry import ComponentRegistry
from render_engine_tpu_torch.logic.types import EntityType
from render_engine_tpu_torch.render.frame import RenderSettings


@dataclasses.dataclass
class EngineConfig:
    capacity: int = 4096
    world_length: float = 16384.0
    section_length: float = 64.0
    world_min: tuple = (0.0, 0.0, 0.0)
    max_fps: float = 60.0  # the host loop's cap (runtime/host_loop.py)
    registry: ComponentRegistry = dataclasses.field(
        default_factory=ComponentRegistry)
    render: RenderSettings = dataclasses.field(default_factory=RenderSettings)
    # a tuple of render_system.RenderSystem, or a callable (bank) -> tuple
    # built once models are registered; None = no systems (every model
    # drawn lit, no routing)
    render_systems: Optional[object] = None
    entity_types: Sequence[EntityType] = ()
    logic_radius: Optional[float] = None  # None -> camera draw distance
    spawn_budget: int = 0
    collision_budget: int = 8
    collision_pairs: int = 4
    collision_large_budget: int = 32
    build_scene: Optional[Callable] = None  # build_scene(engine) -> None
    lov_fractions: Optional[Sequence[float]] = None
    # history recording: every frame's inputs after a baseline snapshot,
    # flushed to history_dir (runtime/history.py)
    history_dir: str = "debug_logs"
    record_history: bool = True

    # shadows: up to shadow_slots maps of shadow_resolution^2, at most one
    # new map per update, an update every shadow_update_interval frames
    enable_shadows: bool = False
    shadow_resolution: int = 1024
    shadow_max_tris: int = 16384
    shadow_slots: int = 6
    # PCF factors every k-th pixel, upsampled in k x k blocks
    shadow_pcf_scale: int = 3
    # what casts: a bool[CAP] mask, a callable fn(world) -> bool[CAP], or
    # None for every model-bearing entity
    shadow_caster_mask: object = None
    shadow_update_interval: int = 1
    # LoV bands the shadow casters shift coarser
    shadow_lov_bias: int = 0
