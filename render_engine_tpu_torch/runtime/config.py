"""Engine configuration (port of ``render_engine_tpu/runtime/config.py``).

Shadows, history recording and the replay player are not ported yet:
``enable_shadows`` is kept so scenes can ask for them, and ``Engine``
refuses it.
"""

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
    enable_shadows: bool = False
