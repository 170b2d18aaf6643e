"""The default render-system set: a lit deferred system over every model
and an unlit light-source system at the demo's 6x emissive boost.

Port of ``render_engine_tpu/prelude/default_render_system.py``.
"""

from __future__ import annotations

from render_engine_tpu_torch.render.render_system import (
    RenderSystem,
    RenderSystemBuilder,
)

EMISSIVE_BOOST_DEFAULT = 6.0


def default_render_systems(bank, *, emissive_models: tuple = (),
                           emissive_boost: float = EMISSIVE_BOOST_DEFAULT
                           ) -> tuple[RenderSystem, ...]:
    all_models = tuple(range(bank.num_models))
    lit_models = tuple(m for m in all_models if m not in set(emissive_models))
    systems = []
    if lit_models:
        systems.append(
            RenderSystemBuilder("default").with_models(*lit_models).build())
    if emissive_models:
        systems.append(
            RenderSystemBuilder("light_sources")
            .with_models(*emissive_models)
            .with_lighting(False)
            .with_emissive_boost(emissive_boost)
            .build())
    return tuple(systems)
