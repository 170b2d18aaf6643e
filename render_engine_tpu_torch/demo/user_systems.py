"""The demo's render systems as a user writes them: a fragment-shading
material on the lit system and a draw callback on the light sources.

The reference engine's render systems take a user's fragment-shader body
and per-frame draw callbacks that filter instances by sortable bucket,
gate on state and write uniforms (``src/render_system/builder.rs``,
``src/space_logic/render_systems/render_system_setup.rs``). Here the demo's
two default systems (``prelude.default_render_system``) get:

* on the lit system, ``fog_rim``: distance fog over the default lit color
  with a rim light at grazing angles, read from four static uniforms
  (``MATERIAL``);
* on the light sources, ``light_source_draw``: the spot-light instances
  drawn while the camera is in front of the scene's z = 0 plane, the
  emissive boost written every frame, the skybox on under the same gate.

``space_scene.build_scene(..., material=...)`` installs them through
``Engine.set_render_systems``. Both callbacks run inside the Engine's
captured frame program: everything they read per frame is a tensor, and a
number becomes one through ``utils.consts.on_device``."""

from __future__ import annotations

import torch

from render_engine_tpu_torch.ecs.registry import SORTABLE_SPOT
from render_engine_tpu_torch.prelude.default_render_system import (
    default_render_systems)
from render_engine_tpu_torch.render.render_system import (RenderSystem,
                                                          RenderSystemBuilder)
from render_engine_tpu_torch.utils.consts import on_device

# fog toward a deep-space blue, a cold rim light; units are world units
MATERIAL = {"fog_color": (0.02, 0.03, 0.08), "fog_density": 2.5e-4,
            "rim_color": (0.35, 0.5, 1.0), "rim_power": 3.0}


def fog_rim(sp):
    """With ``d`` the distance from the camera, ``V`` the unit vector to
    it and ``f = exp(-fog_density * d)``: ``f * (base_color + rim_color *
    (1 - max(N . V, 0)) ** rim_power) + (1 - f) * fog_color``, clipped to
    [0, 1]."""
    dev = sp.base_color.device
    u = {k: on_device(sp.uniforms[k], device=dev) for k in MATERIAL}
    to_cam = sp.camera.position - sp.position
    d = torch.linalg.vector_norm(to_cam, dim=-1, keepdim=True)
    v = to_cam / d.clamp(min=1e-6)
    f = torch.exp(-u["fog_density"] * d)
    ndv = (sp.normal * v).sum(dim=-1, keepdim=True).clamp(min=0.0)
    rim = u["rim_color"] * (1.0 - ndv) ** u["rim_power"]
    return (f * (sp.base_color + rim) + (1.0 - f) * u["fog_color"]).clamp(
        0.0, 1.0)


def light_source_draw(model_ids: tuple):
    """The light sources' draw callback over their ``model_ids``: the
    instances in the spot-light bucket, while the camera's z is positive;
    the emissive boost written as 1 (the system's own boost stands); the
    skybox under the same gate."""
    def draw(dp):
        front = dp.get_camera().position[2] > 0.0
        dp.draw_models(*model_ids, sortable=SORTABLE_SPOT, when=front)
        dp.write_uniform("emissive_boost", 1.0)
        dp.draw_skybox(front)

    return draw


def _builder(system: RenderSystem) -> RenderSystemBuilder:
    """A builder holding ``system``'s models, lighting, boost, levels of
    view and uniforms."""
    b = (RenderSystemBuilder(system.name).with_models(*system.model_ids)
         .with_lighting(system.lit)
         .with_emissive_boost(system.emissive_boost)
         .with_levels_of_view(system.casts_lov))
    for name, value in system.uniforms:
        b.write_uniform(name, value)
    return b


def user_render_systems(bank, star_model: int,
                        material: dict | None = None
                        ) -> tuple[RenderSystem, ...]:
    """The demo's default systems (the lit one over every model but the
    stars, the stars' unlit one) with ``fog_rim`` and ``material``'s
    uniforms (``MATERIAL`` where None) on the lit system and
    ``light_source_draw`` on the light sources."""
    material = MATERIAL if material is None else material
    lit, sources = default_render_systems(bank,
                                          emissive_models=(star_model,))
    shaded = _builder(lit).with_fragment_shading(fog_rim)
    for name in MATERIAL:
        value = material[name]
        shaded.write_uniform(name, tuple(float(x) for x in value)
                             if isinstance(value, (list, tuple))
                             else float(value))
    drawn = _builder(sources).with_draw_function(
        light_source_draw(sources.model_ids))
    return shaded.build(), drawn.build()
