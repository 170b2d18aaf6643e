"""The program of a configuration with the user's render systems: the
demo's Engine as ``programs/space.py`` builds it, with the scene's render
systems those of ``render_engine_tpu_torch.demo.user_systems`` (a
fragment-shading material on the lit system, a draw callback on the light
sources), the material's four uniforms read from the file's
``"material"``. They reach the Engine through ``build_scene``'s
``Engine.set_render_systems``, the user's path."""

from __future__ import annotations

import dataclasses
import importlib

from port_bench.programs.space import PROGRAM, scene_seed


def build(cfg: dict, seed: int, device, overrides=None):
    """The Engine of the configuration ``cfg`` with the scene drawn from
    ``seed`` and the user's render systems; ``overrides`` changes
    ``space_config`` arguments (the tests' small sizes)."""
    S = importlib.import_module(f"{PROGRAM}.demo.space_scene")
    E = importlib.import_module(f"{PROGRAM}.runtime.engine")
    U = importlib.import_module(f"{PROGRAM}.demo.user_systems")
    material = {k: cfg["material"][k] for k in U.MATERIAL}
    kw = dict(cfg["space_config"], **(overrides or {}))
    scene = dict(cfg["scene"], **{k: v for k, v in (overrides or {}).items()
                                  if k in cfg["scene"]})
    for k in scene:
        kw.pop(k, None)
    ec = S.space_config(**kw, num_asteroids=scene["num_asteroids"],
                        normal_maps=scene["normal_maps"])
    ec.build_scene = lambda e: S.build_scene(
        e, num_asteroids=scene["num_asteroids"], seed=scene_seed(seed),
        normal_maps=scene["normal_maps"], material=material)
    ec.record_history = bool(cfg["record_history"])
    ec.render = dataclasses.replace(ec.render,
                                    fused_shading=bool(cfg["fused_shading"]))
    return E.Engine(ec, camera=S.space_camera(ec.render.width,
                                              ec.render.height),
                    device=device)
