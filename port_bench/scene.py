"""The program's engine of a configuration file.

The program is ``render_engine_tpu_torch``: the demo's ``space_config``
with the file's settings, its ``build_scene`` with the scene seed drawn
from the run's seed, the file's route and recording switch, and the demo
camera."""

from __future__ import annotations

import dataclasses
import importlib

PROGRAM = "render_engine_tpu_torch"


def scene_seed(seed: int) -> int:
    """The seed ``build_scene`` draws the asteroids' shapes and orbits
    from."""
    return int(seed) % (1 << 32)


def build(cfg: dict, seed: int, device, overrides=None):
    """The Engine of the configuration ``cfg`` (a parsed file of
    ``configs/``) with the scene drawn from ``seed``. ``overrides`` changes
    ``space_config`` arguments (the tests' small sizes)."""
    S = importlib.import_module(f"{PROGRAM}.demo.space_scene")
    E = importlib.import_module(f"{PROGRAM}.runtime.engine")
    kw = dict(cfg["space_config"], **(overrides or {}))
    scene = dict(cfg["scene"], **{k: v for k, v in (overrides or {}).items()
                                  if k in cfg["scene"]})
    for k in scene:
        kw.pop(k, None)
    ec = S.space_config(**kw, num_asteroids=scene["num_asteroids"],
                        normal_maps=scene["normal_maps"])
    ec.build_scene = lambda e: S.build_scene(
        e, num_asteroids=scene["num_asteroids"], seed=scene_seed(seed),
        normal_maps=scene["normal_maps"])
    ec.record_history = bool(cfg["record_history"])
    ec.render = dataclasses.replace(ec.render,
                                    fused_shading=bool(cfg["fused_shading"]))
    return E.Engine(ec, camera=S.space_camera(ec.render.width,
                                              ec.render.height),
                    device=device)
