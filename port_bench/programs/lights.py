"""The program of the many-lights configuration: the port's
``build_many_lights_engine`` (the demo scene with 200 asteroids, a fixed
rig of point lights, per-tile light lists on the fused route) with the
file's frame size, rig size and list budget, and the scene seed drawn
from the run's seed.

The function fixes every other setting itself. The reference reads them
from the file, so the build compares the Engine's settings with what the
file states and fails where they differ."""

from __future__ import annotations

import importlib

from port_bench.programs.space import PROGRAM, scene_seed

# ``overrides`` the program takes: the tests' small sizes;
# ``shadow_resolution`` is set on the Engine after the build (the function
# fixes it)
OVERRIDES = ("width", "height", "n_lights", "light_tile_budget",
             "shadow_resolution")
BUILD_ARGS = ("width", "height", "n_lights", "light_tile_budget")


def arguments(cfg: dict, overrides=None) -> dict:
    """``build_many_lights_engine``'s keywords from the file and
    ``overrides``."""
    unknown = set(overrides or {}) - set(OVERRIDES)
    if unknown:
        raise ValueError(f"the lights program takes no override "
                         f"{sorted(unknown)}")
    sc, li = cfg["space_config"], cfg["lights"]
    kw = {"width": sc["width"], "height": sc["height"],
          "n_lights": li["count"],
          "light_tile_budget": li["light_tile_budget"]}
    kw.update({k: v for k, v in (overrides or {}).items()
               if k in BUILD_ARGS})
    return kw


def stated(cfg: dict, kw: dict, overrides=None) -> dict:
    """The settings the file states, with ``kw`` in place of its frame
    size, rig size and list budget and ``overrides`` in place of its
    other ``space_config`` values, in the names of ``shown``."""
    sc = dict(cfg["space_config"], **{
        k: v for k, v in (overrides or {}).items()
        if k in cfg["space_config"]})
    li = cfg["lights"]
    out = {k: sc[k] for k in (
        "capacity", "max_tris", "raster_tile_budget", "trans_tile_budget",
        "shadow_tile_budget", "shadow_resolution", "shadow_slots",
        "shadow_update_interval", "shadow_max_tris", "shadow_lov_bias",
        "shadow_pcf_scale", "enable_shadows")}
    out.update(width=kw["width"], height=kw["height"],
               point_lights=kw["n_lights"], max_point_lights=kw["n_lights"],
               light_tile_budget=kw["light_tile_budget"],
               max_dir_lights=li["max_dir_lights"],
               max_spot_lights=li["max_spot_lights"],
               num_asteroids=cfg["scene"]["num_asteroids"],
               normal_maps=cfg["scene"]["normal_maps"],
               fused_shading=cfg["fused_shading"],
               record_history=cfg["record_history"])
    return out


def shown(eng, S, R) -> dict:
    """The same settings as the Engine ``eng`` holds them (``S``, ``R``:
    the port's ``demo.space_scene`` and ``ecs.registry``)."""
    c = eng.config
    r = c.render
    w = eng.world
    alive = w.alive
    return {
        "capacity": c.capacity, "max_tris": r.max_tris,
        "raster_tile_budget": r.raster.tile_budget,
        "trans_tile_budget": r.raster.trans_tile_budget,
        "shadow_tile_budget": r.shadow_tile_budget,
        "shadow_resolution": c.shadow_resolution,
        "shadow_slots": c.shadow_slots,
        "shadow_update_interval": c.shadow_update_interval,
        "shadow_max_tris": c.shadow_max_tris,
        "shadow_lov_bias": c.shadow_lov_bias,
        "shadow_pcf_scale": c.shadow_pcf_scale,
        "enable_shadows": c.enable_shadows,
        "width": r.width, "height": r.height,
        "point_lights": int(w.sortable_mask(R.SORTABLE_POINT).sum()),
        "max_point_lights": r.max_point_lights,
        "light_tile_budget": r.light_tile_budget,
        "max_dir_lights": r.max_dir_lights,
        "max_spot_lights": r.max_spot_lights,
        "num_asteroids": int((alive & (w["type_id"] == S.TYPE_ASTEROID))
                             .sum()),
        "normal_maps": bool(eng.bank.has_normal_maps()),
        "fused_shading": r.fused_shading,
        "record_history": c.record_history}


def build(cfg: dict, seed: int, device, overrides=None):
    """The Engine of the configuration ``cfg`` with the scene drawn from
    ``seed``; ``overrides`` changes the frame size, the rig's size and the
    list budget (the tests' small sizes)."""
    S = importlib.import_module(f"{PROGRAM}.demo.space_scene")
    R = importlib.import_module(f"{PROGRAM}.ecs.registry")
    kw = arguments(cfg, overrides)
    eng = S.build_many_lights_engine(device=device, seed=scene_seed(seed),
                                     **kw)
    if "shadow_resolution" in (overrides or {}):
        eng.config.shadow_resolution = int(overrides["shadow_resolution"])
        eng.finalize_scene()
    want, got = stated(cfg, kw, overrides), shown(eng, S, R)
    off = {k: (want[k], got[k]) for k in want if want[k] != got[k]}
    if off:
        raise ValueError(f"the Engine's settings are not the file's "
                         f"(file, Engine): {off}")
    return eng
