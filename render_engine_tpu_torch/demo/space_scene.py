"""The space scene: stars, orbiting asteroids, a wormhole, a mine producer,
a textured station and the player ship.

Port of ``render_engine_tpu/demo/space_scene.py``: the same scene from the
same seeds, ``space_config`` with the same budgets, and the four logic
callbacks rewritten for tensors. The station is read from the tracked
asset ``debug_out/assets/station.{obj,mtl}`` with ``panels.ppm`` and
``bumps.ppm`` (resolved against the repository root, never written).
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from render_engine_tpu_torch.ecs import changes as C
from render_engine_tpu_torch.ecs import registry as R
from render_engine_tpu_torch.logic import random as RND
from render_engine_tpu_torch.logic.types import (KEY_A, KEY_D, KEY_S,
                                                 KEY_SHIFT, KEY_SPACE, KEY_W,
                                                 EntityType)
from render_engine_tpu_torch.math import transforms as T
from render_engine_tpu_torch.math.camera import CameraBuilder
from render_engine_tpu_torch.models import primitives
from render_engine_tpu_torch.render import skybox as SB
from render_engine_tpu_torch.render.frame import RenderSettings
from render_engine_tpu_torch.render.raster_jnp import RasterConfig
from render_engine_tpu_torch.runtime.config import EngineConfig
from render_engine_tpu_torch.runtime.engine import Engine
from render_engine_tpu_torch.utils.consts import const
from render_engine_tpu_torch.utils.indexing import gather_row

TYPE_STAR = 0
TYPE_ASTEROID = 1
TYPE_WORMHOLE = 2
TYPE_MINE_PRODUCER = 3
TYPE_MINE = 4
TYPE_USER = 5
TYPE_STATION = 6

SHIP_ACCEL = 40.0
SHIP_DECAY = 0.96
WORMHOLE_IMPULSE = 120.0
MINE_SPAWN_PERIOD = 4.0

STATION_OBJ = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "debug_out", "assets", "station.obj")

CUSTOM_COMPONENTS = (
    R.ComponentSpec("orbit_angle", (), "float32"),
    R.ComponentSpec("orbit_radius", (), "float32"),
    R.ComponentSpec("orbit_speed", (), "float32"),
    R.ComponentSpec("orbit_center", (3,), "float32"),
    R.ComponentSpec("spawn_timer", (), "float32"),
)


def asteroid_orbit_logic(world, dt, mask, cs):
    """position = center + r (cos a, 0, sin a), a advancing at its speed."""
    a = world["orbit_angle"] + world["orbit_speed"] * dt
    r = world["orbit_radius"]
    pos = world["orbit_center"] + torch.stack(
        [r * torch.cos(a), torch.zeros_like(a), r * torch.sin(a)], dim=-1)
    cs = C.with_update(cs, "orbit_angle", a, mask)
    return C.with_update(cs, "position", pos, mask)


def mine_producer_logic(world, dt, mask, rng, cs):
    """Every MINE_SPAWN_PERIOD seconds, spawn one mine at a random offset
    from the first firing producer. The offset and the velocity are drawn
    from the same key ``rng`` (so they share their bits, as in the JAX
    version), on the key's device; the bits are hashed once."""
    timer = world["spawn_timer"] + torch.where(mask, dt, 0.0)
    fire = mask & (timer >= MINE_SPAWN_PERIOD)
    timer = torch.where(fire, torch.zeros_like(timer), timer)
    cs = C.with_update(cs, "spawn_timer", timer, mask)
    any_fire = fire.any()
    src = fire.to(torch.int8).argmax()
    dev = world.device
    bits = RND.random_bits(rng, (3,))
    offset = RND.bits_to_uniform(bits, minval=-8.0, maxval=8.0)
    vel = RND.bits_to_uniform(bits, minval=-2.0, maxval=2.0)
    budget = cs.spawns.budget
    row = (torch.arange(budget, device=dev) == 0) & any_fire
    return C.queue_spawn(
        cs, world.config.registry, row,
        position=(gather_row(world["position"], src) + offset).expand(
            budget, 3),
        velocity=vel.expand(budget, 3),
        scale=torch.full((budget, 3), 0.4, device=dev),
        type_id=torch.full((budget,), TYPE_MINE, dtype=torch.int32,
                           device=dev),
        model_id=torch.full((budget,), _MINE_MODEL[0], dtype=torch.int32,
                            device=dev),
        flags=torch.full((budget,), R.FLAG_COLLIDABLE, dtype=torch.int32,
                         device=dev))


_MINE_MODEL = [0]  # set at scene build (model ids are bank-assigned)


def user_input_logic(world, camera, inputs, dt, cs):
    """Inertial WASD flight + mouse look: thrust along the camera basis,
    velocity decaying by SHIP_DECAY per frame."""
    camera = camera.rotated(inputs.mouse_delta[0], inputs.mouse_delta[1])
    k = inputs.keys.to(torch.float32)
    fwd = camera.direction()
    up = const((0.0, 1.0, 0.0), device=world.device)
    right = T.cross(fwd, up)
    right = right / torch.linalg.vector_norm(right)
    accel = (fwd * (k[KEY_W] - k[KEY_S]) + right * (k[KEY_D] - k[KEY_A])
             + up * (k[KEY_SPACE] - k[KEY_SHIFT])) * SHIP_ACCEL
    vel = (world["velocity"] + accel[None] * dt) * SHIP_DECAY
    cs = C.with_update(cs, "velocity", vel, world.flag_set(R.FLAG_USER))
    return cs, camera


def user_collision_logic(world, other_idx, mask, cs, other_type=None):
    """Wormhole hit => forward velocity impulse."""
    if other_type is None:
        other_type = world["type_id"][other_idx.clamp(min=0).long()]
    hit_wormhole = mask & (other_type == TYPE_WORMHOLE)
    vel = world["velocity"]
    speed = torch.linalg.vector_norm(vel, dim=-1, keepdim=True)
    fallback = const((0.0, 0.0, -1.0), device=world.device)
    direction = torch.where(speed > 1e-6, vel / speed.clamp(min=1e-6),
                            fallback)
    return C.with_update(cs, "velocity", direction * WORMHOLE_IMPULSE,
                         hit_wormhole)


ENTITY_TYPES = (
    EntityType("star", TYPE_STAR),
    EntityType("asteroid", TYPE_ASTEROID, logic=asteroid_orbit_logic),
    EntityType("wormhole", TYPE_WORMHOLE),
    EntityType("mine_producer", TYPE_MINE_PRODUCER,
               random_logic=mine_producer_logic),
    EntityType("mine", TYPE_MINE),
    EntityType("user", TYPE_USER, user_input=user_input_logic,
               collision=user_collision_logic),
    EntityType("station", TYPE_STATION),
)


def build_scene(engine: Engine, num_asteroids: int = 40, seed: int = 42,
                normal_maps: bool = True, material: dict | None = None):
    """The scene into ``engine``, its asteroids drawn from ``seed``. The
    render systems are the default pair, or with ``material`` (the four
    uniforms of ``user_systems.MATERIAL``) the user's systems of
    ``user_systems``: ``fog_rim`` on the lit one and a draw callback on
    the light sources."""
    bb = engine.bank_builder
    star_mat = bb.add_material(albedo=(1.0, 0.85, 0.5), emissive=1.0)
    rock_mat = bb.add_material(albedo=(0.45, 0.38, 0.33))
    worm_mat = bb.add_material(albedo=(0.4, 0.2, 0.9), alpha=0.45)
    mine_mat = bb.add_material(albedo=(0.7, 0.1, 0.1))
    prod_mat = bb.add_material(albedo=(0.2, 0.7, 0.4), alpha=0.7)

    star_model = bb.add_model("star", primitives.uv_sphere(14.0, 12, 18),
                              material=star_mat)
    rock_full = bb.add_model("asteroid",
                             primitives.asteroid(2.0, 8, 12, seed=seed),
                             material=rock_mat)
    rock_lod = bb.add_model("asteroid_lod", primitives.icosahedron(2.0),
                            material=rock_mat)
    rock_far = bb.add_model("asteroid_far", primitives.tetrahedron(2.0),
                            material=rock_mat)
    bb.set_levels_of_view(rock_full, [rock_full, rock_lod, rock_lod,
                                      rock_far, rock_far, rock_far])
    worm_model = bb.add_model("wormhole", primitives.uv_sphere(6.0, 8, 12),
                              material=worm_mat)
    mine_model = bb.add_model("mine", primitives.cube(1.0), material=mine_mat)
    prod_model = bb.add_model("mine_producer", primitives.cube(4.0),
                              material=prod_mat)
    _MINE_MODEL[0] = mine_model

    from render_engine_tpu_torch.render.textures import TextureAtlasBuilder

    atlas_builder = TextureAtlasBuilder(layer_size=64)
    station_model = bb.add_obj("station", STATION_OBJ,
                               atlas_builder=atlas_builder)
    if not normal_maps:
        for d in bb._mats:
            d["texture_normal"] = -1
    engine.set_atlas(atlas_builder.finalize(engine.device))

    rng = np.random.default_rng(seed)
    base = np.array([1000.0, 1000.0, 1000.0], np.float32)
    star_pos = np.stack([base + [0, 0, -120], base + [180, 30, -260]])
    engine.spawn(
        2, position=star_pos,
        model_id=np.full(2, star_model, np.int32),
        type_id=np.full(2, TYPE_STAR, np.int32),
        ang_vel=np.array([[0.0, 0.15, 0.0], [0.0, -0.1, 0.0]], np.float32),
        sortable=np.full(2, R.SORTABLE_SPOT, np.int32),
        light_diffuse=np.array([[1.0, 0.9, 0.7], [0.9, 0.8, 1.0]],
                               np.float32),
        light_specular=np.full((2, 3), 0.8, np.float32),
        light_ambient=np.full((2, 3), 0.04, np.float32),
        light_atten=np.full((2, 2), [0.004, 0.00005], np.float32),
        light_direction=np.array([[0.0, -0.3, 1.0], [-0.5, 0.0, 1.0]],
                                 np.float32),
        light_cutoff=np.full((2, 2), [np.cos(0.6), np.cos(1.0)], np.float32),
        light_radius=np.full(2, 400.0, np.float32),
        light_fov=np.full(2, 1.2, np.float32),
        flags=np.full(2, R.FLAG_ALWAYS_LOGIC, np.uint32))

    n = num_asteroids
    if n <= 500:
        centers = star_pos[rng.integers(0, 2, n)]
    else:
        dirs = rng.normal(size=(n, 3))
        dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
        shell = rng.uniform(200.0, 1400.0, (n, 1)) ** 1.0
        centers = np.clip((base + dirs * shell).astype(np.float32), 100.0,
                          16284.0)
    radii = rng.uniform(40.0, 160.0, n).astype(np.float32)
    angles = rng.uniform(0, 2 * np.pi, n).astype(np.float32)
    speeds = rng.uniform(0.05, 0.3, n).astype(np.float32) * np.where(
        rng.random(n) < 0.5, 1.0, -1.0).astype(np.float32)
    pos = centers + np.stack(
        [radii * np.cos(angles), rng.uniform(-20, 20, n).astype(np.float32),
         radii * np.sin(angles)], axis=-1)
    centers_y = centers.copy()
    centers_y[:, 1] = pos[:, 1]
    engine.spawn(
        n, position=pos.astype(np.float32),
        model_id=np.full(n, rock_full, np.int32),
        type_id=np.full(n, TYPE_ASTEROID, np.int32),
        scale=rng.uniform(0.5, 2.0, (n, 1)).astype(np.float32).repeat(3, 1),
        ang_vel=rng.uniform(-0.5, 0.5, (n, 3)).astype(np.float32),
        orbit_angle=angles, orbit_radius=radii, orbit_speed=speeds,
        orbit_center=centers_y.astype(np.float32),
        flags=np.full(n, R.FLAG_COLLIDABLE, np.uint32))

    engine.spawn(
        1, position=(base + np.array([60.0, 0.0, -60.0]))[None],
        model_id=np.array([worm_model], np.int32),
        type_id=np.array([TYPE_WORMHOLE], np.int32),
        flags=np.array([R.FLAG_COLLIDABLE | R.FLAG_TRANSPARENT], np.uint32))
    engine.spawn(
        1, position=(base + np.array([-80.0, 10.0, -100.0]))[None],
        model_id=np.array([prod_model], np.int32),
        type_id=np.array([TYPE_MINE_PRODUCER], np.int32),
        flags=np.array([R.FLAG_TRANSPARENT | R.FLAG_ALWAYS_LOGIC],
                       np.uint32),
        spawn_timer=np.zeros(1, np.float32))
    engine.spawn(
        1, position=(base + np.array([-40.0, -15.0, -80.0]))[None],
        model_id=np.array([station_model], np.int32),
        type_id=np.array([TYPE_STATION], np.int32),
        ang_vel=np.array([[0.0, 0.05, 0.0]], np.float32))
    engine.spawn(
        1, position=np.array([[1000.0, 1000.0, 1150.0]], np.float32),
        velocity=np.zeros((1, 3), np.float32),
        type_id=np.array([TYPE_USER], np.int32),
        flags=np.array([R.FLAG_USER | R.FLAG_ALWAYS_LOGIC | R.FLAG_COLLIDABLE
                        | R.FLAG_USER_ALWAYS_COLLIDES], np.uint32))

    engine.set_skybox(SB.make_starfield(2400, device=engine.device))

    if material is not None:
        from render_engine_tpu_torch.demo.user_systems import (
            user_render_systems)

        engine.set_render_systems(lambda bank: user_render_systems(
            bank, star_model, material))
        return
    from render_engine_tpu_torch.prelude.default_render_system import (
        default_render_systems)

    engine.set_render_systems(lambda bank: default_render_systems(
        bank, emissive_models=(star_model,)))


def space_config(*, capacity: int = 256, num_asteroids: int = 40,
                 width: int = 800, height: int = 600, max_tris: int = 32768,
                 is_debugging: bool = False,
                 spawn_budget: int = 4, enable_shadows: bool = True,
                 shadow_resolution: int | None = None,
                 shadow_max_tris: int | None = None,
                 shadow_tile_budget: float = 0.28, normal_maps: bool = True,
                 shadow_update_interval: int | None = None,
                 shadow_pcf_scale: int | None = None,
                 light_tile_budget: int | None = None,
                 shadow_slots: int | None = None,
                 raster_tile_budget: int | None = None,
                 collision_large_budget: int | None = None,
                 shadow_lov_bias: int | None = None,
                 trans_tile_budget: int | None = None) -> EngineConfig:
    """The demo's configuration, with the JAX package's budgets, rendered
    through K3 (``fused_shading=True``, as the JAX demo). Shadows are on;
    their quality follows the target: from 240 px high a 1024^2 map, 8192
    shadow triangles, an update every 3 frames and 2 slots (the scene's
    two spot lights); below that (tests) 128^2, 1024 triangles, every
    frame and 6 slots. Casters take LoV bands 2 coarser.
    ``is_debugging`` is the configuration's inert switch (``EngineConfig``).
    """
    big = height >= 240

    def pick(value, large, small):
        return value if value is not None else (large if big else small)

    return EngineConfig(
        capacity=capacity, world_length=16384.0, section_length=64.0,
        registry=R.ComponentRegistry(custom=CUSTOM_COMPONENTS),
        collision_large_budget=(32 if collision_large_budget is None
                                else collision_large_budget),
        render=RenderSettings(
            width=width, height=height, max_tris=max_tris,
            max_point_lights=8, max_spot_lights=8, fused_shading=True,
            light_tile_budget=light_tile_budget or 0,
            shadow_tile_budget=shadow_tile_budget,
            texture_tile_budget=0.04 if big else 0.5,
            raster=RasterConfig(
                tile_budget=(112 if raster_tile_budget is None
                             else raster_tile_budget),
                trans_tile_budget=trans_tile_budget or 64,
                global_budget=32, pair_budget=3 * max_tris)),
        entity_types=ENTITY_TYPES,
        lov_fractions=(0.10, 0.15, 0.20, 0.25, 0.30),
        spawn_budget=spawn_budget,
        build_scene=lambda e: build_scene(e, num_asteroids=num_asteroids,
                                          normal_maps=normal_maps),
        is_debugging=is_debugging,
        enable_shadows=enable_shadows,
        shadow_resolution=pick(shadow_resolution, 1024, 128),
        shadow_max_tris=pick(shadow_max_tris, 8192, 1024),
        shadow_slots=pick(shadow_slots, 2, 6),
        shadow_update_interval=pick(shadow_update_interval, 3, 1),
        **({} if shadow_pcf_scale is None
           else {"shadow_pcf_scale": shadow_pcf_scale}),
        shadow_lov_bias=2 if shadow_lov_bias is None else shadow_lov_bias)


def space_camera(width: int, height: int):
    """The demo camera: at the ship, looking down -Z, far plane at the
    1500-unit draw distance. Built on the host; the Engine moves it to its
    own device."""
    return (CameraBuilder().with_position(1000.0, 1000.0, 1150.0)
            .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
            .with_aspect(width / height).with_near_far(0.5, 1500.0)
            .with_draw_distance(1500.0).build())


def build_space_engine(*, device="cuda", **kw) -> Engine:
    """The demo engine on ``device`` (the card unless the caller asks for
    the CPU)."""
    cfg = space_config(**kw)
    return Engine(cfg, camera=space_camera(cfg.render.width,
                                           cfg.render.height),
                  device=device)


def build_many_lights_engine(*, device="cuda", n_lights: int = 256,
                             light_tile_budget: int = 96, width: int = 1280,
                             height: int = 720, seed: int = 42) -> Engine:
    """The many-lights configuration: the space scene with 200 asteroids
    drawn from ``seed`` (raster budgets 192 / 128: a 720p frame packs the
    cluster into fewer tiles than 1080p), ``n_lights`` point lights made
    from seed 0 around the scene (radii 40 to 90), a light table of
    ``n_lights`` point and 8 spot rows, per-tile light lists of
    ``light_tile_budget`` entries and the demo's two render systems.
    Frames are not recorded."""
    cfg = space_config(
        width=width, height=height, capacity=1024, num_asteroids=200,
        max_tris=24576, raster_tile_budget=192, trans_tile_budget=128)
    cfg.build_scene = lambda e: build_scene(e, num_asteroids=200, seed=seed)
    eng = Engine(cfg, camera=space_camera(width, height), device=device)
    eng.config.record_history = False
    nl = n_lights
    rng = np.random.default_rng(0)
    pos = (np.array([1000.0, 1000.0, 900.0])
           + rng.uniform(-200, 200, (nl, 3))).astype(np.float32)
    eng.spawn(
        nl, position=pos,
        sortable=np.full(nl, R.SORTABLE_POINT, np.int32),
        light_diffuse=rng.uniform(0.2, 1.0, (nl, 3)).astype(np.float32),
        light_atten=np.full((nl, 2), [0.05, 0.01], np.float32),
        light_radius=rng.uniform(40.0, 90.0, nl).astype(np.float32))
    eng.config.render = dataclasses.replace(
        eng.config.render, max_point_lights=nl, max_spot_lights=8,
        light_tile_budget=light_tile_budget)
    eng.finalize_scene()
    return eng
