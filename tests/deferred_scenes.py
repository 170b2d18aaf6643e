"""Scenes for the default route's shading stage (render/deferred_shade.py),
built in either package from the same numpy data: ``pk`` is the tuple
(primitives, ModelBankBuilder, world, registry, kinematics, CameraBuilder,
textures) of the port or of the JAX package (tests/test_torch_frame.py's
TORCH_PK and JAX_PK; ``torch_packages()`` gives the port's without
importing the tests that import JAX). ``device`` places the port's scene;
None keeps each package's default.

* ``featured``: the frame scene with every texture role (a checker albedo,
  spec, emissive and tilted normal maps on the cubes, a dissolve map on the
  glass pane) and two shininess values, so the G-buffers carry a per-pixel
  shininess plane; one point light.
* ``lit``: textured cubes (albedo, spec and normal maps), a wall with
  another shininess, the emissive star and a glass pane, lit by a
  directional light (entity 0), a spot light (1), the star's point light
  (2) and ``extra_points`` point lights more with radii (some reach the
  pixels, some do not). The shadow schedule maps the lights in entity
  order: with ``LIT_SLOTS`` slots and as many updates, the directional
  light's map, the spot light's and four cube faces of the star's.
"""

import numpy as np

LIT_SLOTS = 6


def torch_packages():
    from render_engine_tpu_torch.ecs import registry as R
    from render_engine_tpu_torch.ecs import world as W
    from render_engine_tpu_torch.logic import kinematics as K
    from render_engine_tpu_torch.math.camera import CameraBuilder as CB
    from render_engine_tpu_torch.models import primitives as P
    from render_engine_tpu_torch.models.bank import ModelBankBuilder as MB
    from render_engine_tpu_torch.render import textures as TX
    return P, MB, W, R, K, CB, TX


def _on(device):
    return {} if device is None else {"device": device}


def _world(pk, bank, device, **cols):
    P, MB, W, R, K, CB, TX = pk
    w = W.create_world(W.WorldConfig(capacity=16, world_length=128.0,
                                     section_length=16.0), **_on(device))
    w, _ = W.spawn_host(w, len(cols["position"]), **cols)
    return K.refresh_transforms(w, bank.aabb_min, bank.aabb_max, w.alive)


def _camera(pk, aspect, device):
    P, MB, W, R, K, CB, TX = pk
    cam = (CB().with_position(64.0, 64.0, 64.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(60.0)
           .with_aspect(aspect).with_near_far(0.1, 100.0)
           .with_draw_distance(100.0).build())
    return cam if device is None else cam.to(device)


def featured(pk, aspect=4.0, device=None):
    """``(world, bank, camera, atlas)``: see the module docstring."""
    P, MB, W, R, K, CB, TX = pk
    rng = np.random.default_rng(3)
    ab = TX.TextureAtlasBuilder(layer_size=32)
    albedo = ab.add_checkerboard(a=(1.0, 0.8, 0.2), b=(0.1, 0.2, 0.9),
                                 cells=4)
    spec = ab.add_image(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    emis = ab.add_image(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    tilt = ab.add_image(np.broadcast_to(np.float32([0.75, 0.45, 0.9]),
                                        (16, 16, 3)).copy())
    diss = ab.add_image(rng.uniform(0.2, 1, (8, 8, 3)).astype(np.float32))
    atlas = ab.finalize(**_on(device))
    bb = MB()
    red = bb.add_material(albedo=(1.0, 0.1, 0.1), texture=albedo,
                          specular=1.5, texture_specular=spec,
                          texture_normal=tilt, shininess=16.0)
    glow = bb.add_material(albedo=(1.0, 0.9, 0.6), emissive=4.0,
                           texture_emissive=emis)
    glass = bb.add_material(albedo=(0.2, 0.9, 0.4), alpha=0.4,
                            texture_dissolve=diss, shininess=128.0)
    cube = bb.add_model("cube", P.cube(1.5), material=red)
    star = bb.add_model("star", P.uv_sphere(0.7, 6, 8), material=glow)
    pane = bb.add_model("pane", P.quad(2.0), material=glass)
    bank = bb.finalize(**_on(device))
    w = _world(
        pk, bank, device,
        position=np.array([[62.0, 64.0, 58.0], [66.0, 64.0, 58.0],
                           [64.0, 65.5, 57.0], [64.0, 64.0, 60.5]],
                          np.float32),
        model_id=np.array([cube, star, cube, pane], np.int32),
        sortable=np.array([0, R.SORTABLE_POINT, 0, 0], np.int32),
        light_diffuse=np.array([[0, 0, 0], [1.0, 0.9, 0.8], [0, 0, 0],
                                [0, 0, 0]], np.float32),
        light_atten=np.array([[0, 0], [0.05, 0.01], [0, 0], [0, 0]],
                             np.float32))
    return w, bank, _camera(pk, aspect, device), atlas


def lit(pk, aspect, extra_points=0, device=None):
    """``(world, bank, camera, atlas)``: see the module docstring."""
    P, MB, W, R, K, CB, TX = pk
    rng = np.random.default_rng(7)
    ab = TX.TextureAtlasBuilder(layer_size=32)
    albedo = ab.add_checkerboard(a=(0.9, 0.7, 0.3), b=(0.2, 0.3, 0.8),
                                 cells=4)
    spec = ab.add_image(rng.uniform(0, 1, (16, 16, 3)).astype(np.float32))
    bumps = ab.add_image(rng.uniform(0.3, 0.7, (16, 16, 3)).astype(
        np.float32) + np.float32([0.0, 0.0, 0.3]))
    atlas = ab.finalize(**_on(device))
    bb = MB()
    cube_m = bb.add_material(albedo=(1.0, 0.2, 0.2), texture=albedo,
                             specular=1.2, texture_specular=spec,
                             texture_normal=bumps, shininess=24.0)
    gray = bb.add_material(albedo=(0.7, 0.7, 0.7), shininess=48.0)
    glow = bb.add_material(albedo=(1.0, 0.9, 0.6), emissive=4.0)
    glass = bb.add_material(albedo=(0.2, 0.9, 0.4), alpha=0.4)
    cube = bb.add_model("cube", P.cube(1.5), material=cube_m)
    wall = bb.add_model("wall", P.quad(12.0), material=gray)
    star = bb.add_model("star", P.uv_sphere(0.7, 6, 8), material=glow)
    pane = bb.add_model("pane", P.quad(2.0), material=glass)
    bank = bb.finalize(**_on(device))
    z3 = [0.0, 0.0, 0.0]
    sun = np.array([0.3, -1.0, -0.6], np.float32)
    spot = np.array([0.0, -0.5, -1.0], np.float32)
    rows = [  # position, model, kind, direction, diffuse, atten, radius
        ([64.0, 66.0, 64.0], -1, R.SORTABLE_DIRECTIONAL,
         sun / np.linalg.norm(sun), [0.5, 0.5, 0.55], [0, 0], 0.0),
        ([64.0, 66.0, 63.0], -1, R.SORTABLE_SPOT,
         spot / np.linalg.norm(spot), [0.9, 0.9, 0.9], [0.02, 0.002], 0.0),
        ([64.0, 65.5, 57.0], star, R.SORTABLE_POINT, z3, [1.0, 0.9, 0.8],
         [0.05, 0.01], 0.0),
        ([62.0, 64.0, 58.0], cube, 0, z3, z3, [0, 0], 0.0),
        ([66.0, 64.0, 58.0], cube, 0, z3, z3, [0, 0], 0.0),
        ([64.0, 64.0, 60.5], pane, 0, z3, z3, [0, 0], 0.0),
        ([64.0, 64.0, 55.0], wall, 0, z3, z3, [0, 0], 0.0),
    ]
    for i in range(extra_points):
        a = 2.0 * np.pi * i / max(extra_points, 1)
        rows.append(([64.0 + 4.0 * np.cos(a), 64.0 + 2.0 * np.sin(a),
                      59.0 - 0.5 * i], -1, R.SORTABLE_POINT, z3,
                     list(rng.uniform(0.2, 0.8, 3)), [0.1, 0.02],
                     (3.0, 0.0, 6.0)[i % 3]))
    col = list(zip(*rows))
    w = _world(
        pk, bank, device,
        position=np.array(col[0], np.float32),
        model_id=np.array(col[1], np.int32),
        sortable=np.array(col[2], np.int32),
        light_direction=np.array(col[3], np.float32),
        light_diffuse=np.array(col[4], np.float32),
        light_specular=np.array([[0.6, 0.6, 0.6]] * len(rows), np.float32),
        light_ambient=np.array([[0.02, 0.02, 0.03]] * len(rows),
                               np.float32),
        light_atten=np.array(col[5], np.float32),
        light_radius=np.array(col[6], np.float32),
        light_cutoff=np.array([[0.95, 0.8] if r[2] == R.SORTABLE_SPOT
                               else [0.0, 0.0] for r in rows], np.float32),
        light_fov=np.array([1.2 if r[2] == R.SORTABLE_SPOT else 0.0
                            for r in rows], np.float32))
    return w, bank, _camera(pk, aspect, device), atlas
