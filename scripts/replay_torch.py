"""Replay check of the PyTorch + CUDA port, and the first diverging frame
and component when a replay does not follow the live run.

    python3 scripts/replay_torch.py [--scene space|features] [--frames N]
                                    [--device cuda|cpu]

Records N frames live (a snapshot of the world after each), flushes and
reloads the history, replays it on a second engine and compares every
column of every frame bit for bit. On a difference it prints the frame, the
components and the first differing cells and exits 1; else it prints the
two world hashes and ``REPLAY OK``.

Scenes: ``space`` is the demo scene (128x32, 40 asteroids, W held,
step-only frames); ``features`` is a small scene that drives, in one
recorded run of rendered frames, an emissive texture map, per-tile light
lists (``light_tile_budget`` 8) and multi-contact collision callbacks (the
first 4 contacts of every ball, each changing its velocity, so a change in
pair order would change the hash).
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

N_BALLS = 12
N_LIGHTS = 6
SPACE_KW = dict(width=128, height=32, capacity=128, num_asteroids=40,
                max_tris=2048)


def bounce(world, other_idx, mask, cs, other_type=None):
    """Per-contact callback: every delivered contact keeps 40% of the
    ball's velocity and pushes it away from the other ball."""
    import torch

    from render_engine_tpu_torch.ecs import changes as C

    pos = world["position"]
    away = pos - pos[other_idx.clamp(min=0).long()]
    norm = torch.linalg.vector_norm(away, dim=-1, keepdim=True)
    away = away / norm.clamp(min=1e-6)
    return C.with_update(cs, "velocity", world["velocity"] * 0.4 + away * 2.0,
                         mask)


def build_features_scene(engine):
    from render_engine_tpu_torch.ecs import registry as R
    from render_engine_tpu_torch.models import primitives
    from render_engine_tpu_torch.render.textures import TextureAtlasBuilder

    bb = engine.bank_builder
    ab = TextureAtlasBuilder(layer_size=16)
    etid = ab.add_checkerboard(a=(1.0, 1.0, 1.0), b=(0.2, 0.2, 0.2), cells=2)
    glow_mat = bb.add_material(albedo=(1.0, 0.6, 0.3), emissive=0.9,
                               texture_emissive=etid)
    ball_mat = bb.add_material(albedo=(0.5, 0.6, 0.8))
    glow = bb.add_model("glow", primitives.quad(8.0), material=glow_mat)
    ball = bb.add_model("ball", primitives.icosahedron(1.5),
                        material=ball_mat)
    engine.set_atlas(ab.finalize(engine.device))
    engine.spawn(1, position=np.array([[64.0, 64.0, 50.0]], np.float32),
                 model_id=np.array([glow], np.int32),
                 type_id=np.array([0], np.int32))
    # clustered collidable balls with inward velocities: several overlap
    # every frame, so more than one contact a ball is delivered
    rng = np.random.default_rng(7)
    center = np.array([64.0, 64.0, 60.0])
    pos = (center + rng.uniform(-2.5, 2.5, (N_BALLS, 3))).astype(np.float32)
    vel = (-(pos - center) * 0.8
           + rng.uniform(-0.5, 0.5, (N_BALLS, 3))).astype(np.float32)
    engine.spawn(N_BALLS, position=pos, velocity=vel,
                 model_id=np.full(N_BALLS, ball, np.int32),
                 type_id=np.full(N_BALLS, 1, np.int32),
                 flags=np.full(N_BALLS, R.FLAG_COLLIDABLE, np.uint32))
    # point lights with influence radii: what the tile light lists cull by
    lpos = (np.array([64.0, 64.0, 56.0])
            + rng.uniform(-12, 12, (N_LIGHTS, 3))).astype(np.float32)
    engine.spawn(N_LIGHTS, position=lpos,
                 sortable=np.full(N_LIGHTS, R.SORTABLE_POINT, np.int32),
                 light_diffuse=rng.uniform(0.3, 1.0, (N_LIGHTS, 3))
                 .astype(np.float32),
                 light_atten=np.full((N_LIGHTS, 2), [0.05, 0.01], np.float32),
                 light_radius=rng.uniform(15.0, 30.0, N_LIGHTS)
                 .astype(np.float32))


def make_features_engine(device):
    from render_engine_tpu_torch.logic.types import EntityType
    from render_engine_tpu_torch.math.camera import CameraBuilder
    from render_engine_tpu_torch.render.frame import RenderSettings
    from render_engine_tpu_torch.render.raster_jnp import RasterConfig
    from render_engine_tpu_torch.runtime.config import EngineConfig
    from render_engine_tpu_torch.runtime.engine import Engine

    cfg = EngineConfig(
        capacity=64, world_length=128.0, section_length=8.0,
        entity_types=(EntityType("glow", 0),
                      EntityType("ball", 1, collision=bounce)),
        collision_budget=16, collision_pairs=4,
        render=RenderSettings(
            width=128, height=64, max_tris=2048, fused_shading=True,
            light_tile_budget=8,
            max_point_lights=N_LIGHTS, texture_tile_budget=1.0,
            raster=RasterConfig(tile_budget=32, max_tiles_per_tri=16,
                                global_budget=16)),
        build_scene=build_features_scene)
    cam = (CameraBuilder().with_position(64.0, 64.0, 70.0)
           .with_yaw_pitch_degrees(-90.0, 0.0).with_fov_degrees(70.0)
           .with_aspect(2.0).with_near_far(0.1, 100.0)
           .with_draw_distance(100.0).build())
    eng = Engine(cfg, camera=cam, device=device)
    if not eng.bank.has_emissive_maps():
        raise RuntimeError("the features scene must carry an emissive map")
    return eng


def snap(world):
    from render_engine_tpu_torch.ecs.world import snapshot

    s = snapshot(world)
    return {**s["comps"], "alive": s["alive"], "comp_mask": s["comp_mask"]}


def first_divergence(live, replayed):
    """(frame, [(component, cells differing, first cells)]) of the first
    frame whose snapshots differ, or None."""
    for f, (a, b) in enumerate(zip(live, replayed)):
        bad = [k for k in a if not np.array_equal(a[k], b[k],
                                                  equal_nan=True)]
        if bad:
            report = []
            for k in bad:
                idx = np.argwhere(a[k] != b[k])
                report.append((k, len(idx), [
                    (j.tolist(), a[k][tuple(j)].item(), b[k][tuple(j)].item())
                    for j in idx[:3]]))
            return f, report
    return None


def run(scene="space", frames=None, device="cuda", log=print):
    """Record, replay and compare; returns the first divergence or None."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import KEY_W, InputState
    from render_engine_tpu_torch.runtime.history import HistoryLog
    from render_engine_tpu_torch.runtime.profiling import (require_device,
                                                           sync)
    from render_engine_tpu_torch.runtime.replay import Player
    from render_engine_tpu_torch.utils.hashing import world_hash

    device = require_device(device)
    if scene == "space":
        def make():
            return build_space_engine(device=device, **SPACE_KW)
        render, n = False, 4 if frames is None else frames
        inputs = [InputState.idle(i).with_keys(KEY_W) for i in range(n)]
    elif scene == "features":
        def make():
            return make_features_engine(device)
        render, n = True, 30 if frames is None else frames
        inputs = [InputState.idle(i) for i in range(n)]
    else:
        raise ValueError(f"unknown scene {scene!r}")

    t0 = time.time()
    eng = make()
    log(f"{scene} engine built in {time.time() - t0:.1f}s on {device}")
    t0 = time.time()
    live = []
    for inp in inputs:
        eng.frame(inp, dt=1 / 60, render=render)
        live.append(snap(eng.world))
    sync(device)
    log(f"{n} recorded frames: {(time.time() - t0) / n * 1e3:.0f} ms/frame "
        "(a snapshot read back after each)")
    log("drops:", {k: v for k, v in eng.drop_stats().items() if v})
    h_live = world_hash(eng.world)
    with tempfile.TemporaryDirectory() as d:
        eng.config.history_dir = d
        eng.flush_history()
        hist = HistoryLog.load(d)
    log(f"history flushed and loaded ({hist.num_frames} frames)")

    eng2 = make()
    player = Player(eng2, hist)
    replayed = []
    for _ in range(n):
        player.step(render=False)
        replayed.append(snap(eng2.world))
    found = first_divergence(live, replayed)
    if found is not None:
        f, report = found
        log(f"frame {f} diverges in: {[k for k, _, _ in report]}")
        for k, count, cells in report[:3]:
            log(f"  {k}: {count} cells differ; first:")
            for j, a, b in cells:
                log(f"    {j}: live={a!r} replay={b!r}")
        return found
    log("live   hash:", h_live[:16])
    log("replay hash:", world_hash(eng2.world)[:16])
    log(f"REPLAY OK: no divergence over {n} frames ({scene})")
    return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="space", choices=("space", "features"))
    ap.add_argument("--frames", type=int, default=None,
                    help="frames to record (space: 4, features: 30)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    return 0 if run(args.scene, args.frames, args.device) is None else 1


if __name__ == "__main__":
    sys.exit(main())
