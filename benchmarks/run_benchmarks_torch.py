"""The five benchmark configurations on the PyTorch + CUDA port.

Usage:
    python benchmarks/run_benchmarks_torch.py [--device cuda|cpu] [config ...]
configs: scene, asteroids, lights, tick, playback (default: all)

The parameters are those of ``benchmarks/run_benchmarks.py``. Each
configuration prints one JSON line with that script's keys plus
``ms_per_frame``, ``device`` (the card's name) and ``power_limit_w``:
  {"config": ..., "metric": ..., "value": N, "unit": ..., ...}

Environment: ``BENCH_SCALE=0.1`` shrinks populations, resolutions and frame
counts; ``BENCH_LIGHT_TILE_BUDGET`` sets the lights configuration's per-tile
light-list budget (default 96, 0 = loop over every light); ``BENCH_OUT``
names a JSON file that gets the run appended (a full run without it appends
to ``benchmarks/results_torch.json``).

The script runs on the card and raises where there is none; ``--device
cpu`` is for rehearsals at a small ``BENCH_SCALE``. Every timed window
starts after ``torch.cuda.synchronize()`` and ends after another one behind
its last frame; nothing else waits inside it. Each function also takes its
frame counts (and ``warmup``) as keyword arguments and returns its record
together with the engine it drove, for callers that check more.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

DT = 1.0 / 60.0


def env_scale() -> float:
    return float(os.environ.get("BENCH_SCALE", "1.0"))


def _scaler(scale):
    scale = env_scale() if scale is None else float(scale)

    def s(x, lo=1):
        return max(lo, int(round(x * scale)))

    return s


def _time_frames(eng, frames, render=True, warmup=3):
    """Frames a second over ``frames`` frames of the thrusting patrol (W
    held), after ``warmup`` frames."""
    from render_engine_tpu_torch.logic.types import KEY_W, InputState
    from render_engine_tpu_torch.runtime.profiling import sync

    for i in range(warmup):
        eng.frame(InputState.idle(i).with_keys(KEY_W), DT, render=render)
    sync(eng.device)
    t0 = time.perf_counter()
    for i in range(frames):
        eng.frame(InputState.idle(100 + i).with_keys(KEY_W), DT,
                  render=render)
    sync(eng.device)
    return frames / (time.perf_counter() - t0)


def _result(eng, config, metric, value, unit, rate, **extra):
    """One configuration's JSON record; ``rate`` (frames or steps a
    second) gives ``ms_per_frame``."""
    from render_engine_tpu_torch.runtime.profiling import device_info

    return {"config": config, "metric": metric, "value": value, "unit": unit,
            **extra, "ms_per_frame": 1e3 / rate, **device_info(eng.device)}


def bench_scene(device="cuda", scale=None, frames=None, warmup=3):
    """Config 1: the sample space scene, deferred at 800x600 offscreen (7
    tile columns, the last one 32 pixels wide)."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    s = _scaler(scale)
    eng = build_space_engine(
        device=device, width=s(800, 128), height=s(600, 96), capacity=256,
        num_asteroids=40, max_tris=32768)
    eng.config.record_history = False
    fps = _time_frames(eng, s(30, 5) if frames is None else frames,
                          warmup=warmup)
    return _result(eng, "scene", "space scene 800x600 deferred",
                   round(fps, 2), "fps", fps), eng


def bench_asteroids(device="cuda", scale=None, frames=None, warmup=3):
    """Config 2: 10k instanced asteroids under a thrusting patrol, culling
    active, one extra directional light. ``collision_large_budget=64``: the
    patrol reaches poses with more large collision movers than the
    default 32 holds."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.ecs import registry as R

    s = _scaler(scale)
    n = s(10000, 100)
    cap = 1 << (n + 64).bit_length()
    eng = build_space_engine(
        device=device, width=s(1920, 256), height=s(1080, 144), capacity=cap,
        num_asteroids=n, max_tris=16384, collision_large_budget=64)
    eng.config.record_history = False
    eng.spawn(
        1, position=np.array([[1000.0, 1400.0, 1000.0]], np.float32),
        sortable=np.array([R.SORTABLE_DIRECTIONAL], np.int32),
        light_direction=np.array([[0.3, -1.0, 0.2]], np.float32),
        light_diffuse=np.full((1, 3), 0.8, np.float32),
        light_ambient=np.full((1, 3), 0.1, np.float32))
    fps = _time_frames(eng, s(20, 5) if frames is None else frames,
                          warmup=warmup)
    return _result(eng, "asteroids", f"{n} asteroids culled+drawn at 1080p",
                   round(fps, 2), "fps", fps, drops=eng.drop_stats()), eng


def bench_lights(device="cuda", scale=None, frames=None, warmup=3):
    """Config 3: 256 point lights and the skybox at 720p; the demo's two
    render systems share the one fused pass; tiles loop over their own
    light lists (``light_tile_overflow`` in the drops must stay 0)."""
    from render_engine_tpu_torch.demo.space_scene import (
        build_many_lights_engine)

    s = _scaler(scale)
    nl = s(256, 8)
    eng = build_many_lights_engine(
        device=device, n_lights=nl, width=s(1280, 256), height=s(720, 144),
        light_tile_budget=int(os.environ.get("BENCH_LIGHT_TILE_BUDGET", 96)))
    n_sys = len(eng.compiled_systems.names)
    fps = _time_frames(eng, s(20, 5) if frames is None else frames,
                          warmup=warmup)
    return _result(eng, "lights",
                   f"{nl} point lights deferred 720p, {n_sys} render "
                   "systems, shared G-buffer", round(fps, 2), "fps", fps,
                   light_tile_budget=eng.config.render.light_tile_budget,
                   drops=eng.drop_stats()), eng


def bench_tick(device="cuda", scale=None, frames=None, burst=None, warmup=3):
    """Config 4: a 100k-entity world tick (spin and orbit logic), step-only
    frame by frame and as one ``run_frames`` burst."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.runtime.profiling import sync

    s = _scaler(scale)
    n = s(100000, 1000)
    cap = 1 << (n + 64).bit_length()
    eng = build_space_engine(
        device=device, width=s(1920, 256), height=s(1080, 144), capacity=cap,
        num_asteroids=n, max_tris=49152)
    eng.config.record_history = False
    steps_per_sec = _time_frames(
        eng, s(30, 5) if frames is None else frames, render=False,
        warmup=warmup)
    alive = int(eng.world.alive.sum())
    step_drops = eng.drop_stats()

    nscan = s(60, 5) if burst is None else burst
    ins = [InputState.idle(1000 + i) for i in range(nscan)]
    dts = [DT] * nscan
    eng.run_frames(ins, dts)  # warm
    sync(eng.device)
    t0 = time.perf_counter()
    eng.run_frames(ins, dts)
    sync(eng.device)
    scan_steps_per_sec = nscan / (time.perf_counter() - t0)
    return _result(
        eng, "tick", f"{alive}-entity world tick (no render)",
        round(steps_per_sec * alive, 0), "entities_stepped_per_sec",
        steps_per_sec, steps_per_sec=round(steps_per_sec, 2),
        scan_steps_per_sec=round(scan_steps_per_sec, 2),
        scan_entities_per_sec=round(scan_steps_per_sec * alive, 0),
        alive=alive, capacity=cap, drops=step_drops), eng


def bench_playback(device="cuda", scale=None, frames=None,
                   recorded_frames=None, warmup=3):
    """Config 5: record N step frames at 128x32, replay them bit for bit
    through ``Player`` (equal world hashes), step past the end, then time
    the recorded 1080p window (rendered frames with the history on)."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine
    from render_engine_tpu_torch.logic.types import (KEY_UP, KEY_W,
                                                     InputState)
    from render_engine_tpu_torch.runtime.profiling import sync
    from render_engine_tpu_torch.runtime.replay import PlaybackMode, Player
    from render_engine_tpu_torch.utils.hashing import world_hash

    s = _scaler(scale)
    n_frames = s(10000, 50) if frames is None else frames
    small = dict(device=device, width=128, height=32, capacity=256,
                 num_asteroids=40, max_tris=8192)
    eng = build_space_engine(**small)
    sync(eng.device)
    t0 = time.perf_counter()
    for i in range(n_frames):
        eng.frame(InputState.idle(i).with_keys(KEY_W), DT, render=False)
    sync(eng.device)
    record_fps = n_frames / (time.perf_counter() - t0)
    live_hash = world_hash(eng.world)

    eng2 = build_space_engine(**small)
    player = Player(eng2, eng.history)
    sync(eng2.device)
    t0 = time.perf_counter()
    while player.cursor < eng.history.num_frames:
        player.step(render=False)
    sync(eng2.device)
    replay_fps = eng.history.num_frames / (time.perf_counter() - t0)
    deterministic = world_hash(eng2.world) == live_hash
    # past the end: the player parks, then Up steps one live frame
    player.step(render=False)
    parked = player.mode == PlaybackMode.ONE_PAST_LAST_FRAME
    parked_hash = world_hash(eng2.world)
    player.step(InputState.idle(0).with_keys(KEY_UP), render=False)
    stepped = (player.mode == PlaybackMode.ONE_PAST_LAST_PAUSE
               and world_hash(eng2.world) != parked_hash)

    # the recorded window at the headline size: rendered frames with the
    # history on cost one host append more than unrecorded ones
    rec = build_space_engine(
        device=device, width=s(1920, 256), height=s(1080, 144),
        capacity=1 << (s(10000, 64) + 64).bit_length(),
        num_asteroids=s(10000, 32), max_tris=16384)
    if not rec.config.record_history:
        raise RuntimeError("the recorded window needs record_history on")
    nrec = s(120, 10) if recorded_frames is None else recorded_frames
    for i in range(warmup):
        rec.frame(InputState.idle(i).with_keys(KEY_W), DT)
    sync(rec.device)
    t0 = time.perf_counter()
    for i in range(nrec):
        rec.frame(InputState.idle(warmup + i).with_keys(KEY_W), DT)
    sync(rec.device)
    recorded_render_fps = nrec / (time.perf_counter() - t0)
    return _result(
        eng, "playback", f"{n_frames}-frame record/replay",
        round(replay_fps, 1), "replay_fps", replay_fps,
        record_fps=round(record_fps, 1),
        recorded_render_1080p_fps=round(recorded_render_fps, 2),
        bit_deterministic=bool(deterministic),
        past_end_parked=bool(parked), past_end_up_stepped=bool(stepped),
        recorded_ms_per_frame=1e3 / recorded_render_fps), rec


ALL = {
    "scene": bench_scene,
    "asteroids": bench_asteroids,
    "lights": bench_lights,
    "tick": bench_tick,
    "playback": bench_playback,
}


def append_results(path, device, results):
    """Append this run (device, scale, time, results) to the JSON list in
    ``path``."""
    from render_engine_tpu_torch.runtime.profiling import device_info

    history = []
    if os.path.exists(path):
        try:
            with open(path) as fh:
                history = json.load(fh)
        except (OSError, json.JSONDecodeError):
            history = []
    history.append({**device_info(device), "scale": env_scale(),
                    "time": time.strftime("%Y-%m-%dT%H:%M:%S"),
                    "results": results})
    with open(path, "w") as fh:
        json.dump(history, fh, indent=1)
    print(f"# appended to {path}", file=sys.stderr, flush=True)


def main(argv=None) -> int:
    from render_engine_tpu_torch.runtime.profiling import require_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("configs", nargs="*", metavar="config",
                    help=f"any of {', '.join(ALL)} (default: all)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    args = ap.parse_args(argv)
    unknown = [c for c in args.configs if c not in ALL]
    if unknown:
        ap.error(f"unknown configuration(s) {unknown}; choose from "
                 f"{list(ALL)}")
    device = require_device(args.device)
    results = []
    for name in args.configs or list(ALL):
        result, _ = ALL[name](device=device)
        print(json.dumps(result), flush=True)
        results.append(result)
    out = os.environ.get("BENCH_OUT")
    if out is None and not args.configs:
        out = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "results_torch.json")
    if out:
        append_results(out, device, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
