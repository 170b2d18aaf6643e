"""Headline benchmark of the PyTorch + CUDA port: the space scene with
10,000 asteroids stepped, culled and deferred-rendered at 1080p with
shadows on one GPU, ``Engine.frame`` once a frame.

    python3 bench_torch.py [--device cuda|cpu] [--compare NAME=VALUE]

Prints ONE JSON line to stdout with the keys of ``bench.py`` (``metric``,
``value`` = frames a second, the median of 3 timed windows, ``unit``,
``vs_baseline`` = value / 60, ``windows_fps``, ``recorded_fps``, ``drops``)
plus ``ms_per_frame``, ``windows_ms``, ``recorded_ms_per_frame``,
``device`` (the card's name) and ``power_limit_w``. Progress goes to
stderr. 3 warm-up frames, then 3 windows of ``BENCH_FRAMES`` frames with
idle inputs (the ship coasts, so every run benches the same content); the
drop counters are the per-counter maximum over the three window boundaries;
then one window with the history recording on, after a fresh baseline.
Each window starts after ``torch.cuda.synchronize()`` and ends after
another behind its last frame.

Environment, as ``bench.py``: BENCH_WIDTH, BENCH_HEIGHT, BENCH_ASTEROIDS,
BENCH_FRAMES (50), BENCH_MAX_TRIS (16384), BENCH_SHADOW_TILES (0.28),
BENCH_NORMAL_MAPS, BENCH_SHADOW_INTERVAL, BENCH_PCF_SCALE,
BENCH_LIGHT_TILE_BUDGET, BENCH_SHADOW_SLOTS, BENCH_TILE_BUDGET,
BENCH_SHADOW_LOV, BENCH_SHADOW_MAX_TRIS.

``--compare NAME=VALUE`` (one ``BENCH_*`` knob) builds a second engine with
that knob changed and times the two in alternating turns a, b, b, a
(``BENCH_TURNS`` rounds of them, 5 by default, 10 frames a turn); the JSON
line then carries ``compare``: per variant the median of its turn medians
and their range. One number from one run is not a result: the host clock
of the same frames drifts between runs.

The script runs on the card and raises where there is none; ``--device
cpu`` is for rehearsals at a small size.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

DT = 1.0 / 60.0
WINDOWS = 3
TURN_FRAMES = 10


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def build_engine(env, device):
    """The benchmark's engine from the ``BENCH_*`` entries of ``env``."""
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    def opt_int(name):
        v = env.get(name)
        return int(v) if v else None

    n_ast = int(env.get("BENCH_ASTEROIDS", 10000))
    extra = ({} if not env.get("BENCH_SHADOW_MAX_TRIS")
             else {"shadow_max_tris": int(env["BENCH_SHADOW_MAX_TRIS"])})
    eng = build_space_engine(
        device=device,
        width=int(env.get("BENCH_WIDTH", 1920)),
        height=int(env.get("BENCH_HEIGHT", 1080)),
        capacity=1 << (n_ast + 64).bit_length(),  # headroom above population
        num_asteroids=n_ast,
        max_tris=int(env.get("BENCH_MAX_TRIS", 16384)),
        shadow_tile_budget=float(env.get("BENCH_SHADOW_TILES", 0.28)),
        normal_maps=env.get("BENCH_NORMAL_MAPS", "1") != "0",
        shadow_update_interval=opt_int("BENCH_SHADOW_INTERVAL"),
        shadow_pcf_scale=opt_int("BENCH_PCF_SCALE"),
        light_tile_budget=opt_int("BENCH_LIGHT_TILE_BUDGET"),
        shadow_slots=opt_int("BENCH_SHADOW_SLOTS"),
        raster_tile_budget=opt_int("BENCH_TILE_BUDGET"),
        shadow_lov_bias=opt_int("BENCH_SHADOW_LOV"), **extra)
    eng.config.record_history = False
    return eng


def _window(eng, frames, fidx):
    """``frames`` rendered frames with idle inputs from seed ``fidx``;
    returns the window's seconds."""
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.runtime.profiling import sync

    sync(eng.device)
    t0 = time.perf_counter()
    for i in range(frames):
        eng.frame(InputState.idle(fidx + i), dt=DT, render=True)
    sync(eng.device)
    return time.perf_counter() - t0


def run(env=None, device="cuda", frames=None, warmup=3):
    """The benchmark's body; returns (the result record, the engine)."""
    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.runtime.profiling import (device_info,
                                                           require_device)

    env = os.environ if env is None else env
    device = require_device(device)
    frames = int(env.get("BENCH_FRAMES", 50)) if frames is None else frames
    _log(f"building engine on {device} ...")
    eng = build_engine(env, device)
    width, height = eng.config.render.width, eng.config.render.height
    for i in range(warmup):
        eng.frame(InputState.idle(i), dt=DT, render=True)

    secs, window_drops = [], []
    fidx = 100
    for _ in range(WINDOWS):
        secs.append(_window(eng, frames, fidx))
        fidx += frames
        _log(f"window {len(secs)}: {frames / secs[-1]:.2f} fps")
        # outside the timed window, at every boundary: one snapshot is one
        # pose; the per-counter maximum over the boundaries is reported
        window_drops.append(eng.drop_stats())
    fps = statistics.median(frames / s for s in secs)

    # the same frames with the history on: one host append a frame more
    eng.config.record_history = True
    eng.history.set_baseline(eng.world, eng.camera, meta={})
    recorded = _window(eng, frames, fidx)
    eng.config.record_history = False
    _log(f"recorded window: {frames / recorded:.2f} fps "
         f"({eng.history.num_frames} frames in the log)")

    alive = int(eng.world.alive.sum())
    result = {
        "metric": (f"FPS at {width}x{height} deferred, space scene "
                   f"({alive} entities stepped+culled)"),
        "value": round(fps, 2),
        "unit": "fps",
        "vs_baseline": round(fps / 60.0, 3),
        "windows_fps": [round(frames / s, 2) for s in secs],
        "recorded_fps": round(frames / recorded, 2),
        "drops": {k: max(d[k] for d in window_drops)
                  for k in window_drops[0]},
        "ms_per_frame": 1e3 / fps,
        "windows_ms": [1e3 * s / frames for s in secs],
        "recorded_ms_per_frame": 1e3 * recorded / frames,
        "frames_per_window": frames,
        **device_info(device),
    }
    return result, eng


def compare(eng_a, name, value, env=None, rounds=5, turn_frames=TURN_FRAMES):
    """``eng_a`` (built from ``env``) against a second engine built with
    ``env[name] = value``, in turns a, b, b, a: per variant the median of
    its turn medians, their range and the turn medians, in ms a frame."""
    from render_engine_tpu_torch.runtime.profiling import turn_medians

    env = dict(os.environ if env is None else env)
    if not name.startswith("BENCH_"):
        raise ValueError(f"--compare takes a BENCH_* knob, not {name!r}")
    eng_b = build_engine({**env, name: value}, eng_a.device)
    engines = {"a": eng_a, "b": eng_b}
    current = []

    def start(which):
        current[:] = [engines[which]]
        current[0].reset()

    med, turns = turn_medians(
        lambda: current[0].frame(None, DT), ("a", "b", "b", "a") * rounds,
        start, frames=turn_frames, device=eng_a.device, log=_log,
        label="compare")
    return {"knob": name, "a": env.get(name), "b": value,
            **{f"{k}_ms_per_frame": med[k] for k in ("a", "b")},
            **{f"{k}_turn_medians_ms": turns[k] for k in ("a", "b")},
            **{f"{k}_range_ms": [min(turns[k]), max(turns[k])]
               for k in ("a", "b")}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no fallback")
    ap.add_argument("--compare", metavar="NAME=VALUE",
                    help="one BENCH_* knob's other value, timed in turns "
                         "against the environment's")
    args = ap.parse_args(argv)
    if args.compare and "=" not in args.compare:
        ap.error("--compare takes NAME=VALUE")
    result, eng = run(device=args.device)
    if args.compare:
        name, value = args.compare.split("=", 1)
        result["compare"] = compare(
            eng, name, value, rounds=int(os.environ.get("BENCH_TURNS", 5)))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
