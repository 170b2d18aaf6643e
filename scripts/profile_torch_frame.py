#!/usr/bin/env python3
"""Where the port's frame time goes, on one NVIDIA GPU.

    python3 scripts/profile_torch_frame.py [--frames N] [--out DIR]

Builds the space engine at 1920x1080 with 10,000 asteroids three times:
with the demo's shadow defaults, without shadows, and with shadows and a
fragment-shading function on the lit render system (``chip_smoke.py``'s),
and on each:

* times N frames per turn (host clock, ``torch.cuda.synchronize()`` per
  frame) over 4 rounds of turns (none, shadows, custom, custom, shadows,
  none), so the engines see the same card and host and the spread between
  turns shows;
* times the frame's three parts (step, shadow-map update, render) through
  ``runtime.profiling.StageTimer`` with a synchronize after each: the
  median of each stage's last timings and the timer's EWMA;
* traces 6 frames with ``torch.profiler`` (CPU and CUDA): host API
  launches a frame (graph launches, kernel launches, copies and memsets:
  the Engine replays each frame's captured programs, so a frame is a
  graph launch or two, the input copy and the image clone), device
  kernels a frame, device time a frame (the sum of the device rows'
  times) and the device's busy share: the union of the device rows over
  the window that CUDA events on the frames' stream take around the traced
  frames, both from the same traced run. The sum over the union says
  whether device rows overlapped.

Prints one JSON object per engine, then the shading function's cost as the
custom-shading engine minus the shadowed one, split into device time (from
the traces) and the rest, which is the host's; then the card's name and
power limit. Writes the traces' ``key_averages`` tables under ``--out``.
Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CONFIG = dict(width=1920, height=1080, capacity=16384, num_asteroids=10000,
              max_tris=16384)
DT = 1.0 / 60.0


def _timed_frames(eng, n):
    import torch

    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        eng.frame(None, DT)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return times


# the host API calls that put work on the device
HOST_LAUNCH_APIS = ("cudaGraphLaunch", "cudaLaunchKernel",
                    "cudaLaunchKernelExC", "cuLaunchKernel",
                    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync")


def _parts(eng, n):
    """The step, the shadow update (split into updates that render a map
    and updates the interval skips) and the render through a StageTimer:
    per stage the median of its last timings and its EWMA, in ms."""
    import torch

    from render_engine_tpu_torch.logic.types import InputState
    from render_engine_tpu_torch.runtime.profiling import StageTimer

    timer = StageTimer()
    mark = torch.empty(0, device=eng.device)  # what the stages wait on
    for _ in range(n):
        inputs = InputState.idle(eng.frame_index).with_prev(eng._prev_keys)
        with timer.stage("step", sync=mark):
            eng.step(inputs, DT)
        sh = eng.shadow_state
        if sh is not None:
            renders = sh.tick % eng.config.shadow_update_interval == 0
            with timer.stage("shadow_map_update" if renders
                             else "shadow_skipped_update", sync=mark):
                eng.update_shadows()
        with timer.stage("render", sync=mark):
            eng.render()
        eng.frame_index += 1
    ewma = timer.report()
    return ({k: statistics.median(timer.history(k)) for k in ewma}, ewma,
            timer.hud_line())


def _trace(eng, frames, out_dir, tag):
    import torch
    from torch.profiler import ProfilerActivity, profile

    from render_engine_tpu_torch.runtime.profiling import device_activity

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        eng.frame(None, DT)  # the profiler's own start-up, not traced below
        torch.cuda.synchronize()
    torch.cuda.synchronize()
    first, last = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        first.record()
        for _ in range(frames):
            eng.frame(None, DT)
        last.record()
        torch.cuda.synchronize()
    window_ms = first.elapsed_time(last)
    events = prof.key_averages()
    api = {e.key: e.count / frames for e in events
           if e.key in HOST_LAUNCH_APIS}
    # the device rows (kernels, copies, memsets), not the ops that
    # launched them
    act = device_activity(prof.events())
    with open(os.path.join(out_dir, f"key_averages_{tag}.txt"), "w") as fh:
        fh.write(events.table(sort_by="self_cuda_time_total", row_limit=40))
    return {"traced_frames": frames,
            "traced_window_ms_per_frame": window_ms / frames,
            "launches_per_frame": sum(api.values()),
            "host_api_per_frame": api,
            "device_kernels_per_frame": act["rows"] / frames,
            "device_ms_per_frame": act["sum_ms"] / frames,
            "device_busy_share": act["busy_ms"] / window_ms,
            "device_rows_sum_over_union": act["sum_ms"] / act["busy_ms"]}


def main() -> int:
    import torch

    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--out", default="profile_out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_frame: no CUDA device", file=sys.stderr)
        return 2
    os.makedirs(args.out, exist_ok=True)
    from render_engine_tpu_torch.demo.space_scene import build_space_engine

    from chip_smoke import custom_systems

    engines = {"shadows": build_space_engine(device="cuda", **CONFIG),
               "no_shadows": build_space_engine(device="cuda",
                                                enable_shadows=False,
                                                **CONFIG),
               "custom_shading": build_space_engine(device="cuda", **CONFIG)}
    shaded = engines["custom_shading"]
    shaded.compiled_systems = custom_systems(shaded)[0]
    for eng in engines.values():
        eng.config.record_history = False
        _timed_frames(eng, 6)  # warm-up: the kernel build, caches
    times = {k: [] for k in engines}
    for name in ("no_shadows", "shadows", "custom_shading", "custom_shading",
                 "shadows", "no_shadows") * 4:
        engines[name].reset()
        times[name].append(_timed_frames(engines[name], args.frames))
    results = {}
    for name, eng in engines.items():
        eng.reset()
        _timed_frames(eng, 3)
        turn_medians = [statistics.median(t) for t in times[name]]
        res = {"engine": name, "config": CONFIG,
               "ms_per_frame_turn_medians": turn_medians,
               "ms_per_frame_median_of_turns": statistics.median(
                   turn_medians),
               "ms_per_frame_turn_quartiles": statistics.quantiles(
                   turn_medians, n=4)[::2],
               }
        res["part_ms_median"], res["part_ms_ewma"], hud = _parts(eng, 9)
        print(f"[{name}] {hud}", flush=True)
        res.update(_trace(eng, 6, args.out, name))
        print(json.dumps(res), flush=True)
        results[name] = res
    on, off = results["custom_shading"], results["shadows"]
    total = (on["ms_per_frame_median_of_turns"]
             - off["ms_per_frame_median_of_turns"])
    device = on["device_ms_per_frame"] - off["device_ms_per_frame"]
    print(json.dumps({"shading_function_cost": {
        "ms_per_frame": total, "device_ms_per_frame": device,
        "host_ms_per_frame": total - device,
        "launches_per_frame": (on["launches_per_frame"]
                               - off["launches_per_frame"]),
        "render_part_ms": (on["part_ms_median"]["render"]
                           - off["part_ms_median"]["render"])}}), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
