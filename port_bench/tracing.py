"""The traced run's measurements, taken after the window from the
benchmark's own files: host clocks, CUDA events around the engine's public
calls, and one stretch of frames under ``torch.profiler``.

``measure`` returns the record the per-layer readers (``metrics/``) read:

* ``dispatch_s``: the window's per-frame host seconds from the call of
  ``Engine.frame`` to its return (unprofiled frames);
* ``capture_seconds``: ``Engine.capture_seconds()`` of the programs set-up
  captured;
* ``step_ms``: CUDA events around ``STEP_CALLS`` consecutive
  ``Engine.step`` calls, over their number;
* ``render_ms``: the same around ``RENDER_CALLS`` ``Engine.render()``
  calls (the cell's route, the maps left alone), where the cell renders;
* ``shadow_update_ms``: around ``interval x SHADOW_UPDATES`` calls of
  ``Engine.update_shadows()``, whose host schedule updates a map on
  ``SHADOW_UPDATES`` of them, over ``SHADOW_UPDATES``;
* ``profile``: ``PROFILE_FRAMES`` frames of the traffic, each followed by a
  synchronize as in the window, under the profiler: the device rows
  (kernels, copies, memsets), their union, the span by CUDA events around
  the frames, the hand kernels' rows by kind and the bound of each kind
  (``bounds.py`` on the arguments recorded in one eager run of each frame
  program the cell captured);
* ``device`` (``busy_s``, ``window_s``) and ``breakdown`` for the result.

Every loop's first calls, which capture their programs, run before the
card is settled again and its events are recorded."""

from __future__ import annotations

import sys
import time

import torch

from port_bench import bounds

STEP_CALLS = 60
RENDER_CALLS = 30
SHADOW_UPDATES = 10
PROFILE_FRAMES = 30
TOP = 10

# the hand kernels by the profiler's names: (kind, part of the name,
# part it must not hold)
KERNEL_ROWS = (("k1_one_pass", "tile_raster_kernel<false>", None),
               ("k1", "tile_raster_kernel", "<false>"),
               ("k2", "resolve_kernel", None),
               ("k3", "fused_shade_kernel", None))


def kernel_kind(name: str):
    for kind, part, never in KERNEL_ROWS:
        if part in name and (never is None or never not in name):
            return kind
    return None


def device_activity(rows) -> dict:
    """A copy of ``runtime/profiling.py``'s ``device_activity`` arithmetic
    on ``(start_us, end_us)`` rows: how many, their summed time, their
    union (the time the device ran at least one) and the gaps between
    the union's intervals, times in us."""
    rows = sorted(rows)
    busy, total, lo, hi, gaps = 0.0, 0.0, None, None, []
    for start, end in rows:
        total += end - start
        if hi is None or start > hi:
            if hi is not None:
                busy += hi - lo
                gaps.append((hi, start))
            lo, hi = start, end
        else:
            hi = max(hi, end)
    if hi is not None:
        busy += hi - lo
    return {"rows": len(rows), "sum_us": total, "busy_us": busy,
            "gaps": gaps}


class _HostEvent:
    """The host clock in place of a CUDA event on the CPU (rehearsals)."""

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other) -> float:
        return (other.t - self.t) * 1e3


def _events(device):
    if device.type == "cuda":
        return (torch.cuda.Event(enable_timing=True) for _ in range(2))
    return (_HostEvent() for _ in range(2))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(device, calls: int, fn) -> float:
    """ms of ``calls`` calls of ``fn`` by CUDA events on ``device``'s
    current stream."""
    a, b = _events(device)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    _sync(device)
    return a.elapsed_time(b)


class _Recorder:
    """Wraps the port's three kernel wrappers for one eager run: each call's
    bound (ms) by kind, from ``bounds.py``, then the call itself."""

    def __init__(self):
        from render_engine_tpu_torch.render import raster_pallas as RP
        from render_engine_tpu_torch.render import shade_pallas as SP

        self.bounds: dict = {}
        self.saved = [(RP, "tile_raster"), (RP, "resolve_attributes_pallas"),
                      (SP, "shade_tiles")]
        self.fns = {name: getattr(mod, name) for mod, name in self.saved}

    def _add(self, kind, work):
        self.bounds.setdefault(kind, []).append(
            bounds.bound(work["bytes"], work["ops"])[0])

    def __enter__(self):
        fns = self.fns

        def tile_raster(data, ids, counts, **kw):
            self._add("k1" if kw["two_pass"] else "k1_one_pass",
                      bounds.tile_raster_work(data, ids, counts, **kw))
            return fns["tile_raster"](data, ids, counts, **kw)

        def resolve(slot, rows, *a, **kw):
            self._add("k2", bounds.resolve_work(slot, rows))
            return fns["resolve_attributes_pallas"](slot, rows, *a, **kw)

        def shade_tiles(*a, **kw):
            self._add("k3", bounds.fused_shade_work(*a, **kw))
            return fns["shade_tiles"](*a, **kw)

        wrap = {"tile_raster": tile_raster,
                "resolve_attributes_pallas": resolve,
                "shade_tiles": shade_tiles}
        for mod, name in self.saved:
            setattr(mod, name, wrap[name])
        return self

    def __exit__(self, *exc):
        for mod, name in self.saved:
            setattr(mod, name, self.fns[name])


def kernel_bounds(eng, inputs, dt) -> dict:
    """The mean bound (ms) of each hand-kernel kind over one eager run of
    each frame program the engine holds, on a state made from the engine's
    public views (``Engine.world``, ``.camera``, ``.shadow_state``) and
    the frame's inputs ``inputs``, ``dt``."""
    from render_engine_tpu_torch.runtime.engine import ProgramState

    dev = eng.camera.serialize().device
    keys = [k for k in eng.captured_programs if k[0] == "frame"]
    with _Recorder() as rec:
        for key in keys:
            sh = eng.shadow_state
            camv = eng.camera.serialize().clone()
            st = ProgramState(
                world=eng.world, camv=camv,
                shadow=(None if sh is None else
                        (sh.maps, sh.light_mats, sh.slot_entity,
                         sh.slot_face)),
                packed=torch.as_tensor(inputs.pack_with_dt(dt), device=dev),
                view=camv.clone(),
                drops=torch.zeros(6, dtype=torch.int32, device=dev),
                image=torch.empty(eng.config.render.height,
                                  eng.config.render.width, 3, device=dev))
            eng.program_function(key)(st)
    return {k: sum(v) / len(v) for k, v in rec.bounds.items()}


def roofline_pct(kinds: dict, kernel_bounds_ms: dict) -> float:
    """The summed bound over the summed device time of the hand kernels'
    profiled launches (``kinds``: kind -> (launches, us)). The profiled
    kinds and those the eager run recorded bounds for have to be the same
    (a renamed kernel or wrapper fails the run rather than leave the
    metric out)."""
    if not kinds or set(kinds) != set(kernel_bounds_ms):
        raise RuntimeError(
            f"hand kernels profiled {sorted(kinds)} but bounds recorded for "
            f"{sorted(kernel_bounds_ms)}")
    bound_ms = sum(n * kernel_bounds_ms[k] for k, (n, _) in kinds.items())
    time_ms = sum(us for _, us in kinds.values()) / 1e3
    return 100.0 * bound_ms / time_ms


def profile(prog, frames: int) -> dict:
    """``frames`` traffic frames under the profiler (see the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    dev = prog.device
    acts = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with torch_profile(activities=acts):  # the profiler's own start-up
        prog.frame()
        _sync(dev)
    first, last = _events(dev)
    with torch_profile(activities=acts) as prof:
        first.record()
        for _ in range(frames):
            prog.frame()
            _sync(dev)
        last.record()
        _sync(dev)
    span_ms = first.elapsed_time(last)
    dev_rows, host_rows, by_name, kern = [], [], {}, {}
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.events():
        t = (e.time_range.start, e.time_range.end)
        if e.device_type == cuda:
            dev_rows.append(t)
            us = t[1] - t[0]
            by_name[e.name] = by_name.get(e.name, 0.0) + us
            kind = kernel_kind(e.name)
            if kind is not None:
                n, s = kern.get(kind, (0, 0.0))
                kern[kind] = (n + 1, s + us)
        else:
            host_rows.append((t[0], t[1], e.name))
    act = device_activity(dev_rows)
    return {"frames": frames, "span_ms": span_ms, "rows": act["rows"],
            "sum_us": act["sum_us"], "busy_us": act["busy_us"],
            "kernels": kern,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP],
            "idle_gaps": name_gaps(act["gaps"], host_rows)}


def name_gaps(gaps, host_rows) -> list:
    """The ``TOP`` longest gaps between device work, each named by the
    innermost (shortest) host operation running at the gap's middle, or
    ``"host, outside any profiled operation"``."""
    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:TOP]
    out = []
    for lo, hi in longest:
        mid = (lo + hi) / 2
        inner = [(e - s, name) for s, e, name in host_rows if s <= mid <= e]
        name = (min(inner)[1] if inner
                else "host, outside any profiled operation")
        out.append((name, hi - lo))
    return out


def measure(prog, disp: list, device, settle=None) -> dict:
    """The record (see the module docstring). ``settle`` (the card's
    settling, ``bench.settle_card`` back to the set-up's level) runs
    before each timed part: the card can fall back to its slow start
    after the window. Where it does not come back, the parts are timed
    all the same and ``device.resettled`` says so."""
    eng, traffic = prog.eng, prog.traffic
    dev = torch.device(device)
    settle = settle or (lambda: {"settled": None})
    settles = []
    rec = {"dispatch_s": list(disp), "capture_seconds":
           dict(eng.capture_seconds())}
    t0 = time.perf_counter()

    from render_engine_tpu_torch.logic.types import InputState

    fr = traffic.frame(prog.i)
    inputs = InputState(keys=fr.keys, mouse_delta=fr.mouse_delta,
                        rng_seed=fr.rng_seed).with_prev(
                            traffic.prev_keys(prog.i))
    for _ in range(2):
        eng.step(inputs, fr.dt)
    rec["render_ms"] = rec["shadow_update_ms"] = None
    shadows = traffic.renders and eng.shadow_state is not None
    if traffic.renders:
        for _ in range(2):
            eng.render()
    if shadows:
        interval = eng.config.shadow_update_interval
        for _ in range(2 * interval * eng.config.shadow_slots):
            eng.update_shadows()
    settles.append(settle())
    rec["step_ms"] = _timed(dev, STEP_CALLS,
                            lambda: eng.step(inputs, fr.dt)) / STEP_CALLS
    if traffic.renders:
        rec["render_ms"] = _timed(dev, RENDER_CALLS,
                                  eng.render) / RENDER_CALLS
    if shadows:
        rec["shadow_update_ms"] = _timed(
            dev, interval * SHADOW_UPDATES,
            eng.update_shadows) / SHADOW_UPDATES
    settles.append(settle())
    prof = profile(prog, PROFILE_FRAMES)
    if traffic.renders:
        rec["kernel_bounds"] = kernel_bounds(eng, inputs, fr.dt)
        if dev.type == "cuda":  # the CPU's profile holds no device rows
            prof["roofline_pct"] = roofline_pct(prof["kernels"],
                                                rec["kernel_bounds"])
    rec["profile"] = prof
    rec["device"] = {"busy_s": prof["busy_us"] / 1e6,
                     "window_s": prof["span_ms"] / 1e3,
                     # whether the card came back to its settled level
                     # before each timed part
                     "resettled": [st["settled"] for st in settles]}
    rec["breakdown"] = {
        "device_ops": [[n, us / 1e6] for n, us in prof["device_ops"]],
        "idle_gaps": [[n, us / 1e6] for n, us in prof["idle_gaps"]]}
    print(f"[port_bench] trace measurements took "
          f"{time.perf_counter() - t0:.3f} s", file=sys.stderr)
    return rec
