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
  the frames, the kernel rows by kind (``kernels/<kind>.py``: the
  profiler's name, the port's wrapper and the work of a call) and the
  bound of each kind (the kind's work on the arguments recorded in one
  eager run of each frame program the cell captured, ``bounds.bound``),
  each kind's share of its bound (``roofline_by_kind``) and the hand
  kernels' share (``roofline_pct``: K1, K1 one-pass, K2 and K3 together);
* ``spans``: the program's own spans and counters over ``spans.py``'s span
  phase (``spans.program_spans``; None for a program without tracing),
  run after the CUDA-event parts and before the profiled frames;
* ``device`` (``busy_s``, ``window_s``) and ``breakdown`` for the result.

Every loop's first calls, which capture their programs, run before the
card is settled again and its events are recorded."""

from __future__ import annotations

import importlib
import sys
import time

import torch

from port_bench import bounds, manifest

STEP_CALLS = 60
RENDER_CALLS = 30
SHADOW_UPDATES = 10
PROFILE_FRAMES = 30
TOP = 10

# the kinds ``kernels.hand_roofline`` sums over
HAND_KINDS = ("k1", "k1_one_pass", "k2", "k3")


def kernel_kind(name: str, kinds: dict | None = None):
    """The kind (``kernels/<kind>.py``) whose profiler name a device row's
    ``name`` holds, without its excluded part; None for no kind. A name
    that two kinds claim fails the run."""
    kinds = manifest.kernel_kinds() if kinds is None else kinds
    found = [k for k, m in kinds.items() if m.PROFILER_NAME in name
             and (m.EXCLUDE is None or m.EXCLUDE not in name)]
    if len(found) > 1:
        raise RuntimeError(f"kernel rows {found} all claim {name!r}")
    return found[0] if found else None


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
    """Wraps, for one eager run, each port function a kernel row names
    (``WRAPS``): each call's bound (ms) by kind, from the kinds' ``work``,
    then the call itself. A row whose function the port does not have
    records nothing (its kernel is off the path)."""

    def __init__(self, kinds: dict):
        self.bounds: dict = {}
        self.rows: dict = {}  # (module, function name) -> [(kind, work)]
        for kind, row in kinds.items():
            path, name = row.WRAPS.split(":")
            try:
                mod = importlib.import_module(path)
            except ModuleNotFoundError:
                continue
            if hasattr(mod, name):
                self.rows.setdefault((mod, name), []).append(
                    (kind, row.work))
        self.fns = {key: getattr(*key) for key in self.rows}

    def _wrap(self, key):
        fn, rows = self.fns[key], self.rows[key]

        def wrapped(*a, **kw):
            for kind, work in rows:
                w = work(*a, **kw)
                if w is not None:
                    self.bounds.setdefault(kind, []).append(
                        bounds.bound(w["bytes"], w["ops"])[0])
            return fn(*a, **kw)
        return wrapped

    def __enter__(self):
        for key in self.rows:
            setattr(*key, self._wrap(key))
        return self

    def __exit__(self, *exc):
        for key, fn in self.fns.items():
            setattr(*key, fn)


def kernel_bounds(eng, inputs, dt, kinds: dict | None = None) -> dict:
    """The mean bound (ms) of each kernel kind over one eager run of each
    frame program the engine holds, on a state made from the engine's
    public views (``Engine.world``, ``.camera``, ``.shadow_state``) and
    the frame's inputs ``inputs``, ``dt``."""
    from render_engine_tpu_torch.runtime.engine import ProgramState

    dev = eng.camera.serialize().device
    keys = [k for k in eng.captured_programs if k[0] == "frame"]
    kinds = manifest.kernel_kinds() if kinds is None else kinds
    with _Recorder(kinds) as rec:
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


def _same_kinds(kinds: dict, kernel_bounds_ms: dict):
    """The profiled kinds and those the eager run recorded bounds for have
    to be the same (a renamed kernel or wrapper fails the run rather than
    leave a metric out)."""
    if not kinds or set(kinds) != set(kernel_bounds_ms):
        raise RuntimeError(
            f"kernels profiled {sorted(kinds)} but bounds recorded for "
            f"{sorted(kernel_bounds_ms)}")


def _share(kinds: dict, kernel_bounds_ms: dict) -> float:
    bound_ms = sum(n * kernel_bounds_ms[k] for k, (n, _) in kinds.items())
    time_ms = sum(us for _, us in kinds.values()) / 1e3
    return 100.0 * bound_ms / time_ms


def roofline_pct(kinds: dict, kernel_bounds_ms: dict) -> float | None:
    """The summed bound over the summed device time of the hand kernels'
    profiled launches, K1, K1 one-pass, K2 and K3 (``kinds``: kind ->
    (launches, us), every profiled kind); None where none of them ran."""
    _same_kinds(kinds, kernel_bounds_ms)
    hand = {k: v for k, v in kinds.items() if k in HAND_KINDS}
    return _share(hand, kernel_bounds_ms) if hand else None


def roofline_by_kind(kinds: dict, kernel_bounds_ms: dict) -> dict:
    """Each profiled kind's bound over its device time, in %."""
    _same_kinds(kinds, kernel_bounds_ms)
    return {k: _share({k: v}, kernel_bounds_ms) for k, v in kinds.items()}


def profile(prog, frames: int, kinds: dict | None = None) -> dict:
    """``frames`` traffic frames under the profiler (see the module
    docstring)."""
    from torch.profiler import ProfilerActivity, profile as torch_profile

    dev = prog.device
    kinds = manifest.kernel_kinds() if kinds is None else kinds
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
            kind = kernel_kind(e.name, kinds)
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
    t_spans = time.perf_counter()
    rec["spans"] = span_phase(prog, settle)
    if rec["spans"] is not None:
        settles.append({"settled": rec["spans"]["resettled"]})
    t_spans = time.perf_counter() - t_spans
    settles.append(settle())
    kinds = manifest.kernel_kinds()
    prof = profile(prog, PROFILE_FRAMES, kinds)
    if traffic.renders:
        rec["kernel_bounds"] = kernel_bounds(eng, inputs, fr.dt, kinds)
        if dev.type == "cuda":  # the CPU's profile holds no device rows
            prof["roofline_pct"] = roofline_pct(prof["kernels"],
                                                rec["kernel_bounds"])
            prof["roofline_by_kind"] = roofline_by_kind(
                prof["kernels"], rec["kernel_bounds"])
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
          f"{time.perf_counter() - t0:.3f} s, the span phase "
          f"{t_spans:.3f} s of them", file=sys.stderr)
    return rec


def span_phase(prog, settle):
    """``spans.program_spans`` over ``spans.SPAN_FRAMES`` frames, then
    frames until the programs without marks are captured again. It runs
    before the profiled frames: after them, on an H100, the step span (the
    first of the frame program) read 0.06 to 0.16 ms longer, where the
    render and shadow spans did not move."""
    from port_bench import spans

    phase = spans.program_spans(prog, spans.SPAN_FRAMES, settle)
    if phase is not None:
        spans.quiet(prog, spans.cycle(prog) + 2)
    return phase
