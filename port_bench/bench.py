"""One run of a cell: build the program's engine, warm up, run the window,
read the metrics, check the output, print the result.

The window drives ``Engine.frame(inputs, dt)`` as a closed loop, each frame
followed by ``torch.cuda.synchronize()``, which is what an application that
presents every image waits for. Set-up (imports, the kernel library, the
scene, warm-up and every capture, then the card's settling, which
``setup_s`` leaves out) ends where the window starts; the window holds no
capture (``Engine.captured_programs`` is the same after it as before it,
or the run fails)."""

from __future__ import annotations

import gc
import json
import math
import statistics
import sys
import time

import numpy as np
import torch

from port_bench import check, manifest
from port_bench.traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "render_engine_tpu")
START_FRAMES = 3  # frames checked from the initial state
# frames of the run from the start whose state after them is checked (the
# first mine spawns at frame 240), and those whose image is too
FOLLOW_AT = (60, 120, 180, 239, 240, 241, check.FOLLOW - 1)
FOLLOW_IMAGES = (240, check.FOLLOW - 1)
SAMPLES = 2  # runs of 3 consecutive window frames checked
MAX_WARMUP = 240
# the card's settling (``settle_card``)
PROBE_KERNELS = 256
SETTLE_BLOCK_S = 0.25
SETTLE_AGREE = 0.01  # the last blocks' spread over their median
SETTLE_BLOCKS = 4  # blocks that have to agree
SETTLE_BACK = 0.04  # how near the set-up's level a re-settled card reads
# the probe graph's time a replay on a settled H100 SXM is 0.254 to 0.263
# ms, on one in its slow start 0.300 to 0.308 (over 80 processes on five
# machines): a steady card reads below this only when settled
SETTLED_BELOW_MS = 0.28
SETTLE_MAX_S = 120.0
# the traced run's settling again before each of its three timed parts,
# which may fail: a card has been seen to run slow for up to 37 s of load
RESETTLE_MAX_S = 60.0


def log(msg: str):
    print(f"[port_bench] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``render_engine_tpu_torch`` is neither)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def p95(values: list[float]) -> float:
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def sample_frames(seed: int, est_frames: int) -> list[int]:
    """The window frames checked: ``SAMPLES`` runs of 3 consecutive frames
    at positions drawn from the seed in the first 80% of the frames the
    window is expected to hold (3 consecutive frames hold one shadow-map
    frame at the demo's interval of 3)."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 0x9B])
    out = set()
    for u in rng.uniform(0.05, 0.8, SAMPLES):
        k = int(u * max(est_frames - 3, 0))
        out.update((k, k + 1, k + 2))
    return sorted(out)


class Program:
    """The program's engine of a cell (``programs/<program>.py``'s
    ``build``), its inputs, and how its states are read for the check
    (``state_of``: the reference file's, or ``reference/frames.py``'s)."""

    def __init__(self, cfg, traffic: Traffic, seed, device, overrides=None):
        from render_engine_tpu_torch.logic.types import InputState

        self._inputs = InputState
        self.traffic, self.device = traffic, torch.device(device)
        self.eng = manifest.program(cfg).build(cfg, seed, device, overrides)
        self.state_of = manifest.state_of(cfg)
        self.i = 0  # the next traffic frame
        self._ready: dict = {}

    def state(self) -> dict:
        return self.state_of(self.eng)

    def _args(self, i: int):
        fr = self.traffic.frame(i)
        return (self._inputs(keys=fr.keys, mouse_delta=fr.mouse_delta,
                             rng_seed=fr.rng_seed), fr.dt, fr.render)

    def prepare(self, n: int):
        """Make the inputs of the next ``n`` frames ahead of time (set-up),
        so that the window spends no time generating them."""
        self._ready = {i: self._args(i) for i in range(self.i, self.i + n)}

    def frame(self):
        """The next traffic frame through ``Engine.frame``; returns the
        image (None without render)."""
        args = self._ready.pop(self.i, None) or self._args(self.i)
        self.i += 1
        inputs, dt, render = args
        return self.eng.frame(inputs, dt, render=render)


def warm_up(prog: Program, quiet_frames: int):
    """Frames until ``quiet_frames`` frames in a row captured nothing new; the
    first ``START_FRAMES`` are kept for the check. Returns the checked
    start frames and the mean seconds of the settled frames."""
    eng, start, quiet, times = prog.eng, [], 0, []
    while quiet < quiet_frames or prog.i < START_FRAMES:
        if prog.i >= MAX_WARMUP:
            raise RuntimeError(f"a program was still being captured after "
                               f"{MAX_WARMUP} warm-up frames")
        before = eng.captured_programs
        t0 = time.perf_counter()
        img = prog.frame()
        sync(prog.device)
        dt = time.perf_counter() - t0
        if prog.i <= START_FRAMES:
            start.append(check.Checked(prog.i - 1, None, prog.state(), img))
        if eng.captured_programs == before:
            quiet += 1
            times.append(dt)
        else:
            quiet, times = 0, []
    return start, statistics.mean(times[-quiet_frames:])


def settle_card(device, level: float | None = None,
                max_s: float = SETTLE_MAX_S) -> dict:
    """Bring the card to its steady state before the window.

    An H100 can start a process slow: a graph of small kernels runs 15 to
    20% longer until, after 1 to 15 s of load, the card settles for good
    (``nvidia-smi`` shows the same clocks in both states). A user's frame
    loop runs in the settled state after its first seconds. So set-up
    replays the harness's own graph of ``PROBE_KERNELS`` one-element
    kernels back to back in blocks of ``SETTLE_BLOCK_S`` and reads each
    block's time a replay by CUDA events. The card has settled when the
    last ``SETTLE_BLOCKS`` blocks agree within ``SETTLE_AGREE`` of their
    median and that median is below ``SETTLED_BELOW_MS`` (a slow start
    can hold steady for longer than a run, so steadiness alone cannot
    tell the two states apart). With ``level``, this run's settled
    reading from before the window, the card has settled again once the
    blocks agree within ``SETTLE_BACK`` above it.
    The program's state is not touched, so the window's
    inputs stay those of the seed; the seconds are the card's, and
    ``setup_s`` leaves them out. A card that has not settled within
    ``max_s`` fails the run (``must_settle``)."""
    x = torch.zeros(1, device=device)
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        for _ in range(3):
            x.add_(1.0)
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(PROBE_KERNELS):
            x.add_(1.0)
    units, settled = [], False
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < max_s:
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        n, t = 0, time.perf_counter()
        while time.perf_counter() - t < SETTLE_BLOCK_S:
            graph.replay()
            n += 1
        b.record()
        b.synchronize()
        units.append(a.elapsed_time(b) / n)
        last = units[-SETTLE_BLOCKS:]
        if len(last) < SETTLE_BLOCKS:
            continue
        med = statistics.median(last)
        if max(last) - min(last) > SETTLE_AGREE * med:
            continue
        limit = (SETTLED_BELOW_MS if level is None
                 else (1.0 + SETTLE_BACK) * level)
        if med <= limit:
            settled = True
            break
    del graph
    return {"seconds": time.perf_counter() - t0, "settled": settled,
            "blocks_ms": units,
            "level_ms": statistics.median(units[-SETTLE_BLOCKS:])}


def must_settle(settle: dict) -> dict:
    if not settle["settled"]:
        raise RuntimeError(f"the card did not settle in {SETTLE_MAX_S} s")
    return settle


def window(prog: Program, seconds: float, checked: list[int]):
    """The measured window: frames one after another for ``seconds``. The
    states around and the images of the sampled window frames ``checked``
    (0 is the window's first) are kept, and the state after (and image of)
    each frame of ``FOLLOW_AT`` (``FOLLOW_IMAGES``), counted from the
    run's first frame. Returns the window's start and end, the per-frame
    host seconds (call to end of its synchronize), the dispatch seconds
    (call to return) and the records."""
    dev = prog.device
    i0 = prog.i
    snap_at = set(checked) | {k + 1 for k in checked}
    follow = {i - i0 for i in FOLLOW_AT if i >= i0}
    follow_img = {i - i0 for i in FOLLOW_IMAGES if i >= i0}
    states, images, posts, host, disp = {}, {}, {}, [], []
    sync(dev)
    t_start = time.perf_counter()
    n = 0
    while time.perf_counter() - t_start < seconds:
        if n in snap_at:
            states[n] = prog.state()
        a = time.perf_counter()
        img = prog.frame()
        b = time.perf_counter()
        sync(dev)
        c = time.perf_counter()
        host.append(c - a)
        disp.append(b - a)
        if n in checked or n in follow_img:
            images[n] = img
        if n in follow:
            posts[n] = prog.state()
        n += 1
    t_end = time.perf_counter()
    if n in snap_at:
        states[n] = prog.state()
    recs = [check.Checked(i0 + k, states[k], states[k + 1], images.get(k))
            for k in checked if k + 1 <= n]
    recs += [check.Checked(i0 + k, None, post, images.get(k))
             for k, post in sorted(posts.items())]
    return t_start, t_end, host, disp, recs


def device_block(device, chips: int) -> dict:
    dev = torch.device(device)
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
            "count": chips,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(dev))}


def run(cell_name: str, seed: int, seconds: float, trace: bool, t_proc: float,
        device="cuda", overrides=None, bench=None, program_cls=Program,
        control=False):
    """One run; returns the result record (the contract's last line) and
    the lines of compared numbers. ``control`` (``control.py``, never the
    benchmark's runs) adds the control's readings to the record under
    ``"control"``."""
    bench = bench or manifest.load()
    cell = manifest.cell(bench, cell_name)
    cfg = manifest.config(bench, cell["config"])
    traffic = Traffic(manifest.traffic(cell["traffic"]), seed)
    log(f"cell {cell_name}, seed {seed}, {seconds} s, trace {int(trace)}, "
        f"device {device}")
    t_build = time.perf_counter()
    prog = program_cls(cfg, traffic, seed, device, overrides)
    eng = prog.eng
    t_built = time.perf_counter()
    program_scene = prog.state()["world"]
    shadows = eng.shadow_state is not None and traffic.renders
    cycle = (eng.config.shadow_update_interval * eng.config.shadow_slots
             if shadows else 1)
    start, frame_s = warm_up(prog, cycle + 2)
    programs = eng.captured_programs
    est = max(int(seconds / frame_s), 3)
    checked = sample_frames(seed, est)
    prog.prepare(2 * est + 64)
    t_warm = time.perf_counter()
    settle = {"seconds": 0.0, "settled": None}
    if torch.device(device).type == "cuda":
        settle = settle_card(device)
        log(f"the card {'settled' if settle['settled'] else 'did NOT settle'}"
            f" in {settle['seconds']:.3f} s; probe graph "
            f"ms a replay by block: "
            f"{[round(u, 4) for u in settle['blocks_ms']]}")
        must_settle(settle)
    log(f"set-up: {t_build - t_proc:.3f} s to the build, build "
        f"{t_built - t_build:.3f} s, warm-up {t_warm - t_built:.3f} s, "
        f"settling {time.perf_counter() - t_warm:.3f} s")
    log(f"warm-up {prog.i} frames, {len(programs)} programs, "
        f"{frame_s * 1e3:.3f} ms a settled frame; checking window frames "
        f"{checked} of about {est}")
    t_start, t_end, host, disp, recs = window(prog, seconds, checked)
    n = len(host)
    dev_block = device_block(device, cell["chips"])
    dev_block.update(settle_s=settle["seconds"], settled=settle["settled"])
    if eng.captured_programs != programs:
        raise RuntimeError(f"the window captured programs: "
                           f"{sorted(map(str, eng.captured_programs - programs))}")
    e2e = {"frame_ms": (t_end - t_start) / n * 1e3,
           "frame_ms_p95": p95(host) * 1e3 if n >= 2 else host[0] * 1e3,
           "setup_s": t_start - t_proc - settle["seconds"]}
    log(f"window: {n} frames in {t_end - t_start:.4f} s; frame_ms "
        f"{e2e['frame_ms']:.4f}, p95 {e2e['frame_ms_p95']:.4f}, setup_s "
        f"{e2e['setup_s']:.3f}; frame quantiles (ms) "
        f"{[round(q * 1e3, 4) for q in np.quantile(host, [0, .05, .25, .5, .75, .95, 1])]}")
    wanted = manifest.cell_metrics(bench, cell_name, trace)
    metrics, extra = {}, {}
    if trace:
        from port_bench import tracing

        on_card = torch.device(device).type == "cuda"
        rec = tracing.measure(
            prog, disp, device,
            (lambda: settle_card(device, settle["level_ms"],
                                 RESETTLE_MAX_S))
            if on_card else None)
        for m in wanted:
            v = manifest.metric_reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        dev_block.update(rec["device"])
        extra["breakdown"] = rec["breakdown"]
    else:
        for m in wanted:
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    records = start + recs
    sampled = sum(1 for r in recs if r.pre is not None)
    if sampled < len(checked):
        log(f"only {sampled} of {len(checked)} sampled frames ran")
    # the program's state goes before the reference runs
    del prog, eng
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    ctl = manifest.reference(cfg).Control if control else None
    t_ref = time.perf_counter()
    rd, per_frame, rd_ctl = check.run_reference(
        cfg, seed, device, traffic, program_scene, records, overrides, ctl)
    log(f"reference: {len(per_frame)} frames checked (the run from the "
        f"start to frame {max([r.i for r in records if r.pre is None])}) in "
        f"{time.perf_counter() - t_ref:.3f} s")
    limits = cfg["limits"]
    ok, rows = check.judge(rd.values, limits)
    failed = sum(1 for _, vals in per_frame
                 if any(v > limits.get(k, -math.inf) for k, v in vals.items()))
    if sampled < len(checked) or not recs:
        ok = False
    result = {"correct": bool(ok), "attempted": n, "failed": failed,
              "metrics": metrics, "device": dev_block, **extra,
              # the tensor or frame that set each compared number
              "checked_where": rd.where}
    if rd_ctl is not None:
        result["control"] = rd_ctl.values
        result["control_where"] = rd_ctl.where
    # the compared numbers beside their limits come last
    result["checks"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    return result, rows


def main(argv=None, t_proc=None):
    import argparse

    t_proc = time.perf_counter() if t_proc is None else t_proc
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = manifest.load()
    chips = manifest.cell(bench, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result, rows = run(args.workload, args.seed, args.seconds,
                       bool(args.trace), t_proc, bench=bench)
    found = forbidden_modules()
    if found:
        log(f"loaded in this process: {found}; the benchmark may not load "
            f"JAX or the JAX package")
        return 3
    for name, value, limit in rows:
        print(f"check {name}: {value!r} (limit {limit!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
