#!/usr/bin/env python3
"""The engine's own spans in one benchmark cell, on one NVIDIA GPU.

    python3 scripts/measure_spans_torch.py --workload <cell> --seed <n> [--out F]

Builds the cell's engine as ``port_bench/run.py`` does, warms up and
settles the card, then:

* times frames with tracing off and on in alternating turns
  (``COST_TURNS``, ``COST_FRAMES`` frames a turn, the card settled again
  before each): the tracing's cost;
* runs ``port_bench/spans.py``'s span phase and reads the six span
  metrics from it with the benchmark's readers;
* checks that the spans account for the frame: the mean of previous tail
  to tail against the mean host-clock frame time, and ``step`` +
  ``shadows`` + ``render`` + ``store`` against the ``frame`` span;
* times ``STEP_BLOCKS`` blocks of ``STEP_CALLS`` ``Engine.step`` calls by
  CUDA events around them (the benchmark's ``step.ms`` loop) against the
  ``step`` span of the same calls, with tracing on.

Prints one JSON line last, with the card's name and power limit; ``--out``
also writes the phase's calls as JSON lines.
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

from port_bench import bench, manifest, spans, tracing  # noqa: E402
from port_bench.traffic import Traffic  # noqa: E402

COST_TURNS = ("off", "on", "on", "off", "off", "on", "on", "off")
COST_FRAMES = 300
STEP_CALLS = 60
STEP_BLOCKS = 5


def accounting(phase: dict) -> dict:
    """Whether the spans account for the frame: the mean of previous tail
    to tail against the mean host-clock frame time, and the mean of the
    ``frame`` span's children against the mean ``frame`` span, where the
    frame program ran."""
    calls = phase["frames"]
    cycles = [f["cycle_ms"] for f in calls if f.get("cycle_ms") is not None]
    host_ms = statistics.mean(phase["host_s"]) * 1e3
    out = {"mean_cycle_ms": statistics.mean(cycles) if cycles else None,
           "mean_host_ms": host_ms, "cycles": len(cycles)}
    if cycles:
        out["cycle_over_host"] = out["mean_cycle_ms"] / host_ms
    parts, whole = [], []
    for f in calls:
        top = [s for s in f.get("spans", []) if s["name"] == "frame"]
        if not top:
            continue
        parts.append(sum(s["ms"] for s in f["spans"] if s["parent"] == 0))
        whole.append(top[0]["ms"])
    if whole:
        out["mean_frame_span_ms"] = statistics.mean(whole)
        out["parts_over_frame"] = statistics.mean(parts) / out[
            "mean_frame_span_ms"]
    return out


def span_medians(phase: dict) -> dict:
    """``[median ms, median self ms, calls]`` of each device span over the
    calls that ran it, by ``kind:name``."""
    acc: dict = {}
    for f in phase["frames"]:
        for s in f.get("spans", []):
            acc.setdefault(f"{s['kind']}:{s['name']}", []).append(
                (s["ms"], s["self_ms"]))
    return {k: [statistics.median(v[0] for v in vals),
                statistics.median(v[1] for v in vals), len(vals)]
            for k, vals in sorted(acc.items())}


def idle_by_host_span(phase: dict) -> dict:
    """The idle between calls summed by the host span that covered it, per
    call."""
    acc: dict = {}
    for f in phase["frames"]:
        for name, ms in f.get("idle", []):
            acc[name] = acc.get(name, 0.0) + ms
    n = len(phase["frames"])
    return {k: v / n for k, v in sorted(acc.items(), key=lambda kv: -kv[1])}


def step_check(eng, inputs, dt, device) -> dict:
    """The ``step`` span of the ``("step",)`` graph against CUDA events
    around its replays, with tracing on. The calls of a block queue behind
    one another, so only each block's last calls are read back (the others
    are ``unread``). Returns the outside ms a call (median over the
    blocks), the medians of the read calls' ``step`` span and of their
    first mark to tail (``step`` and ``store``), and their ratios."""
    eng.set_tracing(True)
    try:
        for _ in range(3):  # the captures
            eng.step(inputs, dt)
        bench.sync(device)
        first = eng.trace_report()["counters"]["frames"]
        outside = [tracing._timed(device, STEP_CALLS,
                                  lambda: eng.step(inputs, dt)) / STEP_CALLS
                   for _ in range(STEP_BLOCKS)]
        calls = [f for f in eng.trace_report()["frames"]
                 if f["index"] >= first and f.get("spans")]
    finally:
        eng.set_tracing(False)
    step = [s["ms"] for f in calls for s in f["spans"] if s["name"] == "step"]
    out = {"read": len(calls), "outside_ms": statistics.median(outside),
           "step_span_ms": statistics.median(step),
           "first_to_tail_ms": statistics.median(f["busy_ms"]
                                                 for f in calls)}
    out["step_over_outside"] = out["step_span_ms"] / out["outside_ms"]
    out["graph_over_outside"] = out["first_to_tail_ms"] / out["outside_ms"]
    return out


def tracing_cost(prog, settle) -> dict:
    """Frame ms with tracing off and on in alternating turns: each turn's
    time over its frames."""
    eng = prog.eng
    turns: dict = {"off": [], "on": []}
    for which in COST_TURNS:
        eng.set_tracing(which == "on")
        spans.quiet(prog, spans.cycle(prog) + 2)
        settle()
        t = time.perf_counter()
        spans.frames(prog, COST_FRAMES)
        turns[which].append((time.perf_counter() - t) / COST_FRAMES * 1e3)
    eng.set_tracing(False)
    med = {k: statistics.median(v) for k, v in turns.items()}
    return {"turns_ms": turns, "median_ms": med,
            "cost": med["on"] / med["off"] - 1.0}


def measure(prog, settle) -> dict:
    """The measurement (module docstring) of a warmed-up, settled program
    as a dict; ``settle()`` settles the card again."""
    from render_engine_tpu_torch.logic.types import InputState

    out: dict = {"tracing_cost": tracing_cost(prog, settle)}
    phase = spans.program_spans(prog, spans.SPAN_FRAMES, settle)
    out["metrics"] = {m: manifest.metric_reader(m)({"spans": phase})
                      for m in spans.SPAN_METRICS}
    out["accounting"] = accounting(phase)
    out["counters"] = phase["counters"]
    out["span_medians_ms"] = span_medians(phase)
    out["idle_by_host_span_ms"] = idle_by_host_span(phase)
    traffic = prog.traffic
    fr = traffic.frame(prog.i)
    inputs = InputState(keys=fr.keys, mouse_delta=fr.mouse_delta,
                        rng_seed=fr.rng_seed).with_prev(
                            traffic.prev_keys(prog.i))
    settle()
    out["step_check"] = step_check(prog.eng, inputs, fr.dt, prog.device)
    out["spans"] = phase
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    device = "cuda"
    b = manifest.load()
    cell = manifest.cell(b, args.workload)
    cfg = manifest.config(b, cell["config"])
    traffic = Traffic(manifest.traffic(cell["traffic"]), args.seed)
    prog = bench.Program(cfg, traffic, args.seed, device)
    bench.warm_up(prog, spans.cycle(prog) + 2)
    level = bench.must_settle(bench.settle_card(device))["level_ms"]

    def settle():
        return bench.settle_card(device, level, bench.RESETTLE_MAX_S)

    out = {"workload": args.workload, "seed": args.seed,
           **measure(prog, settle)}
    phase = out.pop("spans")
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    if args.out:
        with open(args.out, "w") as fh:
            for f in phase["frames"]:
                fh.write(json.dumps(f) + "\n")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
