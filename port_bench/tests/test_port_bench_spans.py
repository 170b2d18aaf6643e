"""The span readers (``metrics/*.span*``, ``engine.launch_ms``,
``device.span_idle_share``) on a hand-built record, ``spans.py``'s phase
and ``scripts/measure_spans_torch.py``'s measurement on a small CPU engine
(host clocks in place of the card's events)."""

import os
import sys

import pytest
import torch

from port_bench import bench, manifest, spans
from port_bench.traffic import Traffic

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__)))), "scripts"))

import measure_spans_torch  # noqa: E402

SMALL = dict(width=128, height=96, capacity=128, num_asteroids=20,
             shadow_resolution=128, shadow_max_tris=1024)


def _span(name, program, parent, ms):
    return {"name": name, "program": program,
            "kind": program.split("'")[1], "parent": parent,
            "start_ms": 0.0, "ms": ms, "self_ms": ms}


def _frame(program, step, shadows, render, shade, launch, busy, cycle,
           mapped):
    sp = [_span("frame", program, None, step + shadows + render),
          _span("step", program, 0, step), _span("shadows", program, 0,
                                                  shadows)]
    if mapped:
        sp.append(_span("shadows.raster", program, 2, shadows))
    sp.append(_span("render", program, 0, render))
    sp.append(_span("render.shade", program, len(sp) - 1, shade))
    return {"spans": sp, "launch_ms": launch, "busy_ms": busy,
            "cycle_ms": cycle}


RECORD = {"spans": {"frames": [
    _frame("('frame', 0)", 2.0, 1.0, 4.0, 0.6, 0.1, 7.0, 7.5, True),
    _frame("('frame', 'skip')", 2.2, 0.0, 3.8, 0.7, 0.2, 6.0, 6.5, False),
    _frame("('frame', 'skip')", 2.4, 0.0, 3.6, 0.8, 0.3, 6.0, None, False),
    # a step alone: only the step span and the call's times
    {"spans": [_span("step", "('step',)", None, 2.6)], "launch_ms": 0.4,
     "busy_ms": 2.7, "cycle_ms": 3.0},
    # a call read back with no device part (unread)
    {"unread": True}]}}
WANT = {"step.span_ms": 2.3, "shadows.span_ms": 1.0, "render.span_ms": 3.8,
        "render.shade_span_ms": 0.7, "engine.launch_ms": 0.25,
        "device.span_idle_share": 1.0 - (7.0 + 6.0 + 2.7) / (7.5 + 6.5 + 3.0)}


@pytest.mark.parametrize("name", spans.SPAN_METRICS)
def test_reader_on_a_hand_built_record(name):
    read = manifest.metric_reader(name)
    assert read(RECORD) == pytest.approx(WANT[name])
    # nothing to read: a record without spans (the traced run's today),
    # an engine without tracing, a phase with no such span
    assert read({}) is None
    assert read({"spans": None}) is None
    assert read({"spans": {"frames": [{"unread": True}]}}) is None


def _small(cell):
    torch.set_num_threads(2)
    b = manifest.load()
    c = manifest.cell(b, cell)
    cfg = manifest.config(b, c["config"])
    prog = bench.Program(cfg, Traffic(manifest.traffic(c["traffic"]), 7), 7,
                         "cpu", SMALL)
    bench.warm_up(prog, spans.cycle(prog) + 2)
    return prog


@pytest.mark.parametrize("cell", ["space-1080p-10k.coast",
                                  "space-1080p-10k.step"])
def test_the_span_phase_on_the_cpu(cell):
    """``program_spans`` on a small CPU engine: every call of the phase
    read, the spans account for the host frame time (host clocks on both
    sides), the readers find what the cell runs, and tracing is off
    again afterwards."""
    prog = _small(cell)
    rec = {"spans": spans.program_spans(prog, 4)}
    got = rec["spans"]
    assert len(got["frames"]) == len(got["host_s"]) == 4
    assert got["counters"]["unread"] == 0
    assert not prog.eng._tracing
    acc = measure_spans_torch.accounting(got)
    assert acc["cycles"] == 4
    assert acc["cycle_over_host"] == pytest.approx(1.0, abs=0.03)
    values = {m: manifest.metric_reader(m)(rec) for m in spans.SPAN_METRICS}
    renders = prog.traffic.renders
    for m, v in values.items():
        if renders or m in ("step.span_ms", "engine.launch_ms",
                            "device.span_idle_share"):
            assert v is not None and v >= 0, m
        else:
            assert v is None, m
    if renders:
        assert acc["parts_over_frame"] == pytest.approx(1.0)
        med = measure_spans_torch.span_medians(got)
        assert {"frame:frame", "frame:step", "frame:render",
                "frame:store"} <= set(med)


def test_the_span_script_on_the_cpu(monkeypatch):
    """The script's measurement at a few frames a part: the tracing's
    cost in alternating turns, the span phase's metrics, and the step
    check reading the step span of every call of its blocks."""
    for name, value in (("COST_FRAMES", 2), ("STEP_CALLS", 2),
                        ("STEP_BLOCKS", 2)):
        monkeypatch.setattr(measure_spans_torch, name, value)
    monkeypatch.setattr(spans, "SPAN_FRAMES", 3)
    prog = _small("space-1080p-10k.coast")
    settles = []
    out = measure_spans_torch.measure(
        prog, lambda: settles.append(1) or {"settled": None})
    # a settle before each cost turn, the phase's and the step check's
    assert len(settles) == len(measure_spans_torch.COST_TURNS) + 2
    cost = out["tracing_cost"]
    assert [len(v) for v in cost["turns_ms"].values()] == [4, 4]
    assert set(out["metrics"]) == set(spans.SPAN_METRICS)
    assert all(v is not None for v in out["metrics"].values())
    assert len(out["spans"]["frames"]) == 3
    step = out["step_check"]
    assert step["read"] == 2 * 2  # on the CPU every call is read back
    assert step["step_span_ms"] <= step["first_to_tail_ms"] + 1e-9
    assert not prog.eng._tracing


def test_an_engine_without_tracing_gives_nothing():
    class Old:
        eng = object()

    assert spans.program_spans(Old()) is None
