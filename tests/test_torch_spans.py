"""Spans inside the Engine's programs and around its calls
(``runtime/profiling.py``, ``Engine.set_tracing``) on the CPU, where the
programs run eagerly and a mark reads ``time.perf_counter_ns()``: the same
names and nesting a card records as timing events in its graphs.

* Off (the default): nothing is recorded and the programs are those of an
  untraced engine; on: the same tensor operations in the same order (the
  marks and counters add none, so a card's traced graph is the untraced
  one plus its event nodes), the same world, image and shadow tables.
* The span trees of the frame program (a map frame and a skipped one), the
  step program and the updating render, on the fused and the default
  route; self times against a hand-built nest.
* The ring, ``unread``, the idle between calls put down to host spans,
  ``fps_stats`` from call-to-call intervals, the host spans as
  ``record_function`` rows of a profiler, the counters the graph keeps.
"""

import dataclasses
import json

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from render_engine_tpu_torch.demo.space_scene import build_space_engine
from render_engine_tpu_torch.logic.types import InputState
from render_engine_tpu_torch.runtime import engine as E
from render_engine_tpu_torch.runtime import profiling as P

from host_traffic import no_host_traffic
from torch_threads import one_torch_thread  # noqa: F401

SMALL = dict(width=128, height=32, capacity=128, num_asteroids=10,
             max_tris=2048, shadow_update_interval=3, shadow_slots=2)
DT = 1 / 60
STEP = ["step.kinematics", "step.collisions", "step.logic", "step.changes"]
FUSED = ["render.geometry", "render.raster", "render.resolve",
         "render.shade", "render.compose"]
DEFAULT = ["render.geometry", "render.raster", "render.shade",
           "render.compose"]


def engine(fused=True, **kw):
    eng = build_space_engine(device="cpu", **dict(SMALL, **kw))
    eng.config.record_history = False
    if not fused:
        eng.config.render = dataclasses.replace(eng.config.render,
                                                fused_shading=False)
        eng.finalize_scene()
    return eng


def tree(call):
    """``[(name, parent name)]`` of a call's device spans."""
    sp = call["spans"]
    return [(s["name"], None if s["parent"] is None
             else sp[s["parent"]]["name"]) for s in sp]


def expected(program, render_stages):
    """The span tree a program records (``program``: frame_skip,
    frame_slot, step, render_shadowed)."""
    step = [("step", "frame")] + [(n, "step") for n in STEP]
    shadows = [("shadows", "frame")]
    if program in ("frame_slot", "render_shadowed_slot"):
        shadows += [("shadows.geometry", "shadows"),
                    ("shadows.raster", "shadows")]
    render = [("render", "frame")] + [(n, "render") for n in render_stages]
    if program.startswith("frame"):
        return [("frame", None)] + step + shadows + render + [
            ("store", "frame")]
    top = {"frame": None}
    if program == "step":
        return [(n, top.get(p, p)) for n, p in step + [("store", None)]]
    return [(n, top.get(p, p)) for n, p in shadows + render
            + [("store", None)]]


@pytest.fixture(scope="module", params=["fused", "default"])
def traced(request):
    """A traced engine of each route through three fused frames (a map
    frame, two skipped), two step-route frames that render (the step and
    the updating render), ``step``, ``render`` and ``update_shadows``."""
    fused = request.param == "fused"
    eng = engine(fused)
    eng.set_tracing(True)
    for _ in range(3):
        eng.frame(None, DT)
    for _ in range(2):
        eng.frame(None, DT, advance="step")
    eng.step(InputState.idle(9).with_prev(eng._prev_keys), DT)
    eng.render()
    eng.update_shadows()
    return request.param, eng, eng.trace_report()


def test_off_records_nothing():
    """Tracing is off by default: the programs carry no marks, no mark is
    armed while they run, and the report is empty."""
    eng = engine()
    armed = []
    orig = P.mark
    try:
        P.mark = lambda name: armed.append(P.armed())
        for _ in range(4):
            eng.frame(None, DT)
    finally:
        P.mark = orig
    assert armed and not any(armed)
    assert eng.captured_programs == {("frame", "skip"), ("frame", "map")}
    assert all(p.marks is None and p.twin is None
               for p in eng._programs.values())
    assert eng.trace_report() == {"frames": [], "counters": {}}
    assert eng._frame_calls.n == 4


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_tracing_adds_no_tensor_operation():
    """Four frames (a map frame of each slot and a skipped one) run the
    same tensor operations in the same order traced and untraced: the
    marks and counters add no device work, and the untraced programs are
    the traced ones without their marks."""
    ops = {}
    for on in (False, True):
        eng = engine()
        eng.set_tracing(on)
        with _Ops() as log:
            for _ in range(4):
                eng.frame(None, DT)
        ops[on] = log.ops
    assert len(ops[False]) > 1000
    assert ops[True] == ops[False]


def test_traced_frames_equal_untraced():
    """Six frames traced and untraced: world, camera, image and shadow
    tables equal (``torch.equal``) after every frame."""
    a, b = engine(), engine()
    b.set_tracing(True)
    for i in range(6):
        ia, ib = a.frame(None, DT), b.frame(None, DT)
        assert torch.equal(ia, ib), i
        for name in ("alive", "comp_mask"):
            assert torch.equal(getattr(a.world, name),
                               getattr(b.world, name)), (i, name)
        for k, col in a.world.comps.items():
            assert torch.equal(col, b.world.comps[k]), (i, k)
        assert torch.equal(a.camera.serialize(), b.camera.serialize())
        for x, y in zip(a._state.shadow, b._state.shadow):
            assert torch.equal(x, y), i


def test_set_tracing_drops_and_recaptures():
    eng = engine(enable_shadows=False)
    eng.frame(None, DT)
    assert eng.captured_programs == {("frame", None)}
    eng.set_tracing(True)
    assert eng.captured_programs == frozenset()
    eng.frame(None, DT)
    assert eng._programs[("frame", None)].marks is not None
    eng.set_tracing(True)  # no change: the programs stay
    assert eng.captured_programs == {("frame", None)}
    eng.set_tracing(False)
    assert eng.captured_programs == frozenset()
    eng.frame(None, DT)
    assert eng._programs[("frame", None)].marks is None
    # the last record stays readable after tracing is off
    assert len(eng.trace_report()["frames"]) == 1


def test_span_trees(traced):
    route, _, rep = traced
    stages = FUSED if route == "fused" else DEFAULT
    calls = rep["frames"]
    assert [c["call"] for c in calls] == ["engine.frame"] * 5 + [
        "engine.step", "engine.render", "engine.update_shadows"]
    assert [c["programs"] for c in calls[:5]] == [
        ["('frame', 'map')"], ["('frame', 'skip')"], ["('frame', 'skip')"],
        ["('step',)", "('render_shadowed', 'map')"],
        ["('step',)", "('render_shadowed', 'skip')"]]
    # each device span names its program's kind, the key's first element
    assert [{s["kind"] for s in c["spans"]} for c in calls[:7]] == [
        {"frame"}, {"frame"}, {"frame"}, {"step", "render_shadowed"},
        {"step", "render_shadowed"}, {"step"}, {"render"}]
    assert tree(calls[0]) == expected("frame_slot", stages)
    assert tree(calls[1]) == expected("frame_skip", stages)
    step = expected("step", stages)
    assert tree(calls[3]) == step + expected("render_shadowed_slot",
                                             stages)
    assert tree(calls[4]) == step + expected("render_shadowed", stages)
    assert tree(calls[5]) == step
    assert tree(calls[6]) == [("render", None)] + [
        (n, "render") for n in stages] + [("store", None)]
    # the skipped update: a call that replays nothing
    assert calls[7]["programs"] == [] and "spans" not in calls[7]


def test_spans_tile_their_parents(traced):
    """Each span's children cover it exactly but for its self time; the
    frame program's top spans cover ``frame``; every span lies between the
    anchor and the tail."""
    _, _, rep = traced
    for call in rep["frames"][:7]:
        sp = call["spans"]
        for i, s in enumerate(sp):
            kids = [k for k in sp if k["parent"] == i]
            assert s["self_ms"] == pytest.approx(
                s["ms"] - sum(k["ms"] for k in kids), abs=1e-9)
            assert s["ms"] >= 0 and s["self_ms"] >= -1e-9
            assert call["launch_ms"] <= s["start_ms"] + 1e-9
            assert s["start_ms"] + s["ms"] <= call["tail_ms"] + 1e-9
        if sp[0]["name"] == "frame":
            assert sum(k["ms"] for k in sp if k["parent"] == 0) == \
                pytest.approx(sp[0]["ms"], abs=1e-9)


def test_host_spans_and_counters(traced):
    _, eng, rep = traced
    call = rep["frames"][1]
    host = [(h["name"], h["parent"]) for h in call["host"]]
    assert host == [("engine.frame", None), ("engine.record", 0),
                    ("engine.shadow_decision", 0), ("engine.feed", 0),
                    ("engine.launch", 0), ("engine.clone", 0),
                    ("engine.trace", 0)]
    assert call["host"][4]["tag"] == "('frame', 'skip')"
    assert call["host"][0]["self_ms"] == pytest.approx(
        call["host"][0]["ms"] - sum(h["ms"] for h in call["host"][1:]))
    assert call["anchor_ms"] >= call["host"][3]["start_ms"]
    c = rep["counters"]
    assert c["frames"] == 8 and c["unread"] == 0 and c["feed_waits"] == 0
    assert c["captures"] == len(eng.captured_programs)
    assert set(c["step_drops"]) == {
        "collision_cell_dropped", "collision_large_dropped",
        "collision_pair_dropped", "collision_query_dropped", "oob_killed",
        "spawn_dropped"}
    # the last call that ran a program rendered through ("render", ...)
    stats = eng.render_drop_stats()
    assert c["render_drops"] == {
        k: stats[k] for k in ("triangle_budget_dropped",
                              "tile_candidate_dropped")}
    assert c["render_drops"]["tile_candidate_dropped"] > 0


def test_drop_stats_read_from_the_graph():
    """With tracing on the two render counters come from the last frame's
    program and equal the re-run's."""
    a, b = engine(), engine()
    b.set_tracing(True)
    for _ in range(2):
        a.frame(None, DT)
        b.frame(None, DT)
    assert b._render_counters()["tile_candidate_dropped"] > 0
    assert a.drop_stats() == b.drop_stats()


def test_self_times_of_a_hand_built_nest():
    names = ["a", "a.x", "a.y", "a.y.z", "b", "c", "c.k", None]
    at = [0, 1, 3, 4, 6, 6, 8, 10]  # ms of each mark
    spans = P.span_tree(names, root="root")
    assert [(n, p) for n, p, _, _ in spans] == [
        ("root", None), ("a", 0), ("a.x", 1), ("a.y", 1), ("a.y.z", 3),
        ("b", 0), ("c", 0), ("c.k", 6)]
    d = P.with_self_times([
        {"name": n, "parent": p, "ms": at[last] - at[first]}
        for n, p, first, last in spans])
    assert [(s["ms"], s["self_ms"]) for s in d] == [
        (10, 0), (6, 1), (2, 2), (3, 1), (2, 2), (0, 0), (4, 2), (2, 2)]
    with pytest.raises(ValueError, match="not ended"):
        P.span_tree(["a", "a.b"])


def test_gap_idle_and_ring(monkeypatch):
    """Calls on a hand-set clock, 10 ms apart: the anchor 2 ms into each,
    its marks at 5 and 8, the tail at 9. A call's gap runs from the last
    tail (1 ms before the call) to its anchor, 1 ms of it outside the
    engine and 2 inside the call; a ring of 4 holds the last 4 calls."""
    now = {"ns": 0}
    monkeypatch.setattr(P, "time", type("Clock", (), {
        "perf_counter_ns": staticmethod(lambda: now["ns"])}))

    def at(ms):
        now["ns"] = int(ms * 1e6)

    tr = P.FrameTracer("cpu", size=4)
    for i in range(6):
        base = 10 * i
        marks = P.ProgramMarks(False, "frame")
        at(base + 5)
        with marks.recording():
            P.mark("a")
            at(base + 8)
            P.end()
        tr.open("engine.frame", int(base * 1e6))
        at(base + 2)
        tr.anchor()
        tr.replayed(("frame", None), marks)
        at(base + 9)
        tr.close()
    calls = tr.frames()
    assert [c["index"] for c in calls] == [2, 3, 4, 5]
    for f in calls:
        assert (f["launch_ms"], f["busy_ms"], f["tail_ms"]) == (3, 4, 7)
        assert (f["gap_ms"], f["cycle_ms"], f["queued"]) == (3, 10, False)
        assert f["spans"] == [
            {"name": "frame", "program": "('frame', None)", "kind": "frame",
             "parent": None, "start_ms": 3.0, "ms": 3.0, "self_ms": 0.0},
            {"name": "a", "program": "('frame', None)", "kind": "frame",
             "parent": 0, "start_ms": 3.0, "ms": 3.0, "self_ms": 3.0}]
        idle = dict(f["idle"])
        assert idle == pytest.approx({P.OUTSIDE: 1.0, "engine.frame": 2.0})
    assert calls[0]["gap_ms"] == 3  # its previous call left the ring


def test_unread_calls(monkeypatch):
    """A call whose program runs again before its tail completed is
    counted unread; the others are read once done."""
    done = {"now": False}
    monkeypatch.setattr(P.HostStamp, "query", lambda self: done["now"])
    tr = P.FrameTracer("cpu")
    a, b = P.ProgramMarks(False), P.ProgramMarks(False)
    for m in (a, b):
        with m.recording():
            P.mark("x")
            P.end()
    for marks in (a, b, a):
        tr.open("engine.frame", 0)
        tr.before_replay(marks)
        tr.replayed(("p",), marks)
        tr.close()
    assert tr.unread == 1  # the first call: its program ran again
    assert [c.index for c in tr._pending] == [1, 2]
    done["now"] = True
    tr.poll()
    calls = tr.frames()
    assert [c["unread"] for c in calls] == [True, False, False]
    assert "spans" not in calls[0] and calls[2]["spans"][0]["name"] == "x"


def test_fps_stats_from_call_intervals(monkeypatch):
    """``fps`` is the inverse of the mean interval between frame calls
    (the first, which holds the captures, left out), ``dispatch_ms`` the
    mean time a call took."""
    eng = engine(enable_shadows=False)
    starts = [0.0, 10.0, 30.0, 60.0, 100.0]
    ticks = iter(int(t * 1e6) for s in starts for t in (s, s + 2.5))
    monkeypatch.setattr(E, "time", type("Clock", (), {
        "perf_counter_ns": staticmethod(lambda: next(ticks)),
        "perf_counter": staticmethod(lambda: 0.0)}))
    for _ in starts:
        eng.frame(None, DT)
    s = eng.fps_stats()
    assert s["frames"] == 5
    assert s["dispatch_ms"] == pytest.approx(2.5)
    assert s["mean_ms"] == pytest.approx(30.0)  # (20 + 30 + 40) / 3
    assert s["p50_ms"] == pytest.approx(30.0)
    assert s["fps"] == pytest.approx(1000.0 / 30.0)
    assert "tile_candidate_dropped" in s["drops"]
    eng.reset()
    assert eng.fps_stats() == {}


def test_host_spans_are_profiler_rows():
    """Under a CPU ``torch.profiler`` each host span is also a
    ``record_function`` row, at the same times: in the spans' order,
    inside the ``engine.frame`` row, each row holding its span (a row
    opens just before its span's clock is read and closes just after;
    under load the profiler's own work can lengthen a row by
    milliseconds), starting where the span starts."""
    eng = engine(enable_shadows=False)
    eng.frame(None, DT)
    eng.set_tracing(True)
    eng.frame(None, DT)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        eng.frame(None, DT)
    call = eng.trace_report()["frames"][-1]
    rows = {}
    for e in prof.events():
        rows.setdefault(e.name, e)
    names = [h["name"] if h["tag"] is None else f"{h['name']} {h['tag']}"
             for h in call["host"]]
    assert set(names) <= set(rows)
    frame = rows["engine.frame"].time_range
    starts = [rows[n].time_range.start for n in names]
    assert starts == sorted(starts)
    for h, name in zip(call["host"], names):
        r = rows[name].time_range
        assert frame.start <= r.start and r.end <= frame.end, name
        # the call's span starts before its row opens (its clock is read
        # as the call starts)
        slack = 0.5 if h["parent"] is None else 1e-3
        assert (r.end - r.start) / 1e3 >= h["ms"] - slack, name
        assert (r.start - frame.start) / 1e3 == pytest.approx(
            h["start_ms"], abs=1.0), name


def test_traced_frames_read_nothing_back():
    """A traced frame's programs read no tensor on the host and upload
    nothing (a card's capture forbids both)."""
    eng = engine()
    eng.set_tracing(True)
    for _ in range(3):
        eng.frame(None, DT)
    with no_host_traffic():
        for _ in range(3):
            eng.frame(None, DT)
    assert len(eng.trace_report()["frames"]) == 6


def test_export_spans(tmp_path):
    eng = engine(enable_shadows=False)
    eng.set_tracing(True)
    for _ in range(2):
        eng.frame(None, DT)
    path = tmp_path / "spans.jsonl"
    rep = eng.export_spans(str(path))
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert lines[0] == {"counters": rep["counters"]}
    assert lines[1:] == json.loads(json.dumps(rep["frames"]))
    assert [x["index"] for x in lines[1:]] == [0, 1]
