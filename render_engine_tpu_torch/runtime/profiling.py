"""Spans inside the Engine's captured programs and around its calls, and
the measuring tools the benchmarks share.

Port of ``render_engine_tpu/runtime/profiling.py``'s ``trace()``: a
``torch.profiler`` wrapper for deep dives (writes a Chrome trace under
``log_dir``). The JAX package's ``StageTimer`` (host clocks around stages,
a synchronize after each) has no counterpart: a frame here is one captured
graph, so the stages are timed inside it.

Spans (``Engine.set_tracing``). The program functions call ``mark(name)``
at their boundaries, ``end()`` after their last one and ``count(name,
value)`` on counters they compute anyway. All three return at once unless
a program is being recorded: the Engine arms a ``ProgramMarks``
(``recording``) while it captures a program with tracing on, and on the
CPU while it runs one. On a card each mark is then a timing event recorded
on the capture stream (``torch.cuda.Event(enable_timing=True,
external=True)``), an event-record node of the graph, so every replay
times its marks on the device; on the CPU it is ``time.perf_counter_ns()``.
A mark opens the span ``name`` and ends every open span that is not an
ancestor of it by its dotted name (``render.shade`` lies inside
``render``), so a span ends where the next one of its level starts and a
boundary costs one event; ``end()`` ends them all.

``FrameTracer`` holds what the Engine's calls record with tracing on: host
spans (``time.perf_counter_ns()``; ``torch.profiler.record_function`` rows
too while a profiler runs); an anchor event on the stream where the call's
input copy starts and a tail event after its last work, outside the
graphs; and each replayed program's marks. A call is read back once its
tail has completed (``poll``, at the end of the next call, while the
device runs that one: no synchronize) into a ring of the last ``RING``
calls; a call whose program is replayed again before that (its events
would be overwritten) is counted ``unread``. On a card the Engine captures
each traced program twice and replays the two in turn, so the next call's
replay leaves the last call's events alone. On one device clock a call then reads: the previous tail to
the anchor, the device idle while the host was between calls; the anchor
to the first mark, the input copy and the graph's start; the marks, the
layers; the last mark to the tail, the image clone. ``CallRing`` keeps the
host start and end of the last ``RING`` frames whether tracing is on or
not (``Engine.fps_stats``).

And what the benchmarks share: ``require_device`` / ``device_info`` (a
measurement names the card it ran on, and fails where there is none),
``device_activity`` (a trace's device rows: their sum, the time the device
was busy and their span), ``timed`` and ``turn_medians`` (two variants
compared in alternating turns inside one process, because the host clock
drifts between runs) and ``graph_pool_bytes`` (the memory of a set of
captured programs).
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import statistics
import subprocess
import time

import numpy as np
import torch

RING = 4096  # calls (frames) the rings hold
OUTSIDE = "outside the engine"  # host time no engine span covers

# the ProgramMarks being recorded; None: marks return at once
_ARMED = None


def armed() -> bool:
    """Whether a program is being recorded (a mark or count is kept)."""
    return _ARMED is not None


def mark(name: str):
    """A boundary inside a program: the span ``name`` starts here."""
    if _ARMED is None:
        return
    _ARMED.add(name)


def end():
    """A program's last boundary: every span still open ends here."""
    if _ARMED is None:
        return
    _ARMED.add(None)


def count(name: str, value: torch.Tensor, over: int = 0):
    """A counter the program computes anyway, a 0-dim integer tensor the
    recording keeps (on a card the graph writes it on every replay): it
    reads as ``max(value - over, 0)``, summed over the program's counts of
    the same ``name``."""
    if _ARMED is None:
        return
    _ARMED.counts.append((name, value, over))


class HostStamp:
    """The host clock in the place of a CUDA timing event (the CPU)."""

    __slots__ = ("ns",)

    def __init__(self):
        self.ns = 0

    def record(self):
        self.ns = time.perf_counter_ns()

    def query(self) -> bool:
        return True

    def elapsed_time(self, other: "HostStamp") -> float:
        return (other.ns - self.ns) / 1e6


def span_tree(names: list, root: str | None = None) -> list[tuple]:
    """The spans a program's marks open (``names``, None for ``end()``):
    ``(name, parent, first, last)``, the parent's index in the list (None
    at the top) and the indices of the span's first mark and of the mark
    that ends it, in the order the spans open. ``root`` adds a span from
    the first mark to the last, the parent of the top level."""
    spans: list = []
    open_: list = []
    top = None
    if root is not None and names:
        spans.append([root, None, 0, len(names) - 1])
        top = 0
    for i, name in enumerate(names):
        while open_ and (name is None or not name.startswith(
                spans[open_[-1]][0] + ".")):
            spans[open_.pop()][3] = i
        if name is not None:
            spans.append([name, open_[-1] if open_ else top, i, None])
            open_.append(len(spans) - 1)
    if open_:
        raise ValueError(f"spans not ended: {[spans[j][0] for j in open_]}")
    return [tuple(s) for s in spans]


def with_self_times(spans: list[dict]) -> list[dict]:
    """Adds ``self_ms`` to each span dict (``ms`` and ``parent``, an index
    into ``spans``): its time less the part its children cover."""
    for s in spans:
        s["self_ms"] = s["ms"]
    for s in spans:
        if s["parent"] is not None:
            spans[s["parent"]]["self_ms"] -= s["ms"]
    return spans


class ProgramMarks:
    """The marks and counters of one program (``mark``, ``end``,
    ``count``). ``root`` names a span over all its marks (the frame
    program's ``frame``). On a card they are recorded once, into the
    captured graph, whose replays record the same events again; on the
    CPU every run records new stamps."""

    def __init__(self, cuda: bool, root: str | None = None):
        self.cuda, self.root = cuda, root
        self.names: list = []
        self.stamps: list = []
        self.counts: list = []
        self.spans: list = []

    def add(self, name):
        if self.cuda:
            stamp = torch.cuda.Event(enable_timing=True, external=True)
        else:
            stamp = HostStamp()
        stamp.record()
        self.names.append(name)
        self.stamps.append(stamp)

    @contextlib.contextmanager
    def recording(self):
        """Marks and counts inside the block are this program's."""
        global _ARMED
        self.names, self.stamps, self.counts = [], [], []
        before, _ARMED = _ARMED, self
        try:
            yield self
        finally:
            _ARMED = before
        self.spans = span_tree(self.names, self.root)

    def counters(self) -> dict:
        """The counters as the program's last run left them."""
        if not self.counts:
            return {}
        vals = torch.stack([v.to(torch.int64).reshape(())
                            for _, v, _ in self.counts]).tolist()
        out: dict = {}
        for (name, _, over), v in zip(self.counts, vals):
            out[name] = out.get(name, 0) + max(v - over, 0)
        return out


def recording(marks: ProgramMarks | None):
    """``marks.recording()``, or nothing for None."""
    return contextlib.nullcontext() if marks is None else marks.recording()


class CallRing:
    """The host start and end (``time.perf_counter_ns()``) of the last
    ``size`` calls; ``n`` counts every call."""

    def __init__(self, size: int = RING):
        self.t = np.zeros((size, 2), np.int64)
        self.n = 0

    def add(self, t0: int, t1: int):
        self.t[self.n % len(self.t)] = (t0, t1)
        self.n += 1

    def times(self) -> np.ndarray:
        """(k, 2) start and end of the calls held, oldest first."""
        k = min(self.n, len(self.t))
        return self.t[np.arange(self.n - k, self.n) % len(self.t)]


class _Call:
    """One Engine call being recorded, then read back; ``within`` is the
    index of the call open around it (None at the top)."""

    __slots__ = ("kind", "index", "within", "host", "stack", "profiled",
                 "programs", "anchor", "anchor_ns", "tail", "device")

    def __init__(self, kind: str, index: int, within: int | None = None):
        self.kind, self.index, self.within = kind, index, within
        self.host: list = []  # [name, parent, start ns, end ns, tag]
        self.stack: list = []
        self.profiled: list = []  # record_function rows open
        self.programs: list = []  # (key, marks, spans, stamps)
        self.anchor = self.tail = self.device = None
        self.anchor_ns = None


def idle_by_span(lo: int, hi: int, spans) -> list:
    """``[name, ms]`` of the host time ``[lo, hi)`` (ns), each instant put
    down to the innermost (shortest) of ``spans`` (``(name, start, end)``
    in ns) covering it, ``OUTSIDE`` where none does."""
    cuts = sorted({lo, hi} | {t for _, s, e in spans for t in (s, e)
                              if lo < t < hi})
    acc: dict = {}
    for a, b in zip(cuts, cuts[1:]):
        mid = (a + b) / 2
        inner = [(e - s, name) for name, s, e in spans if s <= mid < e]
        name = min(inner)[1] if inner else OUTSIDE
        acc[name] = acc.get(name, 0) + (b - a)
    return [[k, v / 1e6] for k, v in acc.items()]


class FrameTracer:
    """What the Engine's calls record with tracing on (see the module
    docstring): ``open`` a call, ``host`` spans inside it, ``anchor``,
    ``replayed`` programs, ``close``; ``poll`` reads completed calls into
    the ring. A call opened while another is open (the Engine's calls
    inside a ``Player.step``, ``runtime/replay.py``) is a call of its own
    that names the outer one (``within``); ``tally`` counts what such a
    caller does (``tallies``, in ``Engine.trace_report``'s counters)."""

    def __init__(self, device, size: int = RING):
        self.cuda = torch.device(device).type == "cuda"
        self.ring: list = [None] * size
        self.calls = 0
        self.unread = 0
        self.feed_waits = 0
        self.tallies: dict = {}
        self._pending: collections.deque = collections.deque()
        self._call: _Call | None = None
        self._outer: list = []  # the calls open around ``_call``
        self.last: _Call | None = None  # the last call that ran a program
        self._last_tail = None  # (index, event) of the last call read
        self._free: list = []  # timing events to reuse

    def _stamp(self):
        if not self.cuda:
            return HostStamp()
        if self._free:
            return self._free.pop()
        return torch.cuda.Event(enable_timing=True)

    # -- recording ---------------------------------------------------------
    @contextlib.contextmanager
    def call(self, kind: str, t0: int | None = None):
        """The block is one call (``open``, ``close``); yields the
        tracer."""
        self.open(kind, time.perf_counter_ns() if t0 is None else t0)
        try:
            yield self
        finally:
            self.close()

    def open(self, kind: str, t0: int):
        """A call starting at host time ``t0`` (ns): its host span
        ``kind``; inside an open call, a call within it."""
        outer = self._call
        if outer is not None:
            self._outer.append(outer)
        self._call = _Call(kind, self.calls,
                           None if outer is None else outer.index)
        self.calls += 1
        self._enter(kind, None, t0)

    def _enter(self, name: str, tag=None, t0: int | None = None):
        c = self._call
        rf = None
        if torch.autograd._profiler_enabled():
            rf = torch.profiler.record_function(
                name if tag is None else f"{name} {tag}")
            rf.__enter__()
        c.profiled.append(rf)
        c.stack.append(len(c.host))
        c.host.append([name, c.stack[-2] if len(c.stack) > 1 else None,
                       time.perf_counter_ns() if t0 is None else t0, None,
                       tag])

    def _exit(self):
        c = self._call
        c.host[c.stack.pop()][3] = time.perf_counter_ns()
        rf = c.profiled.pop()
        if rf is not None:
            rf.__exit__(None, None, None)

    @contextlib.contextmanager
    def host(self, name: str, tag=None):
        """A host span of the open call."""
        self._enter(name, tag)
        try:
            yield
        finally:
            self._exit()

    def anchor(self):
        """The call's anchor: a timing event on the current stream, at this
        host time (once a call)."""
        c = self._call
        if c.anchor is None:
            c.anchor = self._stamp()
            c.anchor_ns = time.perf_counter_ns()
            c.anchor.record()

    def before_replay(self, marks: ProgramMarks):
        """Calls not yet completed that replayed ``marks``' program are
        counted unread: the replay about to run records its events
        again."""
        if not any(p[3] is marks.stamps for c in self._pending
                   for p in c.programs):
            return
        self.poll()
        keep = collections.deque()
        for c in self._pending:
            if any(p[3] is marks.stamps for p in c.programs):
                self.unread += 1
                if self.cuda:
                    self._free += [c.anchor, c.tail]
                self._store(c)
            else:
                keep.append(c)
        self._pending = keep

    def replayed(self, key, marks: ProgramMarks):
        self.anchor()
        self._call.programs.append((key, marks, marks.spans, marks.stamps))

    def close(self):
        """The call ends: its tail event; the calls completed by now are
        read (inside the span ``engine.trace``: on a card the device is
        still running this call); then its host span ends."""
        c = self._call
        if c.anchor is not None:
            c.tail = self._stamp()
            c.tail.record()
            self._pending.append(c)
        self._enter("engine.trace")
        self.poll()
        self._exit()
        self._exit()
        self._call = self._outer.pop() if self._outer else None
        if c.programs:
            self.last = c
        if c.anchor is None:
            self._store(c)

    def tally(self, name: str, n: int = 1):
        """Adds ``n`` to the counter ``name``."""
        self.tallies[name] = self.tallies.get(name, 0) + n

    # -- reading back ------------------------------------------------------
    def poll(self):
        """Read the pending calls whose tail has completed, oldest first."""
        while self._pending and self._pending[0].tail.query():
            self._read(self._pending.popleft())

    def _read(self, c: _Call):
        a = c.anchor
        times = [[a.elapsed_time(s) for s in stamps]
                 for _, _, _, stamps in c.programs]
        tail_ms = a.elapsed_time(c.tail)
        gap = None
        if self._last_tail is not None:
            index, ev = self._last_tail
            if index == c.index - 1:
                gap = ev.elapsed_time(a)
            if self.cuda:
                self._free.append(ev)
        self._last_tail = (c.index, c.tail)
        if self.cuda:
            self._free.append(a)
        c.device = (times, tail_ms, gap)
        c.anchor = c.tail = None
        self._store(c)

    def _store(self, c: _Call):
        self.ring[c.index % len(self.ring)] = c

    def calls_held(self) -> list[_Call]:
        """The calls in the ring, oldest first."""
        size = len(self.ring)
        out = []
        for i in range(max(0, self.calls - size), self.calls):
            c = self.ring[i % size]
            if c is not None and c.index == i:
                out.append(c)
        return out

    def frames(self) -> list[dict]:
        """Every call in the ring as a dict (``Engine.trace_report``)."""
        calls = self.calls_held()
        by_index = {c.index: c for c in calls}
        return [call_dict(c, by_index.get(c.index - 1)) for c in calls]


def call_dict(c: _Call, prev: _Call | None) -> dict:
    """One call read back: ``within`` (the index of the call open around
    it, or None), its host spans (``start_ms`` from the call's start), and
    where it was read, its device spans (``start_ms`` from the
    anchor; ``program`` the program's key as a string, ``kind`` its first
    element), ``launch_ms`` (anchor to the first mark), ``busy_ms`` (first
    mark to tail), ``gap_ms`` (the previous call's tail to the anchor;
    None where the previous call was not read), ``queued`` (the stream was
    busy when the anchor was recorded: its device times cannot be put on
    the host clock), ``cycle_ms`` (previous tail to tail), ``anchor_ms``
    (the anchor on the host clock, from the call's start) and ``idle`` (the
    gap put down to the host spans that covered it)."""
    t0 = c.host[0][2]
    d = {"index": c.index, "call": c.kind, "within": c.within,
         "programs": [str(p[0]) for p in c.programs],
         "host": with_self_times([
             {"name": name, "parent": parent, "start_ms": (s - t0) / 1e6,
              "ms": (e - s) / 1e6, "tag": None if tag is None else str(tag)}
             for name, parent, s, e, tag in c.host]),
         "unread": bool(c.programs) and c.device is None}
    if c.device is None:
        return d
    times, tail_ms, gap = c.device
    spans = []
    for (key, _, tree, _), t in zip(c.programs, times):
        base = len(spans)
        for name, parent, first, last in tree:
            spans.append({"name": name, "program": str(key),
                          "kind": key[0],
                          "parent": None if parent is None else base + parent,
                          "start_ms": t[first], "ms": t[last] - t[first]})
    marks = [x for t in times for x in t]
    launch = marks[0] if marks else None
    queued = gap is None or gap <= 0.0
    d.update(spans=with_self_times(spans), launch_ms=launch,
             busy_ms=None if launch is None else tail_ms - launch,
             tail_ms=tail_ms, gap_ms=gap, queued=queued,
             cycle_ms=None if gap is None else gap + tail_ms,
             anchor_ms=(c.anchor_ns - t0) / 1e6, idle=[])
    if not queued:
        host = [(name, s, e) for call in (prev, c) if call is not None
                for name, _, s, e, _ in call.host]
        d["idle"] = idle_by_span(c.anchor_ns - int(gap * 1e6), c.anchor_ns,
                                 host)
    return d


def export_lines(path: str, report: dict):
    """``report`` (``Engine.trace_report``) as JSON lines: the counters,
    then one line a call."""
    with open(path, "w") as fh:
        fh.write(json.dumps({"counters": report["counters"]}) + "\n")
        for f in report["frames"]:
            fh.write(json.dumps(f) + "\n")


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` around a block: host activity, and the device's
    where there is one. Yields the profiler (``key_averages()`` after the
    block) and writes ``trace.json`` (Chrome trace) under ``log_dir``."""
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def device_activity(events) -> dict:
    """The device rows of a ``torch.profiler`` trace (``prof.events()``;
    kernels, copies and memsets): how many, the sum of their durations,
    the union of their intervals (the time the device ran at least one of
    them) and the span from the first one's start to the last one's end,
    the times in ms. A sum above the union means rows overlapped."""
    rows = sorted((e.time_range.start, e.time_range.end) for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, total, lo, hi = 0.0, 0.0, None, None
    for start, end in rows:
        total += end - start
        if hi is None or start > hi:
            if hi is not None:
                busy += hi - lo
            lo, hi = start, end
        else:
            hi = max(hi, end)
    if hi is not None:
        busy += hi - lo
    return {"rows": len(rows), "sum_ms": total / 1e3, "busy_ms": busy / 1e3,
            "span_ms": (rows[-1][1] - rows[0][0]) / 1e3 if rows else 0.0}


def require_device(device) -> torch.device:
    """``device`` as a ``torch.device``; raises when it is a CUDA device
    and there is no card (a measurement never falls back to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass --device cpu (device='cpu') "
                           "to run on the CPU")
    return device


def device_info(device) -> dict:
    """``{"device": name, "power_limit_w": watts}``: the card's name and
    the power limit ``nvidia-smi`` reports for it; ``"cpu"`` and None for
    the CPU."""
    device = torch.device(device)
    if device.type != "cuda":
        return {"device": "cpu", "power_limit_w": None}
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    out = subprocess.run(
        ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    return {"device": torch.cuda.get_device_name(index),
            "power_limit_w": float(out)}


def sync(device):
    """Wait for ``device``'s queued work (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device="cuda"):
    """``fn()`` and its ms on the host clock, the device's work included."""
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, (time.perf_counter() - t0) * 1e3


def turn_medians(frame, turns, start, frames=10, device="cuda", log=print,
                 label="turns", what=""):
    """Variants compared in alternating turns: for each entry ``which`` of
    ``turns`` (e.g. a, b, b, a), ``start(which)`` switches to that variant,
    then ``frame()`` runs ``frames`` times, each timed with its device work.
    Returns ``({which: median of its turn medians}, {which: [turn
    medians]})`` in ms and logs one line a variant, ``[label] what which:
    ...``."""
    meds: dict = {}
    for which in turns:
        start(which)
        times = [timed(frame, device)[1] for _ in range(frames)]
        meds.setdefault(which, []).append(statistics.median(times))
    for which, m in meds.items():
        log(f"[{label}] {what}{which}: {frames} frames a turn, turn medians "
            f"{', '.join(f'{t:.2f}' for t in m)} ms; median "
            f"{statistics.median(m):.2f} ms/frame")
    return {k: statistics.median(v) for k, v in meds.items()}, meds


def graph_pool_bytes(pool) -> int:
    """Bytes of the caching allocator's segments in the CUDA graph pool
    ``pool`` (``torch.cuda.graph_pool_handle()``; 0 for None)."""
    if pool is None:
        return 0
    return sum(seg["total_size"]
               for seg in torch.cuda.memory._snapshot()["segments"]
               if tuple(seg.get("segment_pool_id", ())) == tuple(pool))
