"""The program's own spans in a cell: a traced phase of frames after the
window, read back through ``Engine.trace_report()``.

``program_spans(prog, frames, settle)`` turns the engine's tracing on
(``Engine.set_tracing``), runs traffic frames until ``cycle + 2`` in a row
capture nothing, settles the card again, runs ``frames`` traffic frames
each followed by a synchronize (as the window runs them; one frame before
them, whose previous call lies before the settling, is left out), and
returns what the readers ``metrics/*.span*.py``,
``metrics/engine.launch_ms.py`` and ``metrics/device.span_idle_share.py``
read under a record's ``"spans"`` key: the phase's calls (``frames``,
``profiling.call_dict`` each), the counters and the phase's host-clock
frame seconds (``host_s``). Tracing is off again afterwards. An engine
without ``set_tracing`` gives None.

The traced run's record (``tracing.measure``) does not call it yet:
``tracing.py`` is one of the benchmark's files that this addition leaves
as they are. ``scripts/measure_spans_torch.py`` runs it on a cell alone."""

from __future__ import annotations

import time

from port_bench import bench

SPAN_FRAMES = 300
SPAN_METRICS = ("step.span_ms", "shadows.span_ms", "render.span_ms",
                "render.shade_span_ms", "engine.launch_ms",
                "device.span_idle_share")


def cycle(prog) -> int:
    """Frames in one turn of the shadow-map slots (1 without them)."""
    eng = prog.eng
    if prog.traffic.renders and eng.shadow_state is not None:
        return eng.config.shadow_update_interval * eng.config.shadow_slots
    return 1


def frames(prog, n: int) -> list[float]:
    """``n`` traffic frames, each followed by a synchronize: host seconds
    from the call to the end of its synchronize."""
    out = []
    for _ in range(n):
        t = time.perf_counter()
        prog.frame()
        bench.sync(prog.device)
        out.append(time.perf_counter() - t)
    return out


def quiet(prog, quiet_frames: int):
    """Traffic frames until ``quiet_frames`` in a row captured nothing.
    ``bench.warm_up`` does so from a run's first frame only: it keeps the
    first frames for the check, and its limit counts from frame 0."""
    eng, n = prog.eng, 0
    while n < quiet_frames:
        before = eng.captured_programs
        frames(prog, 1)
        n = n + 1 if eng.captured_programs == before else 0


def program_spans(prog, n: int = SPAN_FRAMES, settle=None):
    """The span phase (module docstring) of ``n`` frames; None where the
    engine has no tracing."""
    eng = prog.eng
    if not hasattr(eng, "set_tracing"):
        return None
    eng.set_tracing(True)
    try:
        quiet(prog, cycle(prog) + 2)
        settled = settle() if settle is not None else {"settled": None}
        frames(prog, 1)
        first = eng.trace_report()["counters"]["frames"]
        host = frames(prog, n)
        report = eng.trace_report()
    finally:
        eng.set_tracing(False)
    calls = [f for f in report["frames"] if f["index"] >= first]
    return {"frames": calls, "counters": report["counters"],
            "host_s": host, "resettled": settled["settled"]}
