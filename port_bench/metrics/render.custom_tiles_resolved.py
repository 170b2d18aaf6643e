"""Tiles a frame that K2 resolves for the render systems' shading
functions, both layers: the ``custom_tiles_resolved`` counter of the span
phase's last frame (``Engine.trace_report()``, kept by the frame graph).
None where the counters hold no such counter (no shading system, or an
engine that does not count it)."""


def read(rec):
    counters = (rec.get("spans") or {}).get("counters") or {}
    return counters.get("custom_tiles_resolved")
