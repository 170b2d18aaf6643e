"""The (tile, light) pairs of a frame's per-tile light lists, which K3's
list loop walks: the ``tile_light_pairs`` counter of the span phase's last
frame (``Engine.trace_report()``, kept by the frame graph). None where the
counters hold no such counter (light lists off, or an engine that does
not count them)."""


def read(rec):
    counters = (rec.get("spans") or {}).get("counters") or {}
    return counters.get("tile_light_pairs")
