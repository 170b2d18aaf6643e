"""Device ms of the ``render.lights`` span (the per-tile light lists: the
packed light table and ``select_tile_lights``, ahead of K3 on the fused
route), the median over the span phase's calls (``spans.py``). None where
the span phase holds no such span (light lists off, or an engine that
does not mark them)."""

import statistics


def read(rec):
    s = rec.get("spans")
    ms = [x["ms"] for f in (s or {}).get("frames", [])
          for x in f.get("spans", []) if x["name"] == "render.lights"]
    return statistics.median(ms) if ms else None
