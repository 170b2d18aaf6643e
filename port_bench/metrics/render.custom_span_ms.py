"""Device ms of the ``render.custom`` span (the shading functions of the
render systems: K2 over every tile of both layers, the G-buffer from its
channels, the atlas and normal maps, the user's function on its system's
pixels), the median over the span phase's calls (``spans.py``). A program
with no shading system, or one whose engine has no such span, gives
None."""

import statistics


def read(rec):
    s = rec.get("spans")
    ms = [x["ms"] for f in (s or {}).get("frames", [])
          for x in f.get("spans", []) if x["name"] == "render.custom"]
    return statistics.median(ms) if ms else None
