"""Device ms of the ``render`` span inside the frame program (step,
shadow-map update and render in one graph), the median over the span
phase's calls (``spans.py``)."""

import statistics


def read(rec):
    s = rec.get("spans")
    ms = [x["ms"] for f in (s or {}).get("frames", [])
          for x in f.get("spans", [])
          if x["name"] == "render" and x.get("kind") == "frame"]
    return statistics.median(ms) if ms else None
