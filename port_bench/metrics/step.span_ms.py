"""Device ms of the ``step`` span, in the frame program or the step
program, the median over the span phase's calls (``spans.py``)."""

import statistics


def read(rec):
    s = rec.get("spans")
    ms = [x["ms"] for f in (s or {}).get("frames", [])
          for x in f.get("spans", []) if x["name"] == "step"]
    return statistics.median(ms) if ms else None
