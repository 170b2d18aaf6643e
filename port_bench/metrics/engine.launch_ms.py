"""Device ms from a call's anchor (recorded where its input copy starts)
to its first mark: the input copy and the graph's start, the median over
the span phase's calls (``spans.py``)."""

import statistics


def read(rec):
    s = rec.get("spans")
    ms = [f["launch_ms"] for f in (s or {}).get("frames", [])
          if f.get("launch_ms") is not None]
    return statistics.median(ms) if ms else None
