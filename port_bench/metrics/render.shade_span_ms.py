"""Device ms of the ``render.shade`` span (K3 and the PCF factor tiles on
the fused route; the atlas, the shadow factor and ``lighting.shade`` on
the default route), the median over the span phase's calls
(``spans.py``)."""

import statistics


def read(rec):
    s = rec.get("spans")
    ms = [x["ms"] for f in (s or {}).get("frames", [])
          for x in f.get("spans", []) if x["name"] == "render.shade"]
    return statistics.median(ms) if ms else None
