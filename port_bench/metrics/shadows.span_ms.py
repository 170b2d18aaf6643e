"""Device ms of the ``shadows`` span on the frames that update a shadow
map (those whose ``shadows`` span holds ``shadows.raster``), the median
over the span phase's calls (``spans.py``)."""

import statistics


def read(rec):
    s = rec.get("spans")
    ms = []
    for f in (s or {}).get("frames", []):
        sp = f.get("spans", [])
        for i, x in enumerate(sp):
            if x["name"] == "shadows" and any(
                    y["parent"] == i and y["name"] == "shadows.raster"
                    for y in sp):
                ms.append(x["ms"])
    return statistics.median(ms) if ms else None
