"""1 minus the summed first mark to tail over the summed previous tail to
tail, over the span phase's calls (``spans.py``): the device's idle share
on its own clock, with no profiler. The anchor to the first mark (the
input copy and the graph's start) counts as idle."""


def read(rec):
    s = rec.get("spans")
    fs = [f for f in (s or {}).get("frames", [])
          if f.get("cycle_ms") is not None and f.get("busy_ms") is not None]
    cycle = sum(f["cycle_ms"] for f in fs)
    if not fs or cycle <= 0:
        return None
    return 1.0 - sum(f["busy_ms"] for f in fs) / cycle
